"""
The plain reference that decides ``correct``: PyTorch and NumPy only,
float32 as the configurations state, with no kernels, caches or batching
tricks. It imports nothing of ``torchdrivesim_tpu_torch``, of the JAX
package or of JAX, and takes nothing the program made: it reads the inputs
the benchmark makes (:mod:`gpubench.world`) and works out again everything
the program derives from them (light states, meshes, screen coordinates,
coefficients).

* :mod:`.sim`: the kinematic bicycle and the light FSMs;
* :mod:`.render`: the bird's-eye view of the road mesh with z-priority
  primitives;
* :mod:`.metrics`: collision, offroad, wrong-way and red-light values;
* :mod:`.soft`: the softmax-blend soft raster of the road mesh and actors;
* :mod:`.il`: the imitation-learning rollout loss and its gradients.
"""
