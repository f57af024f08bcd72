"""
Batch sharding over the devices one process sees (counterpart of
``torchdrivesim_tpu/parallel/__init__.py``).

The workload's only parallel axis is the leading batch dimension. A
:class:`Mesh` is a list of devices along that axis (``'batch'``); a device
may appear more than once. :func:`shard_simulator` points the renderer at
the mesh, and every render that launches a kernel then cuts its batch into
one contiguous slice per mesh entry, renders slice ``i`` on
``mesh.devices[i]`` and gathers the frames on ``mesh.devices[0]``
(``rendering.renderer.Renderer.shard_mesh``).

The reference runs its step under one ``jit``, whose SPMD partitioner
carries a batch-sharded state through every op. Eager PyTorch has no such
partitioner, so here the state lives on the mesh's first device and the
step runs there; the renders, which the reference partitions by hand
(``jax.shard_map``), are what is split. :func:`batch_sharding` and
:func:`replicated_sharding` describe a placement as the reference's
``NamedSharding`` does, and :func:`leaf_sharding` applies its rule to one
tensor.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

BATCH_AXIS = 'batch'


@dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh over the batch axis."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (BATCH_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


class Sharding(NamedTuple):
    """A placement on ``mesh``: ``spec`` ``('batch',)`` splits the leading
    dimension over the mesh, ``()`` replicates (the reference's
    ``NamedSharding(mesh, P(...))``)."""
    mesh: Mesh
    spec: Tuple[str, ...]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """
    A 1-D device mesh over the batch axis: ``devices`` (entries may
    repeat), or every visible CUDA card; the first ``n_devices`` of them.

    Raises:
        RuntimeError: no ``devices`` given and no CUDA card visible.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('make_mesh: no CUDA card is visible; pass devices=')
        devices = [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError('make_mesh: no devices')
    return Mesh(devices)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Splits the leading (batch) dimension across the mesh."""
    return Sharding(mesh, (BATCH_AXIS,))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def leaf_sharding(x, mesh: Mesh) -> Sharding:
    """The reference's rule for one leaf: batch-sharded iff it has a
    leading dimension that is non-empty and a multiple of the mesh size,
    else replicated."""
    n = mesh.size
    if hasattr(x, 'ndim') and x.ndim > 0 and x.shape[0] > 0 and x.shape[0] % n == 0:
        return batch_sharding(mesh)
    return replicated_sharding(mesh)


def _map_tensors(fn, tree):
    """``tree`` with ``fn`` applied to every tensor in its tuples, lists,
    dicts and dataclasses; other leaves as they are."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map_tensors(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(_map_tensors(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def shard_batched_tree(tree, mesh: Mesh):
    """
    Place a tree of tensors on the mesh: every tensor on
    ``mesh.devices[0]``, where the step runs; the renders split the
    batch-sharded ones (:func:`leaf_sharding`) per mesh entry.
    """
    return _map_tensors(lambda x: x.to(mesh.devices[0]), tree)


def replicate_tree(tree, mesh: Mesh):
    """Replicate every tensor of a tree: on ``mesh.devices[0]``, where the
    step that reads it runs."""
    return _map_tensors(lambda x: x.to(mesh.devices[0]), tree)


def shard_simulator(sim, mesh: Mesh):
    """
    Prepare a :class:`~torchdrivesim_tpu_torch.simulator.Simulator` for
    sharded execution over ``mesh``'s batch axis: points the renderer at
    the mesh (each render that launches a kernel splits its batch over the
    mesh entries) and places the state.

    Mutates and returns ``sim``. Requires ``sim.batch_size`` to be a
    multiple of the device count.
    """
    n = mesh.size
    if sim.batch_size % n != 0:
        raise ValueError(
            f"batch size {sim.batch_size} is not divisible by the "
            f"{n}-device mesh; extend the batch or shrink the mesh")
    if hasattr(sim.renderer, 'shard_mesh'):
        sim.renderer.shard_mesh = mesh
    sim.state = shard_batched_tree(sim.state, mesh)
    return sim
