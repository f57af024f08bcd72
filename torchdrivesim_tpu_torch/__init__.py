"""
torchdrivesim_tpu_torch: the PyTorch and CUDA port of ``torchdrivesim_tpu``.

The JAX package beside this one is the reference: every module here mirrors
its counterpart there by name, and the tests hold the two against each other
on the same inputs. The port imports ``torch``, numpy and the standard
library only; the fused bird's-eye-view render runs as a hand-written CUDA
kernel (``csrc/fused_render.cu``) on a CUDA device and as its plain PyTorch
version on the CPU.

Map data is shared with the reference by path, not by import: map folders
are searched in ``TDS_RESOURCE_PATH`` directories first, then in the maps
bundled with the JAX package (``torchdrivesim_tpu/resources/maps``).
"""
import os

__version__ = "0.1.0"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_pytorch3d_available():
    """Kept for the reference's API, where it raises without pytorch3d: the
    port's rasterizers are its own, so it never raises."""


if 'TDS_RESOURCE_PATH' in os.environ:
    _resource_path = [p for p in os.environ['TDS_RESOURCE_PATH'].split(':') if p]
else:
    _resource_path = []
_resource_path.append(
    os.path.join(_REPO_ROOT, 'torchdrivesim_tpu', 'resources', 'maps'))
