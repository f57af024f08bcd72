"""
Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under ``build/kernels/`` at the
repository root, named by the hash of the source and the flags, and bound
with ``ctypes``. A build happens at first use (or in :func:`build_all`,
which starts one ``nvcc`` per source at once); a library whose name exists
is reused.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Callable, Optional, Sequence

from torchdrivesim_tpu_torch import _REPO_ROOT

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        'csrc')
BUILD_DIR = os.path.join(_REPO_ROOT, 'build', 'kernels')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']


def nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    found = shutil.which('nvcc') or os.path.join(cuda_home, 'bin', 'nvcc')
    if not os.path.exists(found):
        raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                           'csrc/ at first use and need the CUDA toolkit')
    return found


class KernelLibrary:
    """
    One kernel source and its shared library.

    Args:
        source_name: file name under ``csrc/``.
        bind: declares the C entry points' ``argtypes``/``restype`` on the
            loaded library and returns it.
    """
    def __init__(self, source_name: str, bind: Callable[[ctypes.CDLL], ctypes.CDLL]):
        self.source = os.path.join(CSRC_DIR, source_name)
        self.bind = bind
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def name(self) -> str:
        return os.path.splitext(os.path.basename(self.source))[0]

    def path(self) -> str:
        """Where the built library lives for the current source and flags."""
        with open(self.source, 'rb') as f:
            digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR, f'{self.name}_{digest.hexdigest()[:16]}.so')

    def _start(self):
        """Start ``nvcc`` on a temporary output name unless the library
        exists; returns (process, temporary path) or None."""
        if os.path.exists(self.path()):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, '-o', tmp, self.source],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        return proc, tmp

    def _finish(self, started) -> str:
        """Wait for a build from :meth:`_start` and move it into place (a
        rename, so concurrent processes never load a partial file)."""
        path = self.path()
        if started is None:
            return path
        proc, tmp = started
        try:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed on {self.source} '
                                   f'({proc.returncode}):\n{out}\n{err}')
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path

    def build(self) -> str:
        """Compile the library unless it exists; returns its path."""
        return self._finish(self._start())

    def load(self) -> ctypes.CDLL:
        """The bound library, built first if needed."""
        if self._lib is None:
            self._lib = self.bind(ctypes.CDLL(self.build()))
        return self._lib


def build_all(libraries: Sequence[KernelLibrary]) -> float:
    """Build every library with one ``nvcc`` each, all started together, and
    load them; returns the seconds taken."""
    t0 = time.perf_counter()
    started = [lib._start() for lib in libraries]
    for lib, s in zip(libraries, started):
        lib._finish(s)
    for lib in libraries:
        lib.load()
    return time.perf_counter() - t0


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f'{what} kernel launch failed: CUDA error {err}')
