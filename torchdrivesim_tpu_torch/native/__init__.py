"""
Native (C++) fast path of the host-side map bake (counterpart of
``torchdrivesim_tpu/native``): ``mapbake.cpp`` is compiled on first use with
the system ``g++`` into ``build/native/`` at the repository root (named by
the hash of the source) and bound through ``ctypes``. The direction baker
keeps the reference's pure-Python fallback; set ``TDS_NO_NATIVE=1`` to take
it. ``map_grids.DIRECTION_BAKES`` counts which path baked.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from typing import Optional

import numpy as np

from torchdrivesim_tpu_torch import _REPO_ROOT

logger = logging.getLogger(__name__)

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_REPO_ROOT, 'build', 'native')
_LIB = None
_LIB_FAILED = False


def _load_library() -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load the native library; None on failure."""
    global _LIB, _LIB_FAILED
    if _LIB is not None:
        return _LIB
    if _LIB_FAILED or os.environ.get('TDS_NO_NATIVE'):
        return None
    try:
        src = os.path.join(_SRC_DIR, 'mapbake.cpp')
        with open(src, 'rb') as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so_path = os.path.join(BUILD_DIR, f'tds_mapbake_{digest}.so')
        if not os.path.exists(so_path):
            tmp = so_path + f'.tmp{os.getpid()}'
            subprocess.run(['g++', '-O3', '-shared', '-fPIC', '-std=c++17', src, '-o', tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)        # a rename: concurrent builds race safely
        lib = ctypes.CDLL(so_path)
        lib.tds_bake_direction.restype = ctypes.c_int
        lib.tds_bake_direction.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
        return lib
    except Exception as e:  # no g++, a read-only checkout, a bad toolchain, ...
        logger.info('native mapbake unavailable (%s); using the Python baker', e)
        _LIB_FAILED = True
        return None


def bake_direction_native(lanelet_map, origin, cell_size: float, h: int, w: int,
                          tolerance: float, k_layers: int) -> Optional[np.ndarray]:
    """
    C++ fast path of :func:`torchdrivesim_tpu_torch.map_grids._bake_direction`.

    Returns the (h, w) int32 packed direction grid (byte k = layer k, 255 =
    invalid), or None when the native library is unavailable: callers fall
    back to the Python baker.
    """
    lib = _load_library()
    if lib is None:
        return None
    poly_pts, poly_off = [], [0]
    cl_pts, cl_off = [], [0]
    for ll in lanelet_map.laneletLayer:
        poly = np.asarray(ll.polygon(), dtype=np.float64)
        cl = np.asarray(ll.centerline.coords(), dtype=np.float64)
        poly_pts.append(poly)
        cl_pts.append(cl)
        poly_off.append(poly_off[-1] + len(poly))
        cl_off.append(cl_off[-1] + len(cl))
    n_ll = len(poly_off) - 1
    if n_ll == 0:
        return np.full((h, w), -1, dtype=np.int32)      # every layer invalid
    poly_arr = np.ascontiguousarray(np.concatenate(poly_pts), dtype=np.float64)
    cl_arr = np.ascontiguousarray(np.concatenate(cl_pts), dtype=np.float64)
    poly_off = np.asarray(poly_off, dtype=np.int64)
    cl_off = np.asarray(cl_off, dtype=np.int64)
    out = np.empty((h, w), dtype=np.int32)
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    rc = lib.tds_bake_direction(
        ptr(poly_arr, ctypes.c_double), ptr(poly_off, ctypes.c_int64),
        ptr(cl_arr, ctypes.c_double), ptr(cl_off, ctypes.c_int64), ctypes.c_int64(n_ll),
        ctypes.c_double(float(origin[0])), ctypes.c_double(float(origin[1])),
        ctypes.c_double(float(cell_size)), ctypes.c_int64(h), ctypes.c_int64(w),
        ctypes.c_double(float(tolerance)), ctypes.c_int64(k_layers), ptr(out, ctypes.c_int32))
    if rc != 0:
        logger.warning('native mapbake returned %d; using the Python baker', rc)
        return None
    return out
