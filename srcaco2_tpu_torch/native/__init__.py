"""The permutohedral-lattice Gaussian filter on the host (C++, ctypes):
the port's copy of srcaco2_tpu/native, which losses/crf.py and
ops/pam.py call.

`permutohedral.cpp` is compiled with g++ (-O3 -fopenmp) on first use,
never on import, into `build/` next to this file (listed in .gitignore).
The library's name carries a hash of the source and the flags, so an
edited source is rebuilt; the build writes a temporary file and renames
it, so processes that build at the same time each find a whole library.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / 'permutohedral.cpp'
BUILD = Path(__file__).resolve().parent / 'build'
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17', '-fopenmp')
_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes())
    h.update(' '.join(CXX_FLAGS).encode())
    return BUILD / f'libpermutohedral-{h.hexdigest()[:12]}.so'


def build_library() -> Path:
    """The built library's path, compiled first if it is missing; raises
    with g++'s output if the build fails."""
    out = library_path()
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f'{out.stem}.{os.getpid()}.'
                            f'{threading.get_ident()}.tmp')
        res = subprocess.run(['g++', *CXX_FLAGS, str(SRC), '-o', str(tmp)],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f'g++ failed for {SRC.name}:\n{res.stdout}'
                               f'{res.stderr}')
        os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            fp = ctypes.POINTER(ctypes.c_float)
            for name in ('bilateralfilter_batch', 'bilateral_grey_batch'):
                fn = getattr(lib, name)
                fn.argtypes = [fp, fp, fp, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_float,
                               ctypes.c_float]
                fn.restype = None
            lib.permutohedral_filter.argtypes = [
                fp, fp, fp, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.permutohedral_filter.restype = None
            _LIB = lib
    return _LIB


def _as_f32(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def bilateralfilter_batch(images, segmentations, out: np.ndarray, N: int,
                          K: int, H: int, W: int, sigma_rgb: float,
                          sigma_xy: float) -> np.ndarray:
    """The reference's entry: RGB images (N, 3, H, W) and segmentations
    (N, K, H, W), flattened; `out`, a C-contiguous float32 array of
    N K H W values, is filled in place and returned."""
    img, seg = _as_f32(images), _as_f32(segmentations)
    if out.dtype != np.float32 or not out.flags['C_CONTIGUOUS'] \
            or out.size != N * K * H * W or img.size != N * 3 * H * W \
            or seg.size != N * K * H * W:
        raise ValueError('bilateralfilter_batch: sizes or out layout')
    _lib().bilateralfilter_batch(_ptr(img), _ptr(seg), _ptr(out), N, K, H,
                                 W, ctypes.c_float(sigma_rgb),
                                 ctypes.c_float(sigma_xy))
    return out


def bilateral_filter(images, values, sigma_rgb: float,
                     sigma_xy: float) -> np.ndarray:
    """images (N, C, H, W), C in {1, 3}; values (N, K, H, W). Returns the
    values filtered by the bilateral Gaussian affinity in
    (x / sigma_xy, y / sigma_xy, intensity / sigma_rgb), f32."""
    images, values = _as_f32(images), _as_f32(values)
    if images.ndim != 4 or values.ndim != 4 or images.shape[1] not in (1, 3) \
            or images.shape[0] != values.shape[0] \
            or images.shape[2:] != values.shape[2:]:
        raise ValueError(f'images (N, 1|3, H, W) and values (N, K, H, W) '
                         f'expected, got {images.shape}, {values.shape}')
    n, c, h, w = images.shape
    out = np.zeros_like(values)
    fn = _lib().bilateralfilter_batch if c == 3 \
        else _lib().bilateral_grey_batch
    fn(_ptr(images), _ptr(values), _ptr(out), n, values.shape[1], h, w,
       ctypes.c_float(sigma_rgb), ctypes.c_float(sigma_xy))
    return out


def permutohedral_filter(features, values) -> np.ndarray:
    """The lattice's Gaussian filter over generic features (n, d) of the
    values (n, vd): out_i ~ sum_j exp(-|f_i - f_j|^2 / 2) v_j, f32."""
    features, values = _as_f32(features), _as_f32(values)
    if features.ndim != 2 or values.ndim != 2 \
            or features.shape[0] != values.shape[0]:
        raise ValueError(f'features (n, d) and values (n, vd) expected, '
                         f'got {features.shape}, {values.shape}')
    n, d = features.shape
    out = np.zeros_like(values)
    _lib().permutohedral_filter(_ptr(features), _ptr(values), _ptr(out), n,
                                d, values.shape[1])
    return out
