"""ctypes bindings for the native (C++) input-pipeline kernels (port of
stable_diffusion_tpu/utils/native.py): ``native/libimage_ops.so``, built
from ``native/image_ops.cpp``.

The checked-in library is loaded as it is.  Where it does not load (another
architecture, a missing OpenMP runtime), ``g++`` builds it once into the
git-ignored ``build/native/``; ``native/`` is never written.  Where neither
loads, every entry point takes the numpy path, which computes the same
thing on the host (the library is a host-side input pipeline, not a device
kernel).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_ROOT, "native", "image_ops.cpp")
_LIB_PATHS = (os.path.join(_ROOT, "native", "libimage_ops.so"),
              os.path.join(_ROOT, "build", "native", "libimage_ops.so"))

_lib = None
_tried = False


def _build(path: str) -> None:
    """``native/Makefile``'s command, with the output under ``build/``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    subprocess.run([os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-shared", "-std=c++17",
                    "-fopenmp", "-o", path, _SOURCE], check=True, capture_output=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.resize_normalize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    lib.scale_img_inplace.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int,
    ]
    lib.resize_normalize_batch.restype = lib.scale_img_inplace.restype = None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    for i, path in enumerate(_LIB_PATHS):
        try:
            if i > 0 and not os.path.exists(path):
                _build(path)
            _lib = _bind(ctypes.CDLL(path))
            return _lib
        except (OSError, subprocess.CalledProcessError):
            continue
    return None


def available() -> bool:
    return _load() is not None


def resize_normalize_batch(images: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, out_h, out_w, C) float32 in [-1, 1].

    Bilinear with half-pixel centres; the numpy path uses the same math.
    """
    images = np.ascontiguousarray(images, dtype=np.uint8)
    n, h, w, c = images.shape
    lib = _load()
    out = np.empty((n, out_h, out_w, c), dtype=np.float32)
    if lib is not None:
        lib.resize_normalize_batch(
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n, h, w, c,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out_h, out_w,
        )
        return out
    fy = (np.arange(out_h, dtype=np.float32) + 0.5) * (h / out_h) - 0.5
    fx = (np.arange(out_w, dtype=np.float32) + 0.5) * (w / out_w) - 0.5
    y0 = np.clip(np.floor(fy).astype(np.int32), 0, h - 1)
    x0 = np.clip(np.floor(fx).astype(np.int32), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    dy = (fy - y0).astype(np.float32)[None, :, None, None]
    dx = (fx - x0).astype(np.float32)[None, None, :, None]
    im = images.astype(np.float32)
    v00 = im[:, y0][:, :, x0]
    v01 = im[:, y0][:, :, x1]
    v10 = im[:, y1][:, :, x0]
    v11 = im[:, y1][:, :, x1]
    top = v00 + (v01 - v00) * dx
    bot = v10 + (v11 - v10) * dx
    out[:] = (top + (bot - top) * dy) / 127.5 - 1.0
    return out


def scale_img_inplace(data: np.ndarray, old_range, new_range, clamp: bool = False) -> np.ndarray:
    """Linear range rescale of a float32 array (in place where it is one)."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    lib = _load()
    if lib is not None:
        lib.scale_img_inplace(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), data.size,
            float(old_range[0]), float(old_range[1]),
            float(new_range[0]), float(new_range[1]), int(clamp),
        )
        return data
    k = (new_range[1] - new_range[0]) / (old_range[1] - old_range[0])
    data[:] = (data - old_range[0]) * k + new_range[0]
    if clamp:
        np.clip(data, new_range[0], new_range[1], out=data)
    return data
