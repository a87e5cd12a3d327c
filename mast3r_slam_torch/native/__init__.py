"""Native (C++/OpenMP) host preprocessing, bound with ctypes: the port's
counterpart of ``mast3r_slam_tpu/native``.

``preprocess.cpp`` is built by `ops.build` with g++ into ``build/native/`` at
first use (never next to its source). Where it cannot be built (no g++),
`native_available()` is False and the resize falls back to PIL, as the JAX
loader does; a host with neither cannot preprocess images.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        from mast3r_slam_torch.ops import build

        try:
            lib = build.load("preprocess")
        except (OSError, RuntimeError) as e:
            print(f"[native] build failed ({e}); using the PIL path")
            _build_failed = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i = ctypes.c_int
        lib.resize_area_u8.argtypes = [u8p, i, i, u8p, i, i]
        lib.resize_bilinear_u8.argtypes = [u8p, i, i, u8p, i, i]
        lib.crop_normalize_f32.argtypes = [u8p, i, i, i, i, i, i, f32p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def resize_u8(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Resize [H, W, 3] u8: area-average when shrinking, bilinear when
    growing (PIL LANCZOS / BICUBIC where the library is missing)."""
    lib = _load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    sh, sw = img.shape[:2]
    if lib is None:
        from PIL import Image

        pil = Image.fromarray(img).resize((dw, dh), Image.LANCZOS if dw < sw else Image.BICUBIC)
        return np.asarray(pil)
    out = np.empty((dh, dw, 3), np.uint8)
    fn = lib.resize_area_u8 if dw <= sw else lib.resize_bilinear_u8
    fn(_u8p(img), sh, sw, _u8p(out), dh, dw)
    return out


def crop_normalize(img: np.ndarray, cy0: int, cx0: int, ch: int, cw: int) -> np.ndarray:
    """Center-crop + normalize u8 -> float32 [-1, 1], fused."""
    lib = _load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    sh, sw = img.shape[:2]
    if lib is None:
        crop = img[cy0:cy0 + ch, cx0:cx0 + cw].astype(np.float32)
        return crop / 127.5 - 1.0
    out = np.empty((ch, cw, 3), np.float32)
    lib.crop_normalize_f32(_u8p(img), sh, sw, cy0, cx0, ch, cw,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
