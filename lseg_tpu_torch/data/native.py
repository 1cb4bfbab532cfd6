"""ctypes bindings for the native data-loader core (native/lseg_io.cpp).

Builds the shared library on first import (g++, cached beside the
source); every entry point degrades gracefully to the PIL/NumPy path
when the toolchain or image libs are unavailable. All native calls run
with the GIL released, so the threaded DataLoader scales across cores.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native"
)
_SRC = os.path.join(_NATIVE_DIR, "lseg_io.cpp")
_SO = os.path.join(_NATIVE_DIR, "liblseg_io.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-o", _SO, _SRC,
        "-ljpeg", "-lpng",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            if not os.path.exists(_SRC) or not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.lseg_decode_jpeg.restype = ctypes.c_int
        lib.lseg_decode_png.restype = ctypes.c_int
        lib.lseg_load_image_f32.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode(path_or_bytes, mask: bool = False) -> Optional[np.ndarray]:
    """Decode a JPEG/PNG to uint8 HWC (RGB) or HW (mask). None if the
    native path is unavailable or decoding fails."""
    lib = _load()
    if lib is None:
        return None
    data = (
        path_or_bytes
        if isinstance(path_or_bytes, (bytes, bytearray))
        else open(path_or_bytes, "rb").read()
    )
    buf = ctypes.POINTER(ctypes.c_uint8)()
    h = ctypes.c_int()
    w = ctypes.c_int()
    cdata = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    if data[:2] == b"\xff\xd8" and not mask:
        rc = lib.lseg_decode_jpeg(
            cdata, len(data), ctypes.byref(buf),
            ctypes.byref(h), ctypes.byref(w),
        )
        c = 3
    else:
        c = 1 if mask else 3
        rc = lib.lseg_decode_png(
            cdata, len(data), c, ctypes.byref(buf),
            ctypes.byref(h), ctypes.byref(w),
        )
    if rc != 0:
        return None
    n = h.value * w.value * c
    arr = np.ctypeslib.as_array(buf, shape=(n,)).copy()
    lib.lseg_free(buf)
    shape = (h.value, w.value) if c == 1 else (h.value, w.value, 3)
    return arr.reshape(shape)


def load_image_f32(
    path: str, out_hw: Tuple[int, int], mean, std
) -> Optional[np.ndarray]:
    """decode -> bilinear resize -> normalize, entirely in C. Returns
    (oh, ow, 3) fp32 or None when native is unavailable."""
    lib = _load()
    if lib is None:
        return None
    data = open(path, "rb").read()
    oh, ow = out_hw
    out = np.empty((oh, ow, 3), np.float32)
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    cdata = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    rc = lib.lseg_load_image_f32(
        cdata, len(data), oh, ow,
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out if rc == 0 else None


def resize_nearest_i32(mask: np.ndarray, oh: int, ow: int) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(mask, np.int32)
    if lib is None:
        h, w = src.shape
        ys = (np.arange(oh) * (h / oh)).astype(np.int64)
        xs = (np.arange(ow) * (w / ow)).astype(np.int64)
        return src[ys][:, xs]
    dst = np.empty((oh, ow), np.int32)
    lib.lseg_resize_nearest_i32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        src.shape[0], src.shape[1],
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), oh, ow,
    )
    return dst
