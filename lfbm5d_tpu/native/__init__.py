"""ctypes binding for the native parallel LF loader (io_accel.cpp).

Builds on demand via `make -C lfbm5d_tpu/native` (needs g++ and the libpng
headers); lfbm5d_tpu.lf.io falls back to OpenCV/Pillow when the toolchain
or library is unavailable, so the package has no hard native dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libio_accel.so")
_lib = None


def _ensure_built() -> bool:
    global _lib
    if _lib is not None:
        return True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", _DIR, "-s"], check=True, capture_output=True
            )
        except (OSError, subprocess.CalledProcessError):
            return False
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return False
    lib.lf_load_png.restype = ctypes.c_int
    lib.lf_load_png.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    if hasattr(lib, "lf_save_png"):
        lib.lf_save_png.restype = ctypes.c_int
        lib.lf_save_png.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
    _lib = lib
    return True


def available() -> bool:
    return _ensure_built()


def load_lf_native(paths, a_h: int, a_w: int, h: int, w: int,
                   c: int) -> np.ndarray:
    """Decode `paths` (aH*aW PNG files) into [aH, aW, H, W, C] float32.

    All images must share (h, w) and decode to `c` channels; 16-bit samples
    are scaled to the [0, 255] float range (divided by 257), matching
    lfbm5d_tpu.lf.io.load_lf.
    """
    if not _ensure_built():
        raise RuntimeError("native io_accel unavailable (build failed)")
    n = len(paths)
    if n != a_h * a_w:
        raise ValueError(f"expected {a_h * a_w} paths, got {n}")
    out = np.empty((n, h, w, c), dtype=np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    err_i = ctypes.c_int(-1)
    rc = _lib.lf_load_png(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, c, ctypes.byref(err_i),
    )
    if rc:
        bad = paths[err_i.value] if 0 <= err_i.value < n else "?"
        raise IOError(f"native PNG decode failed (code {rc}) for {bad!r}")
    return out.reshape(a_h, a_w, h, w, c)


def save_lf_native(lf, paths, bit_depth: int = 8) -> None:
    """Encode an [aH, aW, H, W, C] float LF to PNG files, thread-pooled.

    Write-side twin of load_lf_native; rounds half-up like the reference's
    io_png writer. bit_depth 8 or 16 (16-bit scaled by 257).
    """
    if not _ensure_built():
        raise RuntimeError("native io_accel unavailable (build failed)")
    if not hasattr(_lib, "lf_save_png"):
        raise RuntimeError("libio_accel.so lacks lf_save_png (rebuild)")
    a_h, a_w, h, w, c = lf.shape
    n = a_h * a_w
    if len(paths) != n:
        raise ValueError(f"expected {n} paths, got {len(paths)}")
    data = np.ascontiguousarray(lf, dtype=np.float32).reshape(n, h, w, c)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    err_i = ctypes.c_int(-1)
    rc = _lib.lf_save_png(
        arr, n, data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, c, bit_depth, ctypes.byref(err_i),
    )
    if rc:
        bad = paths[err_i.value] if 0 <= err_i.value < n else "?"
        raise IOError(f"native PNG encode failed (code {rc}) for {bad!r}")
