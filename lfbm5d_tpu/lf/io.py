"""Light-field I/O: a LF on disk is a directory of per-SAI images.

Reproduces the reference's `load_LF`/`save_LF` contract (SURVEY.md §2 #5,
§3.5): a printf-style name pattern with two angular indices (e.g.
``SAI_%02d_%02d.png``), an angular extent aH x aW, and an index offset for
datasets where only the central sub-grid is usable (EPFL Lytro: stored 15x15,
central 9x9 used). 8-bit and 16-bit images are supported; pixels are
normalized to the float [0, 255] scale internally (16-bit divided by 257), and
written back at the requested depth.

PNG decode/encode runs on the host through the thread-pooled native libpng
codec (lfbm5d_tpu.native). OpenCV or Pillow are imported only by the
fallback, when the native codec cannot be built or the files are not PNG.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels: grey, RGB, palette, grey+alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}


def png_header(path: str) -> tuple[int, int, int, int]:
    """(height, width, channels, bit_depth) from a PNG's IHDR chunk.

    Reads the first 26 bytes only; raises ValueError on a non-PNG file.
    """
    with open(path, "rb") as f:
        head = f.read(26)
    if len(head) < 26 or head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"not a PNG file: {path!r}")
    w, h, depth, ctype = struct.unpack(">IIBB", head[16:26])
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"unknown PNG colour type {ctype} in {path!r}")
    return h, w, _PNG_CHANNELS[ctype], depth


def _pattern_name(pattern: str, s: int, t: int) -> str:
    return pattern % (s, t)


_ROUND_JITS: dict = {}


def fetch_rounded(lf, bit_depth: int = 8) -> np.ndarray:
    """Fetch a device-resident LF as save-ready values, quantized ON the
    accelerator so the device->host transfer moves uint8/uint16 instead of
    float32 (4x/2x fewer bytes).

    Returns float32 values that are fixed points of save_lf's own
    round/clamp (half-up, the native io_png convention), so
    ``save_lf(fetch_rounded(x, d), ..., bit_depth=d)`` writes exactly what
    ``save_lf(np.asarray(x), ..., bit_depth=d)`` would. Host arrays pass
    through unchanged (already on the host, nothing to save)."""
    import jax

    if not isinstance(lf, jax.Array):
        return np.asarray(lf)
    import jax.numpy as jnp

    key = int(bit_depth)
    if key not in _ROUND_JITS:
        if bit_depth == 16:
            def _q(x):
                v = jnp.clip(x.astype(jnp.float32), 0.0, 255.0)
                return jnp.floor(v * 257.0 + 0.5).astype(jnp.uint16)
        else:
            def _q(x):
                v = jnp.clip(x.astype(jnp.float32), 0.0, 255.0)
                return jnp.floor(v + 0.5).astype(jnp.uint8)
        _ROUND_JITS[key] = jax.jit(_q)
    q = np.asarray(_ROUND_JITS[key](lf))
    if bit_depth == 16:
        # q/257 round-trips exactly through save_lf's round(v*257)
        return (q.astype(np.float64) / 257.0).astype(np.float32)
    return q.astype(np.float32)


def load_lf(
    directory: str,
    pattern: str,
    a_h: int,
    a_w: int,
    s_offset: int = 0,
    t_offset: int = 0,
    use_native: str = "auto",
) -> np.ndarray:
    """Load an LF as float [aH, aW, H, W, C] in [0, 255] units.

    use_native: 'auto' tries the C++ parallel PNG decoder
    (lfbm5d_tpu.native) and falls back to OpenCV/PIL; 'never' forces the
    fallback; 'always' raises if the native path is unavailable.
    """
    if use_native in ("auto", "always"):
        paths = [
            os.path.join(directory, _pattern_name(pattern, s + s_offset, t + t_offset))
            for s in range(a_h)
            for t in range(a_w)
        ]
        if all(p.lower().endswith(".png") for p in paths):
            try:
                from lfbm5d_tpu import native

                if native.available():
                    h, w, c, _ = png_header(paths[0])
                    return native.load_lf_native(paths, a_h, a_w, h, w,
                                                 1 if c <= 2 else 3)
            except Exception:
                if use_native == "always":
                    raise
        elif use_native == "always":
            raise RuntimeError("native loader handles PNG inputs only")

    def _read_one(path):
        # PIL silently degrades 16-bit multi-channel PNGs; prefer OpenCV.
        try:
            import cv2

            arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            if arr is None:
                raise FileNotFoundError(path)
            if arr.ndim == 3:
                arr = arr[:, :, :3][:, :, ::-1]  # strip alpha, BGR -> RGB
        except ImportError:
            from PIL import Image

            arr = np.asarray(Image.open(path))
            if arr.ndim == 3 and arr.shape[2] > 3:
                arr = arr[:, :, :3]  # strip alpha, matching cv2/native paths
        if arr.dtype == np.uint16:
            arr = arr.astype(np.float64) / 257.0
        else:
            arr = arr.astype(np.float64)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr

    sais = []
    for s in range(a_h):
        row = []
        for t in range(a_w):
            path = os.path.join(
                directory, _pattern_name(pattern, s + s_offset, t + t_offset)
            )
            row.append(_read_one(path))
        sais.append(row)
    lf = np.stack([np.stack(r, axis=0) for r in sais], axis=0)
    return lf


def save_lf(
    lf: np.ndarray,
    directory: str,
    pattern: str,
    s_offset: int = 0,
    t_offset: int = 0,
    bit_depth: int = 8,
) -> None:
    """Write an [aH, aW, H, W, C] float LF (in [0,255]) as per-SAI images.

    Uses the thread-pooled native libpng encoder when available (writing
    81+ SAIs serially through PIL starves the streaming driver the same way
    serial decode did); falls back to PIL/OpenCV. The native writer rounds
    half-up (the reference io_png convention); the fallback uses np.round
    — they differ only on exact .5 sample values.
    """
    os.makedirs(directory, exist_ok=True)
    a_h, a_w = lf.shape[:2]
    if lf.ndim == 5 and lf.shape[-1] in (1, 3) and bit_depth in (8, 16):
        try:
            from lfbm5d_tpu import native

            if native.available():
                paths = [
                    os.path.join(
                        directory,
                        _pattern_name(pattern, s + s_offset, t + t_offset),
                    )
                    for s in range(a_h)
                    for t in range(a_w)
                ]
                native.save_lf_native(np.asarray(lf), paths, bit_depth)
                return
        except RuntimeError as e:
            # Encoder unavailable (build/symbol failure) -> PIL/OpenCV path.
            # Genuine encode errors (IOError) propagate: a partial write must
            # not be silently retried with a different rounding convention.
            import logging

            logging.getLogger(__name__).info(
                "native PNG encoder unavailable (%s); falling back to PIL", e
            )
    for s in range(a_h):
        for t in range(a_w):
            arr = np.asarray(lf[s, t], dtype=np.float64)
            if bit_depth == 16:
                out = np.clip(np.round(arr * 257.0), 0, 65535).astype(np.uint16)
            else:
                out = np.clip(np.round(arr), 0, 255).astype(np.uint8)
            if out.shape[-1] == 1:
                out = out[:, :, 0]
            path = os.path.join(
                directory, _pattern_name(pattern, s + s_offset, t + t_offset)
            )
            if bit_depth == 16 and out.ndim == 3:
                # PIL has no 16-bit multi-channel PNG mode; use OpenCV (BGR)
                import cv2

                cv2.imwrite(path, out[:, :, ::-1])
            else:
                from PIL import Image

                Image.fromarray(out).save(path)
