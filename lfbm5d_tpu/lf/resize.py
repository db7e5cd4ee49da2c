"""Resampling operators shared by the SR pipeline and its oracle.

The reference SR branch (ICIP18, SURVEY.md §2.10) upscales each SAI
(bicubic), then alternates LFBM5D filtering with iterative back-projection
against the LR light field under a fixed blur/decimation model. Spec choices
for this rebuild (shared verbatim by the float64 oracle so parity is exact):

  * `upsample`: per-SAI bicubic via jax.image.resize(method='cubic').
  * `downsample`: exact alpha x alpha box average (reshape-mean) — the
    decimation model of the back-projection loop. An optional Gaussian
    pre-blur (`blur_sigma`) gives the classical anti-aliased blur+decimate
    model of ICIP18's IBP.
"""

from __future__ import annotations

import numpy as np
import jax.image
import jax.numpy as jnp


def upsample(lf, scale: int, method: str = "cubic"):
    """[aH, aW, H, W, C] -> [aH, aW, scale*H, scale*W, C], per-SAI."""
    a_h, a_w, h, w, c = lf.shape
    return jax.image.resize(
        lf, (a_h, a_w, h * scale, w * scale, c), method=method
    )


def gaussian_blur(lf, sigma: float):
    """Separable per-SAI Gaussian blur with reflect borders.

    Kernel radius ceil(3*sigma); taps normalized to sum 1 in float64.
    """
    if sigma <= 0:
        return lf
    r = int(np.ceil(3.0 * sigma))
    x = np.arange(-r, r + 1, dtype=np.float64)
    taps = np.exp(-0.5 * (x / sigma) ** 2)
    taps /= taps.sum()
    t = jnp.asarray(taps, lf.dtype)

    def conv_axis(arr, axis):
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (r, r)
        ext = jnp.pad(arr, pad, mode="reflect")
        out = 0.0
        for i in range(2 * r + 1):
            idx = [slice(None)] * arr.ndim
            idx[axis] = slice(i, i + arr.shape[axis])
            out = out + t[i] * ext[tuple(idx)]
        return out

    return conv_axis(conv_axis(lf, 2), 3)


def downsample(lf, scale: int, blur_sigma: float = 0.0):
    """Box-average decimation: [aH, aW, H, W, C] -> [..., H/s, W/s, C].

    blur_sigma > 0 applies a Gaussian pre-blur (anti-aliased decimation
    model) before the box average.
    """
    a_h, a_w, h, w, c = lf.shape
    if h % scale or w % scale:
        raise ValueError(f"extent {(h, w)} not divisible by scale {scale}")
    lf = gaussian_blur(lf, blur_sigma)
    x = lf.reshape(a_h, a_w, h // scale, scale, w // scale, scale, c)
    return jnp.mean(x, axis=(3, 5))
