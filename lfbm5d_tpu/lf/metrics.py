"""Quality metrics on [0, 255]-scale arrays (reference `compute_psnr`)."""

from __future__ import annotations

import numpy as np


def rmse(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def psnr(a, b, peak: float = 255.0) -> float:
    r = rmse(a, b)
    if r == 0:
        return float("inf")
    return float(20.0 * np.log10(peak / r))


_MSE_JIT = None


def psnr_device(pred, ref, peak: float = 255.0) -> float:
    """PSNR with the reduction on the accelerator; only the scalar MSE
    crosses the device->host boundary. Equivalent to
    psnr(clip(pred, 0, peak), ref) — use when `pred` is a device array, so
    the whole LF is not copied to the host for one number. `ref` may be
    host or device."""
    global _MSE_JIT
    import jax
    import jax.numpy as jnp

    if _MSE_JIT is None:
        def _mse(p, r, pk):
            # f32 squares under XLA's tree reduction: relative MSE error
            # ~1e-6 at flagship element counts (validated vs host f64 in
            # tests/test_lf.py), far inside the 3-decimal dB convention.
            d = jnp.clip(p.astype(jnp.float32), 0.0, pk) - r.astype(
                jnp.float32)
            return jnp.mean(jnp.square(d))
        _MSE_JIT = jax.jit(_mse)
    m = float(_MSE_JIT(pred, jnp.asarray(np.asarray(ref)), peak))
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / m))


_GRID_JIT = None


def psnr_grid_device(pred, ref, peak: float = 255.0) -> np.ndarray:
    """Per-SAI PSNR grid [aH, aW] with the reductions on the accelerator
    (one pass; only aH*aW scalars are fetched). Same clipping convention
    as psnr_device."""
    global _GRID_JIT
    import jax
    import jax.numpy as jnp

    if _GRID_JIT is None:
        def _grid(p, r, pk):
            d = jnp.clip(p.astype(jnp.float32), 0.0, pk) - r.astype(
                jnp.float32)
            return jnp.mean(jnp.square(d), axis=(2, 3, 4))
        _GRID_JIT = jax.jit(_grid)
    m = np.asarray(_GRID_JIT(pred, jnp.asarray(np.asarray(ref)), peak),
                   dtype=np.float64)
    with np.errstate(divide="ignore"):
        return 10.0 * np.log10(peak * peak / m)
