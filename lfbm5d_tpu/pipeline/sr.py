"""LFBM5D super-resolution (reference SR branch, ICIP18; SURVEY.md §3.4).

Pipeline: per-SAI bicubic x-scale init, then n_iter rounds of
  (a) LFBM5D filtering of the HR estimate with a decreasing sigma schedule
      (the 5D sparse-coding prior), and
  (b) iterative back-projection: HR += gain * up(LR - down(HR)),
with the box-average decimation / bicubic upsampling model of
lfbm5d_tpu.lf.resize. The sigma schedule is linear from sigma_init to
sigma_final (SURVEY.md §2.10 SR paragraph).

Sigma enters the jitted steps as an array argument, so the schedule does not
trigger recompilation; one compilation serves all iterations.

Checkpoint contract (SURVEY.md §5.4): `run_sr` accepts an `on_iteration`
callback so drivers can persist the HR estimate after every iteration.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from lfbm5d_tpu.config import DenoiseParams, SRParams
from lfbm5d_tpu.lf.resize import downsample, upsample
from lfbm5d_tpu.pipeline.denoise import _sigma_channels, run_bm5d


def sigma_schedule(params: SRParams) -> np.ndarray:
    return np.linspace(params.sigma_init, params.sigma_final, params.n_iter)


def run_sr(lr_lf, params: SRParams, on_iteration=None, dtype: str = "float32"):
    """Super-resolve an LR light field [aH, aW, h, w, C] by params.scale.

    Returns the HR estimate [aH, aW, scale*h, scale*w, C] (jnp array).
    """
    if isinstance(lr_lf, jax.Array):  # avoid a device->host round-trip
        lr = lr_lf.astype(jnp.dtype(dtype))
    else:
        lr = jnp.asarray(np.asarray(lr_lf), jnp.dtype(dtype))
    hr = upsample(lr, params.scale)
    a_h, a_w, h, w, c = hr.shape
    # Every iteration's filter goes through run_bm5d. Sigma enters only as
    # the traced sigma_c argument and params.sigma stays 0.0 in the jit
    # key, so one compilation per geometry serves the whole schedule.
    dn = DenoiseParams(
        sigma=0.0,
        lambda_3d=params.lambda_3d,
        color_space=params.color_space,
        ht=params.ht,
        wiener=params.wiener,
        chunk=params.chunk,
    )
    schedule = sigma_schedule(params)
    for i, sigma in enumerate(schedule):
        sigma_c = _sigma_channels(float(sigma), params.color_space, c, dtype)
        _, hr = run_bm5d(hr, dn, dtype, sigma_c=sigma_c)
        residual = lr - downsample(hr, params.scale, params.decimation_blur)
        hr = hr + params.bp_gain * upsample(residual, params.scale)
        if on_iteration is not None:
            on_iteration(i, hr)
    return hr
