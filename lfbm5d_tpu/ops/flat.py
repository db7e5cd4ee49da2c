"""Flat-region detection and the per-SAI 2D fallback filter.

The flat-region per-SAI fallback (StepParams.flat_tau) zero-weights the 5D
groups of reference patches whose local statistics say there is no
structure to match — in flat regions BM degenerates (everything matches
everything) and the full per-slot extract/transform/aggregate cost buys
nothing over a plain per-SAI shrinkage. Pixels left uncovered (den == 0 at
finalize) take a per-SAI k x k transform-domain estimate instead.

Spec choices (mirrored literally by the float64 oracle, oracle/oracle.py):

* Flatness metric: ANGULAR REDUNDANCY, not single-patch variance. A first
  attempt classified on the k x k patch variance and failed measurably: at
  sigma=25 a flat patch's sample variance (sigma^2 +- 18%) overlaps weak
  texture's (signal var 0.2-0.85 sigma^2 on the bench content), so 18% of
  fully-textured patches misclassified and the fallback ghosted them
  (-6 dB at the flagship). The shipped statistic is the mean squared
  deviation of every view from the ANGULAR MEAN over the patch:
      D(y, x) = (1/A) * sum_v box_k((x_v - mean_v x_v)^2)(y, x) / k^2
  computed on channel 0 of the NOISY LF in BOTH steps — redundancy is a
  content property, and only the noisy image carries the sigma^2 noise
  anchor the threshold is calibrated to (a second measured failure:
  computing it on the Wiener step's basic estimate, whose residual noise
  is far below sigma, turned the threshold into a pure misalignment bound
  and classified slowly-moving texture as redundant: -3.6 dB),
  quantized to 1/DIST_QUANT units of [0,255]^2 exactly like BM distances.
  Where content is genuinely angular-redundant D concentrates at
  sigma^2 (A-1)/A with ~sqrt(2/(A k^2)) relative sd (it averages A*k^2
  samples); any disparity-carrying texture adds its misalignment energy —
  which is also exactly the GHOST energy the angular-mean fallback would
  commit — on top. The threshold is therefore RELATIVE to the redundant
  center: a position is redundant iff
      round(D * Q) <= round(flat_tau * sigma_c0^2 * (A-1)/A * Q),
  with flat_tau ~ 1.1-1.2 as the margin multiplier (an absolute-sigma^2
  form measured badly at small A: at A=4 the center is 0.75 sigma^2 and a
  1.3 sigma^2 threshold admitted ~0.3 sigma^2 of ghost energy). The mask
  is ref-SAI-independent (one field per step).
* Fallback estimate (LF-aware): redundant means all views agree, so the
  ANGULAR MEAN over all A SAIs is unbiased there and cuts the noise by
  sqrt(A) for free. The fallback averages the LF over the angular axes,
  pads to k-multiples by symmetric reflection, partitions into
  non-overlapping k x k blocks, applies the step's tau_2d transform,
  shrinks, inverts, crops, and broadcasts to every SAI. Shrinkage: the
  step-1 form is EMPIRICAL Wiener against the mean's own spectrum
  (w = max(B^2 - s^2, 0) / max(B^2, s^2), s = sigma_c/sqrt(A)) — a hard
  threshold measurably over-smooths static weak texture (1.5 dB on a
  static-textured plane at A=4) while empirical Wiener attenuates
  noise-level coefficients smoothly; the step-2 form is standard Wiener
  against the angular-mean basic pilot with noise power sigma_c^2/A.
  (The reference-list idea is a per-SAI fallback; the angular mean
  dominates it on light fields — in redundant regions all views agree by
  definition.)
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from lfbm5d_tpu.ops.distances import DIST_QUANT, _box_sum


def flat_ref_mask(planes, ys, xs, k: int, flat_tau: float, sigma0):
    """True where the reference-grid position is angular-REDUNDANT.

    planes: [A, Hp, Wp] channel-0 NOISY image of every SAI (padded,
    flattened angular axis; both steps use the noisy LF — see module
    docstring). ys/xs: static reference grids (padded coords). sigma0:
    channel-0 sigma (traced scalar OK). Returns bool [len(ys)*len(xs)];
    the statistic is ref-SAI-independent — compute once per step.
    """
    ysj = jnp.asarray(np.asarray(ys), jnp.int32)
    xsj = jnp.asarray(np.asarray(xs), jnp.int32)
    a = planes.shape[0]
    m = jnp.mean(planes, axis=0)
    dev = jnp.mean((planes - m[None]) ** 2, axis=0)  # [Hp, Wp]
    d = _box_sum(dev, k) / (k * k)
    qd = jnp.round(jnp.take(jnp.take(d, ysj, 0), xsj, 1) * DIST_QUANT)
    thr_q = jnp.round(
        flat_tau * sigma0 * sigma0 * ((a - 1) / a) * DIST_QUANT
    )
    return (qd <= thr_q).reshape(-1)


def _blockify(x, k: int):
    """[..., H, W, C] -> ([..., by, bx, k, k, C], H, W) with symmetric pad."""
    h, w = x.shape[-3], x.shape[-2]
    ph, pw = (-h) % k, (-w) % k
    if ph or pw:
        pad = [(0, 0)] * (x.ndim - 3) + [(0, ph), (0, pw), (0, 0)]
        x = jnp.pad(x, pad, mode="symmetric")
    lead = x.shape[:-3]
    hp, wp, c = x.shape[-3:]
    b = x.reshape(*lead, hp // k, k, wp // k, k, c)
    return jnp.moveaxis(b, -4, -3), h, w  # [..., by, bx, k, k, C]


def _sep2d(m, x):
    """Apply the k x k matrix m along both block axes of [..., k, k, C]."""
    hi = lax.Precision.HIGHEST
    x = jnp.einsum("uq,...qvc->...uvc", m, x, precision=hi)
    return jnp.einsum("vq,...uqc->...uvc", m, x, precision=hi)


def fallback_shrink_2d(x, sigma_c, f2, i2, lambda_3d: float, pilot=None):
    """Angular-mean k x k blockwise transform shrinkage (the den==0 fallback).

    x: [aH, aW, H, W, C] noisy LF. sigma_c: [C] per-channel sigma.
    f2/i2: k x k tau_2d transform pair. pilot: basic-estimate LF ->
    Wiener shrinkage against its angular mean; None -> HT at
    lambda_3d * sigma_c / sqrt(A) with the DC coefficient always kept.
    Returns [aH, aW, H, W, C] (the shrunk mean broadcast to every SAI).
    """
    k = f2.shape[0]
    a_h, a_w = x.shape[:2]
    a = a_h * a_w
    sig_m = sigma_c / jnp.sqrt(jnp.asarray(float(a), sigma_c.dtype))
    xb, h, w = _blockify(jnp.mean(x, axis=(0, 1)), k)
    spec = _sep2d(f2, xb)
    if pilot is None:
        # empirical Wiener against the mean's own spectrum (HT measurably
        # over-smooths static weak texture; lambda_3d unused here)
        del lambda_3d
        s2 = sig_m * sig_m
        b2 = jnp.maximum(spec * spec - s2, 0.0)
        filt = spec * (b2 / (b2 + s2))
    else:
        pb, _, _ = _blockify(jnp.mean(pilot, axis=(0, 1)), k)
        sb = _sep2d(f2, pb)
        b2 = sb * sb
        filt = spec * (b2 / (b2 + sig_m * sig_m))
    est = _sep2d(i2, filt)
    est = jnp.moveaxis(est, -3, -4)  # [by, k, bx, k, C]
    hp = est.shape[-5] * k
    wp = est.shape[-3] * k
    est = est.reshape(hp, wp, est.shape[-1])[:h, :w, :]
    return jnp.broadcast_to(est, (a_h, a_w, h, w, est.shape[-1]))
