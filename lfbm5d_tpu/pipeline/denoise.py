"""Two-step HT -> Wiener LFBM5D pipeline, dense and jitted (reference run_bm5d).

Design stance (SURVEY.md §7): the C++ reference is patch-at-a-time and
branch-heavy; this pipeline is grid-at-a-time and dense. One jitted function
per step processes every reference patch of every reference SAI:

  lax.scan over reference SAIs
    -> displacement-stacked self-BM distances at the whole reference grid
    -> stable masked top-N + power-of-two truncation (ops.match)
    -> lax.scan over SAIs: dense disparity-argmin maps, gathered at the
       similar-patch positions (ops.distances.cross_argmin)
    -> lax.fori_loop over fixed-size reference-patch chunks:
         one big gather builds the [chunk, N, aH, aW, k, k, C] 5D group
         -> separable transform (batched einsums) -> HT or Wiener shrinkage
         -> inverse transform -> Kaiser*weight scatter-add into the
         per-SAI numerator/denominator accumulators.

Every shape is static; variable group sizes are realized by per-group
zero-padded stack matrices and masked aggregation weights, never by dynamic
shapes. The "checkpoint" contract of the reference (basic LF written to disk
between the two steps, SURVEY.md §5.4) lives in the CLI driver; here the basic
estimate is simply the HT step's output array.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from lfbm5d_tpu.config import DenoiseParams, StepParams
from lfbm5d_tpu.lf.color import channel_sigma_scales, rgb_to_space, space_to_rgb
from lfbm5d_tpu.lf.pad import ind_initialize, pad_lf, ref_sai_grid
from lfbm5d_tpu.ops.distances import (
    center_index,
    cross_argmin,
    displacements,
    self_distances,
)
from lfbm5d_tpu.ops.flat import fallback_shrink_2d, flat_ref_mask
from lfbm5d_tpu.ops.match import select_similar
from lfbm5d_tpu.ops.shrinkage import ht_shrink, sd_weight, wiener_shrink
from lfbm5d_tpu.transforms import matrices as tm
from lfbm5d_tpu.transforms.apply import GroupTransforms, forward_5d, inverse_5d


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@lru_cache(maxsize=None)
def _build_step(
    sp: StepParams,
    lambda_3d: float,
    a_h: int,
    a_w: int,
    h: int,
    w: int,
    c: int,
    chunk: int,
    wiener: bool,
    dtype: str = "float32",
):
    """Build one filtering step for a fixed geometry and parameter block.

    Returns the raw (unjitted, composable) fn(noisy_p, match_p, sigma_c,
    basic_p) -> (num, den), operating on flattened-SAI padded arrays
    [A, Hp, Wp, C]. Use `_build_step_jit` for a standalone jitted version.
    """
    k, n, nd, n_sim, pad = sp.k, sp.n_search, sp.n_disp, sp.n_sim, sp.pad
    a = a_h * a_w
    ys = ind_initialize(h, k, sp.p) + pad
    xs = ind_initialize(w, k, sp.p) + pad
    t = len(ys) * len(xs)
    chunk = min(chunk, t)
    n_chunks = _cdiv(t, chunk)
    t_pad = n_chunks * chunk

    dt = jnp.dtype(dtype)
    pos_y = jnp.asarray(np.repeat(ys, len(xs)).astype(np.int32))
    pos_x = jnp.asarray(np.tile(xs, len(ys)).astype(np.int32))
    disp_self = jnp.asarray(displacements(n))
    disp_ang = jnp.asarray(displacements(nd))
    c_ang = center_index(nd)
    kaiser = jnp.asarray(tm.kaiser_window(k), dtype=dt)
    gt = GroupTransforms.build(sp, a_h, a_w, dtype=dt)
    ku = jnp.arange(k)[:, None]
    kv = jnp.arange(k)[None, :]
    a_b = jnp.arange(a)[None, None, :, None, None]

    def step(noisy_p, match_p, sigma_c, basic_p):
        match0 = match_p[..., 0]  # [A, Hp, Wp]
        fmask = None
        if sp.flat_tau > 0:
            # angular-redundancy mask (ops/flat.py): redundant positions
            # build no group; den==0 pixels take the angular-mean fallback
            # at finalize. Computed on the NOISY LF in both steps (the
            # basic estimate's residual noise is far below sigma, which
            # breaks the threshold's anchor — see ops/flat.py).
            fmask = flat_ref_mask(noisy_p[..., 0], ys, xs, k, sp.flat_tau,
                                  sigma_c[0])

        def ref_pass(carry, r):
            num, den = carry
            ref0 = match0[r]
            d_self = self_distances(ref0, ys, xs, k, n)  # [T, Ds]
            order, lvl, mask = select_similar(d_self, n, sp.tau_match, n_sim)
            if sp.flat_tau > 0:
                mask = mask & ~fmask[:, None]
            off = disp_self[order]  # [T, N, 2]
            sim_y = pos_y[:, None] + off[..., 0]
            sim_x = pos_x[:, None] + off[..., 1]

            def per_a(_, ai):
                bidx = cross_argmin(ref0, match0[ai], k, nd)
                return _, bidx[sim_y, sim_x]  # [T, N]

            _, ang = lax.scan(per_a, 0, jnp.arange(a))  # [A, T, N]
            # the reference SAI's angular match is the similar patch itself
            ang = jnp.where((jnp.arange(a) == r)[:, None, None], c_ang, ang)
            ang = jnp.transpose(ang, (1, 2, 0))  # [T, N, A]

            pt = t_pad - t
            if pt:
                sim_y = jnp.pad(sim_y, ((0, pt), (0, 0)), constant_values=pad)
                sim_x = jnp.pad(sim_x, ((0, pt), (0, 0)), constant_values=pad)
                lvl_p = jnp.pad(lvl, (0, pt))
                mask_p = jnp.pad(mask, ((0, pt), (0, 0)))  # False: zero weight
                ang = jnp.pad(
                    ang, ((0, pt), (0, 0), (0, 0)), constant_values=c_ang
                )
            else:
                lvl_p, mask_p = lvl, mask

            def chunk_body(i, nd_acc):
                num, den = nd_acc
                s0 = i * chunk
                cy = lax.dynamic_slice_in_dim(sim_y, s0, chunk, 0)
                cx = lax.dynamic_slice_in_dim(sim_x, s0, chunk, 0)
                clvl = lax.dynamic_slice_in_dim(lvl_p, s0, chunk, 0)
                cmask = lax.dynamic_slice_in_dim(mask_p, s0, chunk, 0)
                cang = lax.dynamic_slice_in_dim(ang, s0, chunk, 0)
                aoff = disp_ang[cang]  # [Tc, N, A, 2]
                ay = cy[:, :, None] + aoff[..., 0]
                ax = cx[:, :, None] + aoff[..., 1]
                yy = ay[..., None, None] + ku  # [Tc, N, A, k, 1]
                xx = ax[..., None, None] + kv  # [Tc, N, A, 1, k]

                grp = noisy_p[a_b, yy, xx]  # [Tc, N, A, k, k, C]
                g = grp.reshape(chunk, n_sim, a_h, a_w, k, k, c)
                spec = forward_5d(g, clvl, gt)
                if wiener:
                    gb = basic_p[a_b, yy, xx].reshape(
                        chunk, n_sim, a_h, a_w, k, k, c
                    )
                    spec_b = forward_5d(gb, clvl, gt)
                    filt, wgt = wiener_shrink(spec, spec_b, sigma_c)
                else:
                    filt, wgt = ht_shrink(spec, sigma_c, lambda_3d)
                est = inverse_5d(filt, clvl, gt)
                if sp.use_sd:
                    wgt = sd_weight(est, clvl, a, k)
                est = est.reshape(chunk, n_sim, a, k, k, c)

                wfull = (
                    wgt[:, None, None, None, None, :]
                    * cmask[:, :, None, None, None, None]
                    * kaiser[None, None, None, :, :, None]
                )  # [Tc, N, 1, k, k, C]
                num = num.at[a_b, yy, xx].add(est * wfull)
                den = den.at[a_b, yy, xx].add(
                    jnp.broadcast_to(wfull, est.shape)
                )
                return num, den

            num, den = lax.fori_loop(0, n_chunks, chunk_body, (num, den))
            return (num, den), None

        init = (jnp.zeros_like(noisy_p), jnp.zeros_like(noisy_p))
        (num, den), _ = lax.scan(
            ref_pass, init, jnp.asarray(ref_sai_grid(a_h, a_w, sp.p_ang))
        )
        return num, den

    return step


@lru_cache(maxsize=None)
def _build_step_jit(*key):
    step = _build_step(*key)
    wiener = key[8]
    if wiener:
        return jax.jit(step)
    return jax.jit(lambda np_, mp_, sc_: step(np_, mp_, sc_, None))


def _finalize(num, den, pad: int, a_h: int, a_w: int, h: int, w: int, c: int,
              fb=None):
    est = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)
    est = est.reshape(a_h, a_w, *est.shape[1:])
    est = est[:, :, pad : pad + h, pad : pad + w, :]
    if fb is not None:
        # flat-region fallback (StepParams.flat_tau): pixels no group
        # covered take the per-SAI 2D estimate
        deni = den.reshape(a_h, a_w, *den.shape[1:])
        deni = deni[:, :, pad : pad + h, pad : pad + w, :]
        est = jnp.where(deni > 0, est, fb)
    return est


def _flat_fallback(x, sigma_c, sp: StepParams, lambda_3d: float, dt,
                   pilot=None):
    """Per-SAI 2D fallback estimate for flat_tau > 0 steps (None if off).

    x: [aH, aW, H, W, C] color-transformed LF; pilot: basic estimate for
    the Wiener form. See ops/flat.py for the spec.
    """
    if sp.flat_tau <= 0:
        return None
    f2, i2 = tm.transform_pair(sp.tau_2d, sp.k)
    return fallback_shrink_2d(
        x, sigma_c.astype(dt), jnp.asarray(f2, dt), jnp.asarray(i2, dt),
        lambda_3d, pilot,
    )


def _flat_pad(x, pad: int):
    """[aH, aW, H, W, C] -> padded, flattened to [A, Hp, Wp, C]."""
    xp = pad_lf(x, pad)
    return xp.reshape(-1, *xp.shape[2:])


def _sigma_channels(sigma: float, color_space: str, c: int, dtype: str):
    scales = channel_sigma_scales(color_space)[:c] if c == 3 else np.ones((c,))
    return jnp.asarray(sigma * scales, dtype=jnp.dtype(dtype))


def ht_step(x, sigma: float, sp: StepParams, lambda_3d: float = 2.7,
            color_space: str = "rgb", chunk: int = 256, dtype: str = "float32"):
    """HT step on an already-color-transformed LF [aH,aW,H,W,C] -> basic."""
    a_h, a_w, h, w, c = x.shape
    x = jnp.asarray(x, jnp.dtype(dtype))
    fn = _build_step_jit(sp, lambda_3d, a_h, a_w, h, w, c, chunk, False, dtype)
    xp = _flat_pad(x, sp.pad)
    sigma_c = _sigma_channels(sigma, color_space, c, dtype)
    num, den = fn(xp, xp, sigma_c)
    fb = _flat_fallback(x, sigma_c, sp, lambda_3d, jnp.dtype(dtype))
    return _finalize(num, den, sp.pad, a_h, a_w, h, w, c, fb)


def wiener_step(x, basic, sigma: float, sp: StepParams,
                color_space: str = "rgb", chunk: int = 256,
                dtype: str = "float32"):
    """Wiener step: BM on `basic`, shrinkage of `x` guided by `basic`."""
    a_h, a_w, h, w, c = x.shape
    x = jnp.asarray(x, jnp.dtype(dtype))
    basic = jnp.asarray(basic, jnp.dtype(dtype))
    fn = _build_step_jit(sp, 0.0, a_h, a_w, h, w, c, chunk, True, dtype)
    xp = _flat_pad(x, sp.pad)
    bp = _flat_pad(basic, sp.pad)
    sigma_c = _sigma_channels(sigma, color_space, c, dtype)
    mp = xp if sp.bm_source == "noisy" else bp
    num, den = fn(xp, mp, sigma_c, bp)
    fb = _flat_fallback(x, sigma_c, sp, 0.0, jnp.dtype(dtype), pilot=basic)
    return _finalize(num, den, sp.pad, a_h, a_w, h, w, c, fb)


@lru_cache(maxsize=None)
def build_denoise_fn(
    params: DenoiseParams,
    a_h: int,
    a_w: int,
    h: int,
    w: int,
    c: int,
    dtype: str = "float32",
):
    """Compose the FULL per-LF pipeline (color -> HT -> Wiener -> inverse
    color) into one raw jittable function fn(lf, sigma_c) -> (basic, final).

    This single function is what jit/vmap/shard_map consume: one compilation
    covers the whole two-step pipeline, and the streaming path maps it over a
    batch of light fields (SURVEY.md §5.8).
    """
    dt = jnp.dtype(dtype)
    ht_raw = _build_step(
        params.ht, params.lambda_3d, a_h, a_w, h, w, c, params.chunk, False,
        dtype,
    )
    wn_raw = _build_step(
        params.wiener, 0.0, a_h, a_w, h, w, c, params.chunk, True, dtype,
    )
    use_color = c == 3 and params.color_space != "rgb"

    def fn(lf, sigma_c):
        x = jnp.asarray(lf, dt)
        if use_color:
            x = rgb_to_space(x, params.color_space)
        xp = _flat_pad(x, params.ht.pad)
        num, den = ht_raw(xp, xp, sigma_c, None)
        fb = _flat_fallback(x, sigma_c, params.ht, params.lambda_3d, dt)
        basic = _finalize(num, den, params.ht.pad, a_h, a_w, h, w, c, fb)
        xp2 = _flat_pad(x, params.wiener.pad)
        bp = _flat_pad(basic, params.wiener.pad)
        mp = xp2 if params.wiener.bm_source == "noisy" else bp
        num, den = wn_raw(xp2, mp, sigma_c, bp)
        fb = _flat_fallback(x, sigma_c, params.wiener, 0.0, dt, pilot=basic)
        final = _finalize(num, den, params.wiener.pad, a_h, a_w, h, w, c, fb)
        if use_color:
            basic = space_to_rgb(basic, params.color_space)
            final = space_to_rgb(final, params.color_space)
        return basic, final

    return fn


@lru_cache(maxsize=None)
def _build_denoise_jit(params, a_h, a_w, h, w, c, dtype):
    return jax.jit(build_denoise_fn(params, a_h, a_w, h, w, c, dtype))


def run_bm5d(noisy_lf, params: DenoiseParams, dtype: str = "float32",
             sigma_c=None):
    """Full two-step pipeline. noisy_lf: [aH,aW,H,W,C] RGB/gray in [0,255].

    Returns (basic, final) jnp arrays in the input color space.

    sigma_c optionally overrides the per-channel noise stds as a TRACED
    array (shape [C]); params.sigma is then ignored at runtime and the jit
    caches key only on params — this is how run_sr sweeps its sigma
    schedule through ONE compilation per geometry.
    """
    # device arrays stay on the device (np.asarray would copy them back to
    # the host and up again)
    if isinstance(noisy_lf, jax.Array):
        lf = noisy_lf.astype(jnp.dtype(dtype))
    else:
        lf = jnp.asarray(np.asarray(noisy_lf), jnp.dtype(dtype))
    a_h, a_w, h, w, c = lf.shape
    fn = _build_denoise_jit(params, a_h, a_w, h, w, c, dtype)
    if sigma_c is None:
        sigma_c = _sigma_channels(params.sigma, params.color_space, c, dtype)
    return fn(lf, sigma_c)
