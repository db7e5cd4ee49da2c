"""Float64 NumPy oracle: a literal implementation of SURVEY.md §2.10.

This module is the correctness anchor for the jitted pipeline (SURVEY.md §4.2.1):
the reference mount was empty (§0), so output fidelity is defined by this
oracle, which implements the published LFBM5D algorithm patch-at-a-time, the
way the C++ reference does — per-reference-patch Python loop, stable-sorted
block matching, first-occurrence argmin disparity search, explicit group
build, separable 5D transform, HT/Wiener shrinkage, Kaiser-weighted
scatter-add aggregation.

Deliberately slow and simple. Use tiny light fields only.

Conventions shared with the jitted path (documented spec choices, §2.10):
  * BM distances on channel 0 only, SSD normalized by k^2 ([0,255]^2 units).
  * Self-BM candidate order: sort by (distance, is-not-self, row-major window
    index) — the reference patch always ranks first among ties, which
    guarantees every pixel of every SAI receives aggregation coverage;
    candidates with distance > tau_match dropped; stack truncated to the
    largest power of two <= min(count, N).
  * Angular BM: first-occurrence argmin over the row-major (2*nDisp+1)^2
    window, centered at the similar patch's position, one best match per SAI;
    the reference SAI contributes the similar patch itself.
  * Wiener step re-runs both BM stages on the basic estimate.
  * Padding: every SAI symmetrically reflected by n_search + n_disp.
  * HT threshold lambda*sigma_c applied to ALL coefficients of the 5D
    spectrum; survivor count N_nz per channel; aggregation weight
    1/(sigma_c^2 * max(N_nz, 1)), or the SD weight if use_sd.
  * Wiener: w = B^2/(B^2 + sigma_c^2) on basic coefficients B, applied to the
    noisy spectrum; weight 1/(sigma_c^2 * sum(w^2)) per channel.
  * Aggregation modulated by the k x k Kaiser(beta=2) window; numerator and
    denominator accumulated per SAI per channel; output = num/den.
"""

from __future__ import annotations

import numpy as np

from lfbm5d_tpu.config import DenoiseParams, StepParams
from lfbm5d_tpu.lf.color import channel_sigma_scales, rgb_to_space, space_to_rgb
from lfbm5d_tpu.lf.pad import ind_initialize, pad_lf, ref_sai_grid
from lfbm5d_tpu.ops.distances import DIST_QUANT
from lfbm5d_tpu.transforms import matrices as tm


def _pow2_floor(x: int) -> int:
    return 1 << (x.bit_length() - 1)


def _transform_mats(sp: StepParams, a_h: int, a_w: int):
    f2, i2 = tm.transform_pair(sp.tau_2d, sp.k)
    f4s, i4s = tm.transform_pair(sp.tau_4d if sp.tau_4d != "id" else "id", a_h)
    f4t, i4t = tm.transform_pair(sp.tau_4d if sp.tau_4d != "id" else "id", a_w)
    return f2, i2, f4s, i4s, f4t, i4t


def _forward(group: np.ndarray, mats, sp: StepParams) -> np.ndarray:
    """group: [n_g, aH, aW, k, k, C] -> 5D spectrum (same shape)."""
    f2, _, f4s, _, f4t, _ = mats
    g = np.einsum("uq,nstqvc->nstuvc", f2, group)
    g = np.einsum("vq,nstuqc->nstuvc", f2, g)
    if sp.tau_4d != "id":
        g = np.einsum("sq,nqtuvc->nstuvc", f4s, g)
        g = np.einsum("tq,nsquvc->nstuvc", f4t, g)
    n_g = g.shape[0]
    f5, _ = tm.transform_pair(sp.tau_5d if n_g > 1 else "id", n_g)
    g = np.einsum("nq,qstuvc->nstuvc", f5, g)
    return g


def _inverse(g: np.ndarray, mats, sp: StepParams) -> np.ndarray:
    _, i2, _, i4s, _, i4t = mats
    n_g = g.shape[0]
    _, i5 = tm.transform_pair(sp.tau_5d if n_g > 1 else "id", n_g)
    g = np.einsum("nq,qstuvc->nstuvc", i5, g)
    if sp.tau_4d != "id":
        g = np.einsum("sq,nqtuvc->nstuvc", i4s, g)
        g = np.einsum("tq,nsquvc->nstuvc", i4t, g)
    g = np.einsum("uq,nstqvc->nstuvc", i2, g)
    g = np.einsum("vq,nstuqc->nstuvc", i2, g)
    return g


def oracle_block_match(match_p: np.ndarray, r_s: int, r_t: int, y: int, x: int,
                       sp: StepParams):
    """Block matching for one reference patch at padded coords (y, x).

    match_p: padded LF [aH, aW, Hp, Wp, C]; BM on channel 0.
    Returns (sim_pos [n_g, 2], ang_pos [n_g, aH, aW, 2]) in padded coords.
    """
    k, n, nd = sp.k, sp.n_search, sp.n_disp
    a_h, a_w = match_p.shape[:2]
    ref_plane = match_p[r_s, r_t, :, :, 0]
    p_ref = ref_plane[y : y + k, x : x + k]

    # --- self-similarity BM over the (2n+1)^2 window, row-major candidates.
    # Distances are quantized to 1/DIST_QUANT units (round-half-even) so that
    # mirror-padding permutation ties resolve identically across
    # implementations — see lfbm5d_tpu/ops/distances.py.
    dists = np.empty(((2 * n + 1) ** 2,), dtype=np.int64)
    cand_pos = np.empty(((2 * n + 1) ** 2, 2), dtype=np.int64)
    idx = 0
    for dy in range(-n, n + 1):
        for dx in range(-n, n + 1):
            q = ref_plane[y + dy : y + dy + k, x + dx : x + dx + k]
            dists[idx] = np.round(np.sum((p_ref - q) ** 2) * (DIST_QUANT / (k * k)))
            cand_pos[idx] = (y + dy, x + dx)
            idx += 1
    # Tie-break: self candidate (window center) first, then row-major index.
    tie = np.arange(dists.shape[0], dtype=np.int64)
    self_idx = n * (2 * n + 1) + n
    tie[self_idx] = -1
    order = np.lexsort((tie, dists))
    valid = dists[order] <= round(sp.tau_match * DIST_QUANT)
    count = int(valid.sum())
    n_g = _pow2_floor(max(1, min(count, sp.n_sim)))
    sim_pos = cand_pos[order[:n_g]]

    # --- angular BM: per similar patch, best match in every SAI
    ang_pos = np.empty((n_g, a_h, a_w, 2), dtype=np.int64)
    for j in range(n_g):
        yj, xj = sim_pos[j]
        p_sim = ref_plane[yj : yj + k, xj : xj + k]
        for s in range(a_h):
            for t in range(a_w):
                if s == r_s and t == r_t:
                    ang_pos[j, s, t] = (yj, xj)
                    continue
                plane = match_p[s, t, :, :, 0]
                best_d = np.inf
                best = (yj, xj)
                for dy in range(-nd, nd + 1):
                    for dx in range(-nd, nd + 1):
                        q = plane[yj + dy : yj + dy + k, xj + dx : xj + dx + k]
                        d = np.round(
                            np.sum((p_sim - q) ** 2) * (DIST_QUANT / (k * k))
                        )
                        if d < best_d:
                            best_d = d
                            best = (yj + dy, xj + dx)
                ang_pos[j, s, t] = best
    return sim_pos, ang_pos


def _gather(padded: np.ndarray, ang_pos: np.ndarray, k: int) -> np.ndarray:
    """[n_g, aH, aW, k, k, C] group from padded LF and angular positions."""
    n_g, a_h, a_w = ang_pos.shape[:3]
    c = padded.shape[-1]
    g = np.empty((n_g, a_h, a_w, k, k, c), dtype=np.float64)
    for j in range(n_g):
        for s in range(a_h):
            for t in range(a_w):
                yy, xx = ang_pos[j, s, t]
                g[j, s, t] = padded[s, t, yy : yy + k, xx : xx + k, :]
    return g


def _sd_weight(filtered: np.ndarray) -> np.ndarray:
    """Per-channel SD aggregation weight from the filtered group (spec choice)."""
    c = filtered.shape[-1]
    w = np.empty((c,), dtype=np.float64)
    for ci in range(c):
        v = filtered[..., ci]
        std = v.std()
        w[ci] = 1.0 / (std * std) if std > 0 else 1.0
    return w


def _oracle_step(
    noisy_p: np.ndarray,
    match_p: np.ndarray,
    sigma_c: np.ndarray,
    sp: StepParams,
    lambda_3d: float,
    basic_p: np.ndarray | None,
):
    """One filtering step over all reference SAIs.

    noisy_p: padded noisy LF (shrinkage input), match_p: padded LF BM runs on
    (== noisy_p for HT, == basic for Wiener), basic_p: padded basic estimate
    (Wiener only). Returns (num, den) padded accumulators.
    """
    a_h, a_w, hp, wp, c = noisy_p.shape
    k, pad = sp.k, sp.pad
    h, w = hp - 2 * pad, wp - 2 * pad
    ys = ind_initialize(h, k, sp.p) + pad
    xs = ind_initialize(w, k, sp.p) + pad
    kaiser = tm.kaiser_window(k)[..., None]  # [k, k, 1]
    mats = _transform_mats(sp, a_h, a_w)
    thr = lambda_3d * sigma_c  # [C]

    num = np.zeros_like(noisy_p)
    den = np.zeros_like(noisy_p)

    # flat-region fallback (StepParams.flat_tau): positions whose quantized
    # angular-redundancy statistic D (mean squared deviation of every view
    # from the angular mean over the k x k patch, channel 0 of the BM
    # image) is <= flat_tau * sigma0^2 build no group; den==0 pixels take
    # the angular-mean 2D fallback at finalize. Spec in ops/flat.py.
    flat_grid = None
    if sp.flat_tau > 0:
        a = a_h * a_w
        thr_q = np.round(
            sp.flat_tau * sigma_c[0] ** 2 * ((a - 1) / a) * DIST_QUANT
        )
        # on the NOISY LF in both steps (ops/flat.py: the basic estimate's
        # residual noise is far below sigma, breaking the threshold anchor)
        m0 = noisy_p[..., 0].reshape(a_h * a_w, hp, wp)
        mean0 = m0.mean(axis=0)
        flat_grid = {}
        for y in ys:
            for x in xs:
                d = np.mean(
                    (m0[:, y : y + k, x : x + k]
                     - mean0[None, y : y + k, x : x + k]) ** 2
                )
                flat_grid[(int(y), int(x))] = (
                    np.round(d * DIST_QUANT) <= thr_q
                )

    # p_ang subsamples which SAIs serve as reference (strided + flush,
    # config.StepParams.p_ang); groups still aggregate into all SAIs.
    for r_flat in ref_sai_grid(a_h, a_w, sp.p_ang):
        r_s, r_t = divmod(int(r_flat), a_w)
        for y in ys:
            for x in xs:
                if flat_grid is not None and flat_grid[(int(y), int(x))]:
                    continue
                sim_pos, ang_pos = oracle_block_match(
                    match_p, r_s, r_t, int(y), int(x), sp
                )
                g = _gather(noisy_p, ang_pos, k)
                spec = _forward(g, mats, sp)
                if basic_p is None:
                    keep = np.abs(spec) >= thr
                    filt = spec * keep
                    nnz = keep.sum(axis=(0, 1, 2, 3, 4))  # per channel
                    weight = 1.0 / (sigma_c**2 * np.maximum(nnz, 1))
                    weight = np.where(nnz > 0, weight, 1.0)
                else:
                    gb = _gather(basic_p, ang_pos, k)
                    spec_b = _forward(gb, mats, sp)
                    wien = spec_b**2 / (spec_b**2 + sigma_c**2)
                    filt = spec * wien
                    wsum = (wien**2).sum(axis=(0, 1, 2, 3, 4))
                    weight = np.where(
                        wsum > 0,
                        1.0 / (sigma_c**2 * np.maximum(wsum, 1e-30)),
                        1.0,
                    )
                est = _inverse(filt, mats, sp)
                if sp.use_sd:
                    weight = _sd_weight(est)
                wk = weight[None, None, :] * kaiser  # [k, k, C]
                for j in range(est.shape[0]):
                    for s in range(a_h):
                        for t in range(a_w):
                            yy, xx = ang_pos[j, s, t]
                            num[s, t, yy : yy + k, xx : xx + k, :] += (
                                wk * est[j, s, t]
                            )
                            den[s, t, yy : yy + k, xx : xx + k, :] += wk
    return num, den


def _oracle_fallback_2d(x, sigma_c, sp: StepParams, lambda_3d: float,
                        pilot=None):
    """Angular-mean k x k blockwise tau_2d shrinkage (mirrors ops.flat
    fallback_shrink_2d): average the LF over the angular axes (redundant
    means all views agree, so the mean is unbiased there and cuts noise by
    sqrt(A)), symmetric pad to k-multiples, non-overlapping blocks,
    empirical Wiener at sigma_c / sqrt(A) (step 1) or standard Wiener
    against the angular-mean pilot (step 2), broadcast back to every SAI.
    """
    f2, i2 = tm.transform_pair(sp.tau_2d, sp.k)
    k = sp.k
    a_h, a_w, h, w, _ = x.shape
    sig_m = np.asarray(sigma_c, np.float64) / np.sqrt(float(a_h * a_w))
    ph, pw = (-h) % k, (-w) % k

    def blockify(v):
        if ph or pw:
            v = np.pad(v, [(0, ph), (0, pw), (0, 0)], mode="symmetric")
        hp, wp, c = v.shape
        b = v.reshape(hp // k, k, wp // k, k, c)
        return np.moveaxis(b, -4, -3)

    xb = blockify(np.asarray(x, np.float64).mean(axis=(0, 1)))
    spec = np.einsum("uq,...qvc->...uvc", f2, xb)
    spec = np.einsum("vq,...uqc->...uvc", f2, spec)
    if pilot is None:
        # empirical Wiener against the mean's own spectrum (ops/flat.py)
        del lambda_3d
        s2 = sig_m**2
        b2 = np.maximum(spec**2 - s2, 0.0)
        filt = spec * (b2 / (b2 + s2))
    else:
        pb = blockify(np.asarray(pilot, np.float64).mean(axis=(0, 1)))
        sb = np.einsum("uq,...qvc->...uvc", f2, pb)
        sb = np.einsum("vq,...uqc->...uvc", f2, sb)
        filt = spec * (sb**2 / (sb**2 + sig_m**2))
    est = np.einsum("uq,...qvc->...uvc", i2, filt)
    est = np.einsum("vq,...uqc->...uvc", i2, est)
    est = np.moveaxis(est, -3, -4)
    est = est.reshape(est.shape[0] * k, est.shape[2] * k, est.shape[-1])
    est = est[:h, :w, :]
    return np.broadcast_to(est, (a_h, a_w, h, w, est.shape[-1]))


def _finalize(num, den, pad, fb=None):
    est = num / np.where(den > 0, den, 1.0)
    est = est[:, :, pad:-pad, pad:-pad, :]
    deni = den[:, :, pad:-pad, pad:-pad, :]
    return np.where(deni > 0, est, fb if fb is not None else 0.0)


def oracle_ht_step(noisy_lf: np.ndarray, sigma_c: np.ndarray, sp: StepParams,
                   lambda_3d: float = 2.7) -> np.ndarray:
    """Hard-threshold step on a color-transformed LF [aH,aW,H,W,C] -> basic."""
    x = np.asarray(noisy_lf, dtype=np.float64)
    noisy_p = pad_lf(x, sp.pad)
    num, den = _oracle_step(noisy_p, noisy_p, sigma_c, sp, lambda_3d, None)
    fb = (
        _oracle_fallback_2d(x, sigma_c, sp, lambda_3d)
        if sp.flat_tau > 0 else None
    )
    return _finalize(num, den, sp.pad, fb)


def oracle_wiener_step(noisy_lf: np.ndarray, basic_lf: np.ndarray,
                       sigma_c: np.ndarray, sp: StepParams) -> np.ndarray:
    """Wiener step: BM on basic, shrink noisy with basic-derived filter."""
    x = np.asarray(noisy_lf, dtype=np.float64)
    b = np.asarray(basic_lf, dtype=np.float64)
    noisy_p = pad_lf(x, sp.pad)
    basic_p = pad_lf(b, sp.pad)
    # bm_source='noisy' (config.StepParams): BM on the noisy LF instead of
    # the basic estimate — the cross-step BM-reuse semantics
    match_p = noisy_p if sp.bm_source == "noisy" else basic_p
    num, den = _oracle_step(noisy_p, match_p, sigma_c, sp, 0.0, basic_p)
    fb = (
        _oracle_fallback_2d(x, sigma_c, sp, 0.0, pilot=b)
        if sp.flat_tau > 0 else None
    )
    return _finalize(num, den, sp.pad, fb)


def oracle_denoise(noisy_lf: np.ndarray, params: DenoiseParams):
    """Full two-step pipeline. noisy_lf: [aH,aW,H,W,C] RGB (or gray) [0,255].

    Returns (basic, final) in the input color space.
    """
    x = rgb_to_space(np.asarray(noisy_lf, dtype=np.float64), params.color_space)
    c = x.shape[-1]
    scales = (
        channel_sigma_scales(params.color_space)[:c]
        if c == 3
        else np.ones((1,), dtype=np.float64)
    )
    sigma_c = params.sigma * scales
    basic = oracle_ht_step(x, sigma_c, params.ht, params.lambda_3d)
    final = oracle_wiener_step(x, basic, sigma_c, params.wiener)
    basic = space_to_rgb(basic, params.color_space)
    final = space_to_rgb(final, params.color_space)
    return basic, final


def oracle_sr(lr_lf: np.ndarray, params) -> np.ndarray:
    """Float64 reference of the SR pipeline (ICIP18, SURVEY.md §2.10 SR).

    Bicubic init, then n_iter rounds of [oracle LFBM5D filter at sigma_i,
    back-projection HR += gain * up(LR - down(HR))], sharing the EXACT
    resize operators of lfbm5d_tpu.lf.resize (evaluated in float64) so the
    only difference from pipeline.sr.run_sr is the filter arithmetic.
    params: lfbm5d_tpu.config.SRParams.
    """
    import jax
    import jax.numpy as jnp

    from lfbm5d_tpu.config import DenoiseParams
    from lfbm5d_tpu.lf.resize import downsample, upsample

    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "oracle_sr shares lf.resize's jax operators, which silently "
            "downcast to float32 unless x64 is on; enable it first with "
            'jax.config.update("jax_enable_x64", True) '
            "(tests/conftest.py already does)"
        )
    lr = np.asarray(lr_lf, dtype=np.float64)
    hr = np.asarray(upsample(jnp.asarray(lr), params.scale), dtype=np.float64)
    sigmas = np.linspace(params.sigma_init, params.sigma_final, params.n_iter)
    for sigma in sigmas:
        dp = DenoiseParams(
            sigma=float(sigma), lambda_3d=params.lambda_3d,
            color_space=params.color_space, ht=params.ht,
            wiener=params.wiener,
        )
        _, hr = oracle_denoise(hr, dp)
        hr = np.asarray(hr, dtype=np.float64)
        residual = lr - np.asarray(
            downsample(jnp.asarray(hr), params.scale, params.decimation_blur),
            dtype=np.float64,
        )
        hr = hr + params.bp_gain * np.asarray(
            upsample(jnp.asarray(residual), params.scale), dtype=np.float64
        )
    return hr
