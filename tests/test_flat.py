"""Flat-region fallback (StepParams.flat_tau, ops/flat.py).

Reference-grid positions whose angular-redundancy statistic says "all views
already agree" build no weighted group; pixels no group covers take the angular-mean blockwise
2D fallback at finalize. Spec in ops/flat.py; the float64 oracle
implements it literally.
"""

import numpy as np
import pytest

from lfbm5d_tpu.config import DenoiseParams, StepParams
from lfbm5d_tpu.lf import psnr, synthetic_lf
from lfbm5d_tpu.lf.noise import add_noise_np
from lfbm5d_tpu.pipeline import run_bm5d

SP = dict(n_sim=4, n_search=4, n_disp=1, p=4)
FLAT_TAU = 1.15


def params(flat_tau, sigma=20.0):
    return DenoiseParams(
        sigma=sigma, color_space="rgb",
        ht=StepParams(tau_match=2500.0, flat_tau=flat_tau, **SP),
        wiener=StepParams(tau_match=400.0, flat_tau=flat_tau, **SP),
    )


@pytest.fixture(scope="module")
def flat_lf():
    # moving background (disp 1): only the genuinely FLAT half is
    # angular-redundant; the textured half carries disparity and must
    # stay on the 5D path
    clean = synthetic_lf(2, 2, 32, 48, 1, disp_bg=1, disp_fg=2, seed=3,
                         flat_frac=0.5)
    return clean, add_noise_np(clean, 20.0, seed=1)


@pytest.mark.slow
def test_flat_fallback_oracle_exact(flat_lf):
    """f64: oracle == the jitted pipeline with flat_tau on."""
    from lfbm5d_tpu.oracle import oracle_denoise

    clean, noisy = flat_lf
    p = params(flat_tau=FLAT_TAU)
    ob, of = oracle_denoise(noisy, p)
    bx, fx = run_bm5d(noisy, p, dtype="float64")
    assert np.abs(ob - np.asarray(bx)).max() < 1e-9
    assert np.abs(of - np.asarray(fx)).max() < 1e-9
    # the fallback path was actually exercised (flat half skipped) ...
    of0 = np.asarray(run_bm5d(noisy, params(0.0), dtype="float64")[1])
    assert np.abs(of0 - of).max() > 1e-3
    # ... and quality holds up. At this tiny 2x2 grid the angular mean
    # averages only A=4 views (residual sigma/2), so the fallback gives up
    # ~0.3 dB to the full 5D path; at the flagship A=81 (sigma/9) it
    # measured at-or-above the 5D path in redundant zones.
    q0 = psnr(np.clip(of0, 0, 255), clean)
    q1 = psnr(np.clip(of, 0, 255), clean)
    assert q1 > q0 - 0.5


def test_flat_tau_inert_on_textured_content():
    """No patch classified flat => bit-identical to flat_tau=0."""
    clean = synthetic_lf(2, 2, 32, 48, 1, disp_bg=0, disp_fg=1, seed=5)
    noisy = add_noise_np(clean, 20.0, seed=2)
    # textured everywhere at sigma=20: variance >> 0.2 * sigma^2
    f0 = np.asarray(run_bm5d(noisy, params(0.0), dtype="float64")[1])
    f1 = np.asarray(run_bm5d(noisy, params(0.2), dtype="float64")[1])
    assert np.array_equal(f0, f1)


def test_flat_ref_mask_matches_literal_deviation():
    """Engine mask == literal numpy angular-deviation classification."""
    import jax.numpy as jnp

    from lfbm5d_tpu.ops.distances import DIST_QUANT
    from lfbm5d_tpu.ops.flat import flat_ref_mask

    rng = np.random.default_rng(0)
    k, tau, sigma0 = 8, 1.15, 20.0
    # 5 views: a flat stripe (view-invariant up to noise) + shifting texture
    base = rng.random((40, 64)) * 255.0
    planes = np.stack([np.roll(base, s, axis=1) for s in range(-2, 3)])
    planes[:, :, :24] = 117.0
    planes += rng.normal(0, sigma0, planes.shape)
    ys = np.asarray([0, 7, 18, 32], np.int64)
    xs = np.asarray([0, 9, 24, 40, 48], np.int64)
    got = np.asarray(
        flat_ref_mask(jnp.asarray(planes), ys, xs, k, tau,
                      jnp.asarray(sigma0))
    ).reshape(len(ys), len(xs))
    a = planes.shape[0]
    thr_q = np.round(tau * sigma0 * sigma0 * ((a - 1) / a) * DIST_QUANT)
    m = planes.mean(axis=0)
    for i, y in enumerate(ys):
        for j, x in enumerate(xs):
            d = np.mean(
                (planes[:, y:y + k, x:x + k] - m[None, y:y + k, x:x + k])
                ** 2
            )
            assert got[i, j] == (np.round(d * DIST_QUANT) <= thr_q)
    # the flat stripe is classified redundant, the shifting texture is not
    assert got[:, :2].all() and not got[:, 3:].any()


def test_fallback_shrink_parity_and_quality():
    """jax fallback == oracle fallback; recovers a flat noisy LF."""
    import jax.numpy as jnp

    from lfbm5d_tpu.oracle.oracle import _oracle_fallback_2d
    from lfbm5d_tpu.ops.flat import fallback_shrink_2d
    from lfbm5d_tpu.transforms import matrices as tm

    sp = StepParams(tau_match=2500.0, **SP)
    clean = np.full((3, 3, 30, 41, 1), 128.0)
    noisy = add_noise_np(clean, 20.0, seed=4)
    sig = np.asarray([20.0])
    want = _oracle_fallback_2d(noisy, sig, sp, 2.7)
    f2, i2 = tm.transform_pair(sp.tau_2d, sp.k)
    got = np.asarray(fallback_shrink_2d(
        jnp.asarray(noisy), jnp.asarray(sig), jnp.asarray(f2),
        jnp.asarray(i2), 2.7,
    ))
    assert np.abs(want - got).max() < 1e-9
    assert psnr(np.clip(got, 0, 255), clean) > psnr(np.clip(noisy, 0, 255),
                                                    clean) + 10.0
    # Wiener form with the HT fallback as pilot
    want_w = _oracle_fallback_2d(noisy, sig, sp, 0.0, pilot=want)
    got_w = np.asarray(fallback_shrink_2d(
        jnp.asarray(noisy), jnp.asarray(sig), jnp.asarray(f2),
        jnp.asarray(i2), 0.0, pilot=jnp.asarray(got),
    ))
    assert np.abs(want_w - got_w).max() < 1e-9
