"""Super-resolution pipeline tests (driver config 4)."""

import numpy as np
import pytest

from lfbm5d_tpu.config import SRParams, StepParams
from lfbm5d_tpu.lf import psnr, synthetic_lf
from lfbm5d_tpu.lf.resize import downsample, upsample
from lfbm5d_tpu.pipeline.sr import run_sr, sigma_schedule

TINY = dict(n_sim=8, n_search=4, n_disp=1, k=8, p=3)


def test_resize_roundtrip_consistency():
    lf = synthetic_lf(2, 2, 16, 16, channels=1, seed=0)
    import jax.numpy as jnp

    lfj = jnp.asarray(lf)
    up = upsample(lfj, 2)
    assert up.shape == (2, 2, 32, 32, 1)
    down = downsample(up, 2)
    # box-average of bicubic upsample approximately recovers the original
    assert np.abs(np.asarray(down) - lf).mean() < 2.0


def test_sigma_schedule_decreasing():
    p = SRParams(n_iter=5, sigma_init=12.0, sigma_final=2.0)
    s = sigma_schedule(p)
    assert s[0] == 12.0 and s[-1] == 2.0 and np.all(np.diff(s) < 0)


def test_sr_compiles_once_across_schedule():
    """The sigma schedule must not retrace: one compilation serves all
    iterations (sigma enters as a traced array argument only)."""
    import jax.numpy as jnp

    from lfbm5d_tpu.pipeline.denoise import _build_denoise_jit

    clean = synthetic_lf(2, 2, 24, 24, channels=1, disp_bg=1, seed=11)
    lr = np.asarray(downsample(jnp.asarray(clean), 2))
    params = SRParams(
        scale=2, n_iter=3, sigma_init=9.0, sigma_final=3.0,
        ht=StepParams(tau_match=2500.0, **TINY),
        wiener=StepParams(tau_match=400.0, **TINY), chunk=32,
    )
    before = _build_denoise_jit.cache_info().misses
    run_sr(lr, params)
    after = _build_denoise_jit.cache_info().misses
    assert after - before <= 1, (before, after)


def test_sr_routes_through_run_bm5d(monkeypatch):
    """Every SR iteration's filter must go through run_bm5d, with sigma
    passed as the traced sigma_c override following the schedule."""
    import jax.numpy as jnp

    import lfbm5d_tpu.pipeline.sr as sr_mod
    from lfbm5d_tpu.pipeline.denoise import run_bm5d

    calls = []

    def spy(lf, dn, dtype="float32", sigma_c=None):
        calls.append((dn, np.asarray(sigma_c)))
        return run_bm5d(lf, dn, dtype, sigma_c=sigma_c)

    monkeypatch.setattr(sr_mod, "run_bm5d", spy)
    clean = synthetic_lf(2, 2, 24, 24, channels=1, disp_bg=1, seed=3)
    lr = np.asarray(downsample(jnp.asarray(clean), 2))
    params = SRParams(
        scale=2, n_iter=3, sigma_init=9.0, sigma_final=3.0,
        ht=StepParams(tau_match=2500.0, **TINY),
        wiener=StepParams(tau_match=400.0, **TINY), chunk=32,
    )
    run_sr(lr, params)
    assert len(calls) == 3
    for (dn, sc), sig in zip(calls, sigma_schedule(params)):
        assert dn.sigma == 0.0  # jit key never varies with the schedule
        np.testing.assert_allclose(sc, [sig], rtol=1e-6)


def test_run_bm5d_sigma_c_override_matches_params_sigma():
    """run_bm5d(sigma_c=...) must reproduce run_bm5d with params.sigma set
    (same channel scaling), bitwise."""
    from lfbm5d_tpu.config import DenoiseParams
    from lfbm5d_tpu.lf.noise import add_noise_np
    from lfbm5d_tpu.pipeline.denoise import _sigma_channels, run_bm5d

    clean = synthetic_lf(2, 2, 24, 32, channels=3, disp_bg=1, seed=5)
    noisy = add_noise_np(clean, 12.0, seed=6)
    base = dict(ht=StepParams(tau_match=2500.0, **TINY),
                wiener=StepParams(tau_match=400.0, **TINY), chunk=32)
    p_ref = DenoiseParams(sigma=12.0, **base)
    p_zero = DenoiseParams(sigma=0.0, **base)
    sc = _sigma_channels(12.0, p_zero.color_space, 3, "float32")
    b1, f1 = run_bm5d(noisy, p_ref)
    b2, f2 = run_bm5d(noisy, p_zero, sigma_c=sc)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))


def test_sr_beats_bicubic():
    clean = synthetic_lf(2, 2, 32, 32, channels=1, disp_bg=1, disp_fg=2, seed=1)
    import jax.numpy as jnp

    lr = np.asarray(downsample(jnp.asarray(clean), 2))
    params = SRParams(
        scale=2,
        n_iter=3,
        sigma_init=8.0,
        sigma_final=2.0,
        ht=StepParams(tau_match=2500.0, **TINY),
        wiener=StepParams(tau_match=400.0, **TINY),
        chunk=64,
    )
    iters = []
    hr = run_sr(lr, params, on_iteration=lambda i, x: iters.append(i))
    assert iters == [0, 1, 2]
    hr = np.asarray(hr)
    assert hr.shape == clean.shape
    bicubic = np.asarray(upsample(jnp.asarray(lr), 2))
    p_bi = psnr(np.clip(bicubic, 0, 255), clean)
    p_sr = psnr(np.clip(hr, 0, 255), clean)
    assert p_sr > p_bi, (p_bi, p_sr)


@pytest.mark.slow
def test_sr_x3_and_x4_beat_bicubic():
    """Config 4 names x2/x4; x3 exercises the non-power-of-two path. Each
    scale must beat its plain bicubic init."""
    import jax.numpy as jnp

    clean = synthetic_lf(2, 2, 60, 60, channels=1, disp_bg=1, seed=5)
    for scale in (3, 4):
        lr = np.asarray(downsample(jnp.asarray(clean), scale))
        params = SRParams(
            scale=scale, n_iter=3, sigma_init=8.0, sigma_final=2.0,
            ht=StepParams(tau_match=2500.0, **TINY),
            wiener=StepParams(tau_match=400.0, **TINY), chunk=32,
        )
        hr = np.asarray(run_sr(lr, params))
        bic = np.asarray(upsample(jnp.asarray(lr), scale))
        p_sr = psnr(np.clip(hr, 0, 255), clean)
        p_bic = psnr(np.clip(bic, 0, 255), clean)
        assert hr.shape == clean.shape
        # x4 gains are structurally small on this smooth synthetic LF
        # (back-projection convergence caps at ~+0.28 dB regardless of
        # schedule — measured over 3 schedules); x3 gains are larger
        bar = 0.3 if scale == 3 else 0.2
        assert p_sr > p_bic + bar, (scale, p_sr, p_bic)


@pytest.mark.slow
def test_sr_decimation_blur_model():
    """When the true degradation includes a Gaussian pre-blur, the MATCHED
    anti-aliased IBP model must beat the plain box model (it measured
    +1.7 dB at 3x3x48x64);
    a no-op blur path would fail this margin."""
    import jax.numpy as jnp

    clean = synthetic_lf(3, 3, 48, 64, channels=1, disp_bg=1, disp_fg=2,
                         seed=6)
    lr = np.asarray(downsample(jnp.asarray(clean), 2, blur_sigma=0.8))
    base = SRParams(
        scale=2, n_iter=3, sigma_init=8.0, sigma_final=2.0,
        ht=StepParams(tau_match=2500.0, **TINY),
        wiener=StepParams(tau_match=400.0, **TINY), chunk=32,
    )
    hr_box = np.asarray(run_sr(lr, base))
    hr_blur = np.asarray(run_sr(lr, base.replace(decimation_blur=0.8)))
    p_box = psnr(np.clip(hr_box, 0, 255), clean)
    p_blur = psnr(np.clip(hr_blur, 0, 255), clean)
    assert p_blur > p_box + 0.5, (p_box, p_blur)


@pytest.mark.slow
def test_sr_pipeline_matches_oracle_f64():
    """run_sr in f64 == the float64 SR oracle (bit-near-exact): the SR loop
    is oracle_denoise + the shared resize operators, so parity pins the
    whole config-4 path, not just the denoiser."""
    import jax.numpy as jnp

    from lfbm5d_tpu.oracle.oracle import oracle_sr

    tiny = dict(n_sim=4, n_search=3, n_disp=1, k=8, p=4)
    clean = synthetic_lf(2, 2, 24, 24, channels=1, disp_bg=1, seed=9)
    lr = np.asarray(downsample(jnp.asarray(clean), 2))
    params = SRParams(
        scale=2, n_iter=2, sigma_init=6.0, sigma_final=2.0,
        ht=StepParams(tau_match=2500.0, **tiny),
        wiener=StepParams(tau_match=400.0, **tiny), chunk=32,
    )
    hr = np.asarray(run_sr(lr, params, dtype="float64"))
    hr_o = oracle_sr(lr, params)
    assert np.abs(hr - hr_o).max() < 1e-8
