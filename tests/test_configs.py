"""End-to-end coverage of the BASELINE.json driver configs (SURVEY.md §4.2.5).

Small-scale functional versions of the five configurations, exercising the
semantics each one adds (transform variants, 16-bit IO, color spaces, large
angular grids).
"""

import json

import numpy as np
import pytest

from lfbm5d_tpu.cli import main
from lfbm5d_tpu.config import DenoiseParams, StepParams
from lfbm5d_tpu.lf import load_lf, psnr, save_lf, synthetic_lf
from lfbm5d_tpu.lf.noise import add_noise_np
from lfbm5d_tpu.oracle import oracle_ht_step
from lfbm5d_tpu.pipeline import ht_step, run_bm5d

TINY = dict(n_sim=8, n_search=4, n_disp=1, k=8, p=3)


def test_config3_cli_16bit_bior_hadamard(tmp_path, capsys):
    """Config 3: bior1.5 spatial + angular DCT + Hadamard stack, 16-bit."""
    clean = synthetic_lf(2, 2, 20, 24, channels=3, seed=0)
    d = tmp_path / "lf16"
    save_lf(clean, str(d), "SAI_%02d_%02d.png", bit_depth=16)
    rc = main([
        "denoise", "--input", str(d), "--aheight", "2", "--awidth", "2",
        "--sigma-add", "20", "--bit-depth", "16",
        "--output", str(tmp_path / "out16"), "--json",
        "--ht-tau2d", "bior", "--ht-tau5d", "hadamard",
        "--wien-tau2d", "bior", "--wien-tau5d", "hadamard",
        "--ht-nsim", "8", "--ht-nsearch", "4", "--ht-ndisp", "1",
        "--wien-nsim", "8", "--wien-nsearch", "4", "--wien-ndisp", "1",
        "--chunk", "32",
    ])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["psnr_final_db"] > rep["psnr_noisy_db"] + 2.0
    out = load_lf(str(tmp_path / "out16"), "SAI_%02d_%02d.png", 2, 2)
    assert out.shape == clean.shape


@pytest.mark.parametrize("space", ["yuv", "ycbcr"])
def test_non_normalized_color_spaces(space):
    """Per-channel sigma scaling for non-unit-norm color matrices."""
    clean = synthetic_lf(2, 2, 18, 20, channels=3, seed=1)
    noisy = add_noise_np(clean, 25.0, seed=2)
    params = DenoiseParams(
        sigma=25.0, color_space=space,
        ht=StepParams(**TINY), wiener=StepParams(tau_match=400.0, **TINY),
        chunk=32,
    )
    _, final = run_bm5d(noisy, params)
    gain = psnr(np.clip(np.asarray(final), 0, 255), clean) - psnr(
        np.clip(noisy, 0, 255), clean
    )
    assert gain > 2.0, gain


def test_use_sd_weighting_matches_oracle():
    clean = synthetic_lf(2, 2, 20, 20, channels=1, seed=3)
    noisy = add_noise_np(clean, 20.0, seed=4)
    sp = StepParams(use_sd=True, **TINY)
    basic_o = oracle_ht_step(noisy, np.ones(1) * 20.0, sp, 2.7)
    basic_t = np.asarray(ht_step(noisy, 20.0, sp, 2.7, "rgb", 32, "float64"))
    np.testing.assert_allclose(basic_o, basic_t, atol=1e-8)


def test_resolve_engine_is_backend_based():
    """One engine on every backend: the whole pipeline lowers to plain XLA
    ops (no custom call ties it to one accelerator), and no entry point
    takes an option to pick another."""
    import inspect

    import jax
    import jax.numpy as jnp

    from lfbm5d_tpu.models import LFDenoiser, LFSuperResolver
    from lfbm5d_tpu.pipeline import wiener_step
    from lfbm5d_tpu.pipeline.adaptive import denoise_region_adaptive
    from lfbm5d_tpu.pipeline.denoise import build_denoise_fn
    from lfbm5d_tpu.pipeline.sr import run_sr
    from lfbm5d_tpu.pipeline.stream_io import stream_denoise_dirs
    from lfbm5d_tpu.pipeline.streaming import denoise_batch

    p = DenoiseParams(sigma=20.0, ht=StepParams(**TINY),
                      wiener=StepParams(tau_match=400.0, **TINY), chunk=16)
    fn = build_denoise_fn(p, 2, 2, 16, 16, 3)
    text = jax.jit(fn).lower(jnp.zeros((2, 2, 16, 16, 3), jnp.float32),
                             jnp.ones((3,), jnp.float32)).as_text()
    assert "custom_call" not in text
    for f in (run_bm5d, ht_step, wiener_step, build_denoise_fn, run_sr,
              denoise_batch, stream_denoise_dirs, denoise_region_adaptive,
              LFDenoiser, LFSuperResolver):
        assert "engine" not in inspect.signature(f).parameters, f


def test_preset_merge_explicit_flag_wins():
    """An explicit step flag overrides the preset even when its value equals
    the documented default (regression: 'fast' preset silently forced p=6
    over an explicit --ht-p 3)."""
    import argparse

    from lfbm5d_tpu.cli import _step_args, _step_params

    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="fast")
    _step_args(ap, "ht", 2500.0)
    ns = ap.parse_args(["--ht-p", "3"])
    sp = _step_params(ns, "ht", 2500.0)
    assert sp.p == 3  # explicit flag beats the preset's p=6
    assert sp.n_sim == 8  # preset fills unset flags
    assert sp.n_search == 8
    assert sp.tau_match == 2500.0  # documented default fills last
    assert sp.tau_2d == "dct" and sp.use_sd is False


def test_matched_preset_is_the_measured_one():
    """The CLI 'matched' preset must stay in sync with the knee-sweep
    winner (N8 n16 p8 nDisp=1 p_ang=4 + flat_tau=1.3: 28.417 dB vs default
    28.416 at the flagship shape)."""
    import argparse

    from lfbm5d_tpu.cli import _step_args, _step_params

    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="matched")
    _step_args(ap, "ht", 2500.0)
    sp = _step_params(ap.parse_args([]), "ht", 2500.0)
    assert (sp.n_sim, sp.n_search, sp.n_disp, sp.p, sp.p_ang) == (8, 16, 1, 8, 4)
    assert sp.flat_tau == 1.3


def test_robust_preset_is_the_measured_one():
    """The CLI 'robust' preset must stay in sync with the content-
    robustness winner (N16 n16 p3 nDisp=1 p_ang=2: within 0.05 dB of
    reference-default on every tested content class, worst case
    -0.046 dB on the static-background LF)."""
    import argparse

    from lfbm5d_tpu.cli import _step_args, _step_params

    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="robust")
    _step_args(ap, "ht", 2500.0)
    sp = _step_params(ap.parse_args([]), "ht", 2500.0)
    assert (sp.n_sim, sp.n_search, sp.n_disp, sp.p, sp.p_ang) == (16, 16, 1, 3, 2)
