"""Degenerate-parameter robustness.

A 1x1 angular grid reduces LFBM5D to plain single-image BM3D — the
framework covers that reference use case for free.
"""

import numpy as np
import pytest

from lfbm5d_tpu.config import DenoiseParams, StepParams
from lfbm5d_tpu.lf import psnr, synthetic_lf
from lfbm5d_tpu.lf.noise import add_noise_np
from lfbm5d_tpu.pipeline import run_bm5d


def _run(shape, sp_kw):
    clean = synthetic_lf(*shape[:4], channels=shape[4], seed=0)
    noisy = add_noise_np(clean, 20.0, seed=1)
    p = DenoiseParams(
        sigma=20.0, ht=StepParams(**sp_kw),
        wiener=StepParams(tau_match=400.0, **sp_kw), chunk=16,
    )
    b, f = run_bm5d(noisy, p)
    assert np.isfinite(np.asarray(f)).all()
    return clean, noisy, np.asarray(f)


@pytest.mark.slow
def test_single_image_bm3d():
    clean, noisy, f = _run(
        (1, 1, 32, 32, 1), dict(n_sim=8, n_search=4, n_disp=1, k=8, p=3),
    )
    assert psnr(np.clip(f, 0, 255), clean) > psnr(
        np.clip(noisy, 0, 255), clean
    ) + 2.0


@pytest.mark.parametrize("shape,sp", [
    ((2, 2, 8, 12, 1), dict(n_sim=2, n_search=2, n_disp=1, k=8, p=3)),
    ((2, 2, 16, 16, 1), dict(n_sim=1, n_search=3, n_disp=1, k=8, p=4)),
    ((2, 2, 16, 16, 1), dict(n_sim=4, n_search=3, n_disp=0, k=8, p=4)),
    ((2, 2, 16, 16, 1), dict(n_sim=4, n_search=3, n_disp=1, k=4, p=3)),
])
@pytest.mark.slow
def test_degenerate_params(shape, sp):
    _run(shape, sp)
