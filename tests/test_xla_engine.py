"""The XLA pipeline against the float64 oracle, at tiny shapes.

One parametrised case per configuration class: the transform variant, the
reference-SAI subsampling, the flat fallback, SD weights, the Wiener step on
a 3x3 grid (angular DCTs are asymmetric beyond 2x2, which catches transposed
matrices), a grid of more than 128 SAIs, OPP colour, a 1x1 grid (plain
single-image BM3D), and Wiener block matching on the noisy LF. With
quantized BM distances the f64 pipeline equals the oracle to float rounding
(docs/PARITY.md), so the bound is 1e-9.
"""

import numpy as np
import pytest

from lfbm5d_tpu.config import DenoiseParams, StepParams
from lfbm5d_tpu.lf import psnr, synthetic_lf
from lfbm5d_tpu.lf.noise import add_noise_np
from lfbm5d_tpu.oracle import oracle_denoise
from lfbm5d_tpu.pipeline import run_bm5d

TINY = dict(n_sim=8, n_search=4, n_disp=1, k=8, p=3)
SMALL = dict(n_sim=4, n_search=2, n_disp=1, k=4, p=4)

# name: (shape [aH, aW, H, W, C], step overrides, colour space)
CASES = {
    "bior_dct_hadamard": ((2, 2, 16, 20, 1),
                          dict(TINY, tau_2d="bior", tau_5d="hadamard"), "rgb"),
    "p_ang2": ((3, 3, 16, 16, 1), dict(TINY, p_ang=2), "rgb"),
    "flat_tau": ((2, 2, 24, 24, 1), dict(SMALL, flat_tau=1.15), "rgb"),
    "use_sd": ((2, 2, 16, 20, 1), dict(TINY, use_sd=True), "rgb"),
    "wiener_3x3": ((3, 3, 16, 20, 1), TINY, "rgb"),
    "grid_12x12": ((12, 12, 12, 12, 1), dict(SMALL, n_sim=2, p_ang=4),
                   "rgb"),
    "opp_rgb": ((2, 2, 16, 16, 3), TINY, "opp"),
    "single_sai": ((1, 1, 24, 24, 1), TINY, "rgb"),
    # Wiener BM on the noisy LF (StepParams.bm_source; the HT step ignores it)
    "bm_source_noisy": ((2, 2, 16, 20, 1), dict(TINY, bm_source="noisy"),
                        "rgb"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_xla_engine_f64_matches_oracle(name):
    shape, step, space = CASES[name]
    clean = synthetic_lf(*shape[:4], channels=shape[4], disp_bg=1, disp_fg=2,
                         seed=7, flat_frac=0.5 if "flat_tau" in step else 0.0)
    noisy = add_noise_np(clean, 20.0, seed=8)
    p = DenoiseParams(
        sigma=20.0, color_space=space,
        ht=StepParams(tau_match=2500.0, **step),
        wiener=StepParams(tau_match=400.0, **step), chunk=16,
    )
    ob, of = oracle_denoise(noisy, p)
    tb, tf = run_bm5d(noisy, p, dtype="float64")
    assert np.abs(ob - np.asarray(tb)).max() < 1e-9
    assert np.abs(of - np.asarray(tf)).max() < 1e-9
    assert psnr(np.clip(of, 0, 255), clean) > psnr(np.clip(noisy, 0, 255),
                                                    clean)
