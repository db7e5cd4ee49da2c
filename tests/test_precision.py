"""Every f32 matrix product of the pipeline is pinned to Precision.HIGHEST.

At default precision an f32 product may run in TF32 on the GPU; the Wiener
step block-matches on the HT output with quantized integer distances, so
that error can change candidate sets (transforms/apply.py docstring). These
tests lower each product site and read the precision of every dot_general.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lfbm5d_tpu.config import DenoiseParams, StepParams
from lfbm5d_tpu.lf.color import rgb_to_space, space_to_rgb
from lfbm5d_tpu.ops.flat import fallback_shrink_2d
from lfbm5d_tpu.pipeline.denoise import build_denoise_fn
from lfbm5d_tpu.transforms import matrices as tm
from lfbm5d_tpu.transforms.apply import GroupTransforms, forward_5d, inverse_5d

F32 = jnp.float32


def assert_all_highest(lowered) -> int:
    dots = [ln for ln in lowered.as_text().splitlines()
            if "dot_general" in ln]
    assert dots, "no dot_general lowered"
    for ln in dots:
        assert "precision = [HIGHEST, HIGHEST]" in ln, ln
    return len(dots)


@pytest.mark.parametrize("tau_2d,tau_4d,tau_5d", list(itertools.product(
    ("dct", "bior"), ("dct", "id"), ("haar", "hadamard", "dct"))))
def test_transform_products_are_highest(tau_2d, tau_4d, tau_5d):
    sp = StepParams(n_sim=4, k=8, tau_2d=tau_2d, tau_4d=tau_4d,
                    tau_5d=tau_5d)
    gt = GroupTransforms.build(sp, 3, 3, dtype=F32)
    g = jnp.zeros((2, 4, 3, 3, 8, 8, 3), F32)
    lvl = jnp.zeros((2,), jnp.int32)
    n_fwd = assert_all_highest(
        jax.jit(lambda g, l: forward_5d(g, l, gt)).lower(g, lvl))
    n_inv = assert_all_highest(
        jax.jit(lambda g, l: inverse_5d(g, l, gt)).lower(g, lvl))
    assert n_fwd == n_inv == (5 if tau_4d == "dct" else 3)


@pytest.mark.parametrize("space", ["opp", "yuv", "ycbcr"])
def test_color_products_are_highest(space):
    x = jnp.zeros((2, 2, 4, 4, 3), F32)
    assert_all_highest(jax.jit(lambda v: rgb_to_space(v, space)).lower(x))
    assert_all_highest(jax.jit(lambda v: space_to_rgb(v, space)).lower(x))
    # host arrays stay on the host
    assert isinstance(rgb_to_space(np.zeros((1, 3)), space), np.ndarray)


@pytest.mark.parametrize("tau_2d,wiener", list(itertools.product(
    ("dct", "bior"), (False, True))))
def test_fallback_products_are_highest(tau_2d, wiener):
    f2, i2 = (jnp.asarray(m, F32) for m in tm.transform_pair(tau_2d, 8))
    x = jnp.zeros((2, 2, 20, 20, 3), F32)
    sig = jnp.ones((3,), F32)
    pilot = x if wiener else None
    assert_all_highest(jax.jit(
        lambda v: fallback_shrink_2d(v, sig, f2, i2, 2.7, pilot)).lower(x))


def test_whole_pipeline_products_are_highest():
    """Colour, both steps' transforms and the flat fallback, lowered as the
    one program run_bm5d compiles."""
    sp = dict(n_sim=4, n_search=2, n_disp=1, k=8, p=4, flat_tau=1.3)
    p = DenoiseParams(sigma=20.0, color_space="opp",
                      ht=StepParams(tau_match=2500.0, **sp),
                      wiener=StepParams(tau_match=400.0, **sp), chunk=16)
    fn = build_denoise_fn(p, 2, 2, 16, 16, 3, "float32")
    lf = jnp.zeros((2, 2, 16, 16, 3), F32)
    assert assert_all_highest(
        jax.jit(fn).lower(lf, jnp.ones((3,), F32))) >= 20
