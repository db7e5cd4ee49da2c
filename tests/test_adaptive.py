"""Content-adaptive preset selection (pipeline/adaptive.py).

Round-4 flagship measurements (experiments/content_family.py; table in the
adaptive module docstring) found that with the flat fallback the matched
preset is at-or-above reference-default quality on every static and
low-disparity family, and fails the budget only on WEAK-TEXTURE content
(block energy too strong for the flat fallback, too weak for reliable BM
at p=8/N=8/p_ang=4). These tests pin the probe's classification of the
regimes, on noisy input, across seeds — the probe only ever sees what the
CLI sees.
"""

import numpy as np
import pytest

from lfbm5d_tpu.config import PRESETS, DenoiseParams, StepParams, \
    preset_denoise_params
from lfbm5d_tpu.lf import synthetic_lf
from lfbm5d_tpu.lf.noise import add_noise_np
from lfbm5d_tpu.lf.synth import synthetic_lf_multi
from lfbm5d_tpu.pipeline.adaptive import (
    WEAK_FRACTION_THRESHOLD,
    _feather,
    content_stats,
    denoise_region_adaptive,
    probe_maps,
    select_preset,
    static_region_box,
)


def _noisy(seed, bg, fg, sigma=25.0, a=9, h=224, w=320):
    clean = synthetic_lf(a, a, h, w, channels=3, disp_bg=bg, disp_fg=fg,
                         seed=seed)
    return add_noise_np(clean, sigma, seed=seed + 1)


def _noisy_grad(seed, sigma=25.0, a=9, h=224, w=320):
    """The weak-texture family: 3 occluding layers + a 0.7 contrast ramp
    (the one content class where matched measured outside the budget:
    -0.76 to -0.88 dB vs default across seeds, round-4 flagship table)."""
    clean = synthetic_lf_multi(a, a, h, w, channels=3,
                               disps=(0.5, 1.5, 3.0), seed=seed,
                               blob_frac=0.3, texture_grad=0.7)
    return add_noise_np(clean, sigma, seed=seed + 1)


@pytest.mark.parametrize("seed,bg,fg", [(0, 1, 2), (7, 2, 3), (9, 3, 4),
                                        (17, 1, 3), (3, 1, 1)])
def test_disparity_rich_content_selects_matched(seed, bg, fg):
    name, stats = select_preset(_noisy(seed, bg, fg), 25.0)
    assert name == "matched", stats


@pytest.mark.parametrize("seed,bg,fg", [(11, 0, 1), (21, 0, 1), (13, 0, 2),
                                        (2, 0, 3), (5, 0, 0)])
def test_static_background_content_selects_matched(seed, bg, fg):
    """Round-4 inversion: a zero-disparity background (maximal angular
    redundancy) is the flat fallback's best case — matched measured
    +0.13/+0.43/+0.27 dB ABOVE default on the low-disp/static-min/
    static-flat flagship families. Routing it to the ~25x slower robust
    preset (the round-3 rule) costs both time and quality."""
    name, stats = select_preset(_noisy(seed, bg, fg), 25.0)
    assert name == "matched", stats


@pytest.mark.parametrize("seed,bg,fg", [(4, 1, 0), (6, 2, 0)])
def test_static_minority_plane_selects_matched(seed, bg, fg):
    """A static FOREGROUND plane: same inversion as the static background
    (static-min flagship family: matched +0.433 dB over default)."""
    name, stats = select_preset(_noisy(seed, bg, fg), 25.0)
    assert name == "matched", stats


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_weak_texture_content_selects_robust(seed):
    name, stats = select_preset(_noisy_grad(seed), 25.0)
    assert name == "robust", stats


def test_probe_class_separation():
    """The weak-texture class must stay separated from every strong-texture
    class with margin — the decision threshold sits strictly between
    them. (Measured landscape: strong classes <= 0.692 at test geometry /
    <= 0.709 at flagship; weak class >= 0.779 / >= 0.844.)"""
    strong = max(
        content_stats(_noisy(0, 1, 2), 25.0)["weak_fraction"],
        content_stats(_noisy(11, 0, 1), 25.0)["weak_fraction"],
        content_stats(_noisy(4, 1, 0), 25.0)["weak_fraction"],
    )
    weak = content_stats(_noisy_grad(0), 25.0)["weak_fraction"]
    assert strong < WEAK_FRACTION_THRESHOLD < weak, (strong, weak)


def test_probe_degenerate_inputs():
    flat = np.full((3, 3, 32, 32, 1), 128.0)
    st = content_stats(add_noise_np(flat, 25.0, seed=0), 25.0)
    # featureless -> flat fallback territory -> matched-safe
    assert st["weak_fraction"] == 0.0
    assert st["static_fraction"] == 1.0
    assert select_preset(add_noise_np(flat, 25.0, seed=0), 25.0)[0] == \
        "matched"
    one = np.zeros((1, 1, 16, 16, 1))
    assert content_stats(one, 25.0)["weak_fraction"] == 0.0


def test_preset_params_builders():
    p = preset_denoise_params("matched", 25.0)
    assert (p.ht.n_sim, p.ht.n_search, p.ht.n_disp, p.ht.p, p.ht.p_ang) == (
        8, 16, 1, 8, 4)
    assert p.ht.tau_match == 2500.0 and p.wiener.tau_match == 400.0
    assert set(PRESETS) == {"default", "fast", "matched", "robust"}


# ---------------------------------------------------------------------------
# Region-adaptive machinery (seam-sensitive indexing code needs
# direct CPU tests — box rounding/clamping, feather edge logic, composite
# indexing, and the large-box fallback route). Round 4: the region keys on
# the WEAK map (the measured failure class), not the static map.
# ---------------------------------------------------------------------------


def _paste_static_patch(clean, box, seed=100):
    """Paste a block-contrast texture IDENTICALLY into every SAI at the
    (y0, y1, x0, x1) pixel box: angularly static, informative blocks
    (strong 8x8 block-mean variation) exactly there."""
    y0, y1, x0, x1 = box
    rng = np.random.default_rng(seed)
    cells = rng.uniform(30, 225, ((y1 - y0) // 8 + 1, (x1 - x0) // 8 + 1))
    clean[:, :, y0:y1, x0:x1, 0] = np.kron(
        cells, np.ones((8, 8)))[: y1 - y0, : x1 - x0]
    return clean


def _paste_weak_patch(clean, box, seed=100, spread=16.0):
    """Paste a LOW-CONTRAST texture (block-mean steps within the probe's
    weak band: nonflat but <= 24 vb at sigma=25) identically into every
    SAI: the weak map flags exactly those blocks."""
    y0, y1, x0, x1 = box
    rng = np.random.default_rng(seed)
    cells = 128.0 + rng.uniform(-spread, spread,
                                ((y1 - y0) // 8 + 1, (x1 - x0) // 8 + 1))
    clean[:, :, y0:y1, x0:x1, 0] = np.kron(
        cells, np.ones((8, 8)))[: y1 - y0, : x1 - x0]
    return clean


def _flat_bg_patch_lf(box, a=3, h=96, w=160, sigma=25.0, weak=False):
    """Featureless background + one pasted patch: the probe's flagged
    blocks exist ONLY at the patch, so the maps localize it regardless of
    grid size (moving content needs the 9x9 baseline geometry for class
    separation, see the landscape in the module doc)."""
    clean = np.full((a, a, h, w, 1), 128.0)
    paste = _paste_weak_patch if weak else _paste_static_patch
    return add_noise_np(paste(clean, box), sigma, seed=1)


def test_probe_maps_marks_pasted_static_patch():
    """Static-map direction: blocks strictly inside an angularly-static
    textured patch must be in maps['static'] (informative AND static), on
    moving 9x9 content — the geometry the thresholds were measured on."""
    box = (40, 72, 64, 112)
    clean = synthetic_lf(9, 9, 128, 192, channels=1, disp_bg=1, disp_fg=2,
                         seed=0)
    noisy = add_noise_np(_paste_static_patch(clean, box), 25.0, seed=1)
    _, maps = probe_maps(noisy, 25.0)
    # patch-interior blocks (excluding the contrast boundary ring)
    interior = maps["static"][box[0] // 8 + 1: box[1] // 8 - 1,
                              box[2] // 8 + 1: box[3] // 8 - 1]
    assert interior.all(), interior


def test_probe_maps_localizes_weak_patch_on_flat_background():
    """Weak-map direction: with a featureless background the weak map
    concentrates on the pasted weak-texture patch — a few noise-induced
    nonflat blocks elsewhere are expected (the nonflat test is a ~2.8-sigma
    cut on block-mean diffs), so the assertion is concentration, not
    exclusivity."""
    box = (32, 56, 64, 96)
    stats, maps = probe_maps(_flat_bg_patch_lf(box, weak=True), 25.0)
    wmap = maps["weak"]
    ring = np.zeros_like(wmap)
    ring[box[0] // 8 - 1: box[1] // 8 + 1,
         box[2] // 8 - 1: box[3] // 8 + 1] = True
    in_ring = int((wmap & ring).sum())
    outside = int((wmap & ~ring).sum())
    assert in_ring >= 8, (in_ring, outside)
    assert outside <= 0.5 * in_ring, (in_ring, outside)


def test_static_region_box_invariants():
    h, w = 128, 192
    smap = np.zeros((h // 8, w // 8), bool)
    smap[5:9, 8:14] = True  # pixel box y [40,72), x [64,112)
    box = static_region_box(smap, h, w, margin=48, round_to=32)
    y0, y1, x0, x1 = box
    # containment: margin-expanded flagged pixels inside, clamped to frame
    assert 0 <= y0 <= max(40 - 48, 0) and min(72 + 48, h) <= y1 <= h
    assert 0 <= x0 <= max(64 - 48, 0) and min(112 + 48, w) <= x1 <= w
    # rounding: spans are multiples of 32 unless clamped by the frame
    assert (y1 - y0) % 32 == 0 or (y0 == 0 and y1 == h)
    assert (x1 - x0) % 32 == 0 or (x0 == 0 and x1 == w)
    # empty map -> no box
    assert static_region_box(np.zeros_like(smap), h, w) is None
    # full map -> the whole frame, never out of bounds
    fb = static_region_box(np.ones_like(smap), h, w)
    assert fb == (0, h, 0, w)


def test_feather_interior_and_open_edges():
    h, w, m = 256, 384, 48
    # box with all four edges open (inside the frame)
    f = _feather(128, 160, (64, 192, 96, 256), h, w, margin=m)
    assert f.shape == (128, 160)
    assert np.all(f[m:-m, m:-m] == 1.0)  # interior past the margin
    assert f[0, 80] < 0.02 and f[-1, 80] < 0.02  # ~0 at open edges
    assert f[64, 0] < 0.02 and f[64, -1] < 0.02
    # box flush to the top-left image corner: those edges stay 1
    g = _feather(128, 160, (0, 128, 0, 160), h, w, margin=m)
    assert np.all(g[0, : 160 - m] == 1.0) and np.all(g[: 128 - m, 0] == 1.0)
    assert g[64, -1] < 0.02  # the open edges still ramp


_TINY_STEP = dict(n_sim=4, n_search=4, n_disp=1, p=6, tau_2d="dct")


def _tiny_params(n_search):
    return DenoiseParams(
        sigma=25.0,
        ht=StepParams(tau_match=2500.0, **{**_TINY_STEP,
                                           "n_search": n_search}),
        wiener=StepParams(tau_match=400.0, **{**_TINY_STEP,
                                              "n_search": n_search}),
        chunk=64,
    )


def test_region_composite_end_to_end():
    """Composite equals the matched pass exactly outside the box and the
    robust crop pass in the feather-complete interior (probe-driven route,
    no mocking: flat background localizes the weak-texture patch)."""
    from lfbm5d_tpu.pipeline import run_bm5d

    noisy = _flat_bg_patch_lf((32, 56, 64, 96), h=96, w=160, weak=True)
    p_m, p_r = _tiny_params(4), _tiny_params(6)
    margin = 16
    basic, final, info = denoise_region_adaptive(
        noisy, 25.0, margin=margin, round_to=16,
        min_weak_blocks=4, params_matched=p_m, params_robust=p_r)
    assert info["mode"] == "region", info
    y0, y1, x0, x1 = info["box"]
    final = np.asarray(final)
    fm = np.asarray(run_bm5d(noisy, p_m)[1])
    # outside the box: bit-identical to the matched pass
    outside = np.ones(final.shape, bool)
    outside[:, :, y0:y1, x0:x1] = False
    np.testing.assert_array_equal(final[outside], fm[outside])
    # feather-complete interior: the robust crop pass at weight exactly 1
    # (edges flush with the image border are closed: no ramp there)
    fr = np.asarray(run_bm5d(noisy[:, :, y0:y1, x0:x1], p_r)[1])
    iy0 = y0 + margin if y0 > 0 else y0
    iy1 = y1 - margin if y1 < 96 else y1
    ix0 = x0 + margin if x0 > 0 else x0
    ix1 = x1 - margin if x1 < 160 else x1
    ii = final[:, :, iy0:iy1, ix0:ix1]
    ri = fr[:, :, iy0 - y0: iy1 - y0, ix0 - x0: ix1 - x0]
    np.testing.assert_allclose(ii, ri, atol=1e-4)


def test_large_box_scattered_weak_falls_back_to_router(monkeypatch):
    """Re-keyed to the weak map: a frame-spanning weak-block
    bounding box on content the LF-level router calls STRONG
    (weak_fraction < threshold — strong content has scattered weak blocks)
    must run matched, not the ~25x full-frame robust. The probe is stubbed
    to that exact landscape so the route is deterministic at CPU test
    scale (class separation needs the 9x9 geometry the thresholds were
    measured on)."""
    import lfbm5d_tpu.pipeline.adaptive as adaptive_mod

    noisy = add_noise_np(
        synthetic_lf(3, 3, 64, 96, channels=1, disp_bg=1, disp_fg=2, seed=0),
        25.0, seed=1)
    wmap = np.zeros((8, 12), bool)
    wmap[:2, :3] = True
    wmap[-2:, -3:] = True  # opposite corners -> frame-spanning box
    stats = {"weak_fraction": 0.58, "static_fraction": 0.55,
             "n_informative": 40, "n_blocks": 96, "noise_var_block": 19.5}
    monkeypatch.setattr(
        adaptive_mod, "probe_maps",
        lambda lf, sigma, block=8: (dict(stats),
                                    {"weak": wmap,
                                     "static": np.zeros_like(wmap)}))
    p_m, p_r = _tiny_params(4), _tiny_params(6)
    basic, final, info = denoise_region_adaptive(
        noisy, 25.0, params_matched=p_m, params_robust=p_r)
    assert info["mode"] == "matched", info
    assert info["area_frac"] >= 0.7
    from lfbm5d_tpu.pipeline import run_bm5d

    fm = np.asarray(run_bm5d(noisy, p_m)[1])
    np.testing.assert_array_equal(np.asarray(final), fm)


def test_large_box_weak_majority_runs_robust(monkeypatch):
    """Companion to the fallback fix: the same frame-spanning box on content
    the router calls WEAK keeps the full-frame robust route."""
    import lfbm5d_tpu.pipeline.adaptive as adaptive_mod

    noisy = add_noise_np(
        synthetic_lf(3, 3, 64, 96, channels=1, disp_bg=0, disp_fg=1, seed=0),
        25.0, seed=1)
    wmap = np.zeros((8, 12), bool)
    wmap[:4, :] = True
    wmap[-2:, -3:] = True
    stats = {"weak_fraction": 0.75, "static_fraction": 0.55,
             "n_informative": 40, "n_blocks": 96, "noise_var_block": 19.5}
    monkeypatch.setattr(
        adaptive_mod, "probe_maps",
        lambda lf, sigma, block=8: (dict(stats),
                                    {"weak": wmap,
                                     "static": np.zeros_like(wmap)}))
    p_m, p_r = _tiny_params(4), _tiny_params(6)
    basic, final, info = denoise_region_adaptive(
        noisy, 25.0, params_matched=p_m, params_robust=p_r)
    assert info["mode"] == "robust", info
    assert info["area_frac"] >= 0.7


def test_cli_presets_track_config_presets():
    """cli._PRESETS is a derived flag-name view of config.PRESETS — any
    drift between them would let the CLI and bench measure different
    parameters under the same preset name."""
    from lfbm5d_tpu.cli import _FIELD_TO_FLAG, _PRESETS

    for name, over in PRESETS.items():
        assert _PRESETS[name] == {
            _FIELD_TO_FLAG[f]: v for f, v in over.items()
        }


def test_probe_source_device_array_matches_host():
    """content_stats on a DEVICE array must fetch only the two corner SAIs
    (quantized) instead of np.asarray(whole LF) — and the resulting stats
    must match the host-array probe (sub-LSB quantization is invisible to
    the 8x8 block-mean statistics)."""
    import jax
    import numpy as np

    from lfbm5d_tpu.lf import synthetic_lf
    from lfbm5d_tpu.lf.noise import add_noise_np
    from lfbm5d_tpu.pipeline.adaptive import _probe_source, content_stats

    clean = synthetic_lf(5, 5, 64, 80, channels=3, seed=3)
    noisy = add_noise_np(clean, 25.0, seed=4)
    dev = jax.device_put(noisy.astype(np.float32))

    src = _probe_source(dev)
    assert src.shape[:2] == (2, 1)  # corner pair as a 2x1 grid, not the LF
    np.testing.assert_allclose(
        src[0, 0], np.round(np.clip(noisy[0, 0], 0, 255)), atol=0.5
    )

    s_host = content_stats(noisy, 25.0)
    s_dev = content_stats(dev, 25.0)
    assert abs(s_host["weak_fraction"] - s_dev["weak_fraction"]) < 0.02
    assert abs(s_host["static_fraction"] - s_dev["static_fraction"]) < 0.02
