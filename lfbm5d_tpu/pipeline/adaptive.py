"""Content-adaptive preset selection (round-3 extension of BASELINE.json:5,
re-tuned round 4 on the broadened content family).

The round-3 knee sweeps established that every aggressive speed knob
(p_ang >= 2, p = 8, N = 8) is CONTENT-dependent. Round 3 attributed the
failures to angularly-STATIC content and routed on static_fraction — but
that measurement predated the matched preset adopting the flat-region
fallback (flat_tau=1.3). The round-4 flagship re-measurement across six
content families (experiments/content_family.py, 9x9x434x625, sigma=25,
all numbers dB vs each family's own reference-default anchor) found the
landscape inverted:

  family        static_frac  default   matched   robust
  two-plane        0.57      28.416    +0.002    +0.136
  low-disp         0.87      30.800    +0.132    -0.011
  occl3            0.57      (n/a)     28.053    28.187
  occl-grad        0.61      29.733    -0.763 X  +0.142
  static-min       0.87      29.666    +0.433    +0.233
  static-flat      0.83      30.407    +0.269    +0.168

With flat_tau, `matched` is at-or-ABOVE default on every static and
low-disparity family (the flat fallback handles angular redundancy
optimally) — static_fraction routes exactly the content where matched now
wins to the ~25x slower robust preset. The one genuine matched failure is
WEAK-TEXTURE content (occl-grad: a texture-contrast gradient — block
energy too strong for the flat fallback, too weak for reliable BM at
p=8/N=8/p_ang=4; seeds 1/2 confirm: matched -0.87/-0.88 vs robust). The
discriminating statistic is therefore

  weak_fraction = (informative blocks with one-block-shift energy
                   <= 24 vb) / (informative blocks),
  informative: energy > 8 vb,  vb = block-mean noise variance

measured over 36 cases (6 families x 3 seeds x 2 scales) at 0.688-0.757
on the weak-texture family vs 0.536-0.635 on all five others — the 0.66
threshold sits in the gap at both probe geometries. (An alternative band
over non-flat blocks, energy in (4 vb, 24 vb], separates equally well for
ROUTING but false-flags ~17% of genuinely flat blocks through noise —
P(max of 4 chi-square_1 draws > 4) — which scatters the region map; the
informative band false-flags ~2%.)

Probe (one pass over two SAIs, numpy):

  1. 8x8 block means of channel 0 of the two extreme corner SAIs — block
     averaging suppresses the AWGN variance 64x, and the corner pair has the
     longest angular baseline, so a plane of disparity d is displaced by
     d * (angular extent) ~ 8d pixels between them.
  2. d = (m0 - m1)^2 per block; g = max squared difference of m0 against its
     4 one-block-shifted neighbors (the content's own energy at the
     one-block displacement scale, which is what a disparity-1 plane looks
     like).
  3. blocks with g > 8 vb are "informative"; informative blocks with
     g <= 24 vb are WEAK. weak_fraction = weak / informative.
     (static_fraction is still computed and reported — it localizes
     static planes for diagnostics — but no longer routes.)

Decision: weak_fraction >= 0.66 -> 'robust', else 'matched'.
"""

from __future__ import annotations

import numpy as np

from lfbm5d_tpu.config import DenoiseParams, preset_denoise_params

# Decision threshold on the weak-texture block fraction (see module
# docstring for the measured family landscape that places it).
WEAK_FRACTION_THRESHOLD = 0.66
# Weak bound: informative blocks at-or-below this multiple of the
# block-mean noise variance (2 sigma^2 / 64) are too weak for reliable
# aggressive-preset BM.
_WEAK_FACTOR = 24.0
# A block's one-block-shift content energy must exceed this multiple of the
# block-mean noise variance to count as informative.
_INFORMATIVE_FACTOR = 8.0
# An informative block is static when the extreme-pair difference is below
# max(_STATIC_NOISE_FACTOR * noise, _STATIC_CONTENT_FRACTION * g).
_STATIC_NOISE_FACTOR = 6.0
_STATIC_CONTENT_FRACTION = 0.15


def probe_maps(lf, sigma: float, block: int = 8) -> tuple[dict, dict]:
    """Angular-redundancy / texture-strength probe of a (noisy) light field.

    lf: [aH, aW, H, W, C] array-like in [0, 255]; sigma: AWGN std on the
    [0,255] scale (the CLI/bench always know it).

    Returns (stats, maps):
      stats = {weak_fraction, static_fraction, n_informative, n_blocks,
               noise_var_block}
      maps["weak"] = [H//block, W//block] bool — informative blocks whose
        one-block-shift energy is in the weak band (the content class
        where aggressive presets measurably lose quality; round-4 table
        in the module docstring). Flat blocks are NOT in the map: the
        flat fallback already handles them optimally under any preset.
      maps["static"] = informative AND angularly-static blocks
        (diagnostic; localizes static planes).
    """
    lf = np.asarray(lf)
    a_h, a_w = lf.shape[:2]
    b = block
    p0 = lf[0, 0, :, :, 0].astype(np.float64)
    p1 = lf[a_h - 1, a_w - 1, :, :, 0].astype(np.float64)
    hb, wb = (p0.shape[0] // b) * b, (p0.shape[1] // b) * b
    vb = 2.0 * sigma * sigma / (b * b)
    empty = np.zeros((max(hb // b, 0), max(wb // b, 0)), bool)
    if hb == 0 or wb == 0 or (a_h == 1 and a_w == 1):
        stats = {"weak_fraction": 0.0, "static_fraction": 1.0,
                 "n_informative": 0, "n_blocks": 0, "noise_var_block": vb}
        return stats, {"weak": empty, "static": empty}

    def block_means(p):
        return p[:hb, :wb].reshape(hb // b, b, wb // b, b).mean(axis=(1, 3))

    m0 = block_means(p0)
    m1 = block_means(p1)
    d = (m0 - m1) ** 2
    g = np.zeros_like(m0)
    g[:-1, :] = np.maximum(g[:-1, :], (m0[:-1, :] - m0[1:, :]) ** 2)
    g[1:, :] = np.maximum(g[1:, :], (m0[1:, :] - m0[:-1, :]) ** 2)
    g[:, :-1] = np.maximum(g[:, :-1], (m0[:, :-1] - m0[:, 1:]) ** 2)
    g[:, 1:] = np.maximum(g[:, 1:], (m0[:, 1:] - m0[:, :-1]) ** 2)

    informative = g > _INFORMATIVE_FACTOR * vb
    weak_map = informative & (g <= _WEAK_FACTOR * vb)
    n_inf = int(informative.sum())
    if n_inf < 8:
        # featureless content: angularly redundant by definition (the flat
        # fallback covers it; matched is safe regardless of weak blocks)
        stats = {"weak_fraction": 0.0, "static_fraction": 1.0,
                 "n_informative": n_inf, "n_blocks": int(d.size),
                 "noise_var_block": vb}
        return stats, {"weak": np.zeros_like(informative),
                       "static": np.zeros_like(informative)}
    static_map = informative & (
        d < np.maximum(_STATIC_NOISE_FACTOR * vb,
                       _STATIC_CONTENT_FRACTION * g)
    )
    stats = {
        "weak_fraction": float(weak_map.sum() / n_inf),
        "static_fraction": float(static_map.sum() / n_inf),
        "n_informative": n_inf,
        "n_blocks": int(d.size),
        "noise_var_block": vb,
    }
    return stats, {"weak": weak_map, "static": static_map}


def _probe_source(lf):
    """Host probe view of an LF: the two extreme-corner SAIs as a 2x1 grid.

    probe_maps only reads lf[0, 0] and lf[-1, -1]; for DEVICE arrays,
    np.asarray(lf) would copy the whole LF to the host to read two SAIs,
    so fetch exactly those two, quantized (uint8: 4x fewer bytes; sub-LSB
    rounding is invisible to 8x8 block-mean statistics at sigma >= 5).
    Host arrays pass through untouched."""
    if isinstance(lf, np.ndarray):
        return lf
    import jax
    import jax.numpy as jnp

    if not isinstance(lf, jax.Array):
        return np.asarray(lf)
    from lfbm5d_tpu.lf.io import fetch_rounded

    return np.asarray(
        fetch_rounded(jnp.stack([lf[0, 0], lf[-1, -1]]), 8), np.float64
    )[:, None]


def content_stats(lf, sigma: float, block: int = 8) -> dict:
    """Probe stats only (see probe_maps; device LFs probe via corner-SAI
    fetch, not a whole-LF download)."""
    return probe_maps(_probe_source(lf), sigma, block)[0]


def select_preset(lf, sigma: float) -> tuple[str, dict]:
    """('matched' | 'robust', probe stats) for a noisy LF at known sigma."""
    stats = content_stats(lf, sigma)
    name = (
        "robust"
        if stats["weak_fraction"] >= WEAK_FRACTION_THRESHOLD
        else "matched"
    )
    return name, stats


def adaptive_denoise_params(lf, sigma: float, **kw) -> tuple[DenoiseParams, str, dict]:
    """DenoiseParams chosen by the content probe, plus (name, stats)."""
    name, stats = select_preset(lf, sigma)
    return preset_denoise_params(name, sigma, **kw), name, stats


# ---------------------------------------------------------------------------
# Region-adaptive denoising (round-3 agenda: tile-level preset mixing;
# re-targeted round 4 to the measured failure class).
#
# The LF-level router above is all-or-nothing: a weak-texture region
# anywhere routes the WHOLE light field to the ~25x slower robust preset.
# But the probe already localizes the failure: aggressive presets lose
# quality only ON the weak-texture blocks (round-4 family table in the
# module docstring — static planes are covered by the flat fallback and
# are matched-safe). Region mode therefore:
#
#   1. denoises the full LF at `matched` speed,
#   2. re-denoises ONLY a bounding crop of the weak blocks (expanded by a
#      margin that covers the denoiser's boundary-effect width) at `robust`
#      quality,
#   3. composites the robust interior over the matched output with a linear
#      feather across the margin (both outputs are valid denoisings; the
#      feather only prevents a visible seam).
#
# Crop dimensions round up to a multiple of `round_to` so repeated calls on
# same-shaped LFs reuse a small set of compiled programs. When the crop
# would cover most of the frame the crop saves nothing and the LF-level
# routing is used unchanged.
# ---------------------------------------------------------------------------

# Boundary-effect width of the two-step pipeline: a pixel's output draws on
# reference patches up to p-grid distance n away, whose groups span patches
# up to n + nd further; beyond n + (n + nd) + k the crop interior is
# context-complete. robust: n=16, nd=1, k=8 -> 41.
REGION_MARGIN = 48
# Crop dims round up to this multiple (compile-shape bucketing).
REGION_ROUND_TO = 32
# Crop area fraction above which region mode degenerates to LF-level robust.
REGION_FULL_ROBUST_FRAC = 0.7
# Fewer flagged blocks than this is measurement noise, not a weak region.
REGION_MIN_WEAK_BLOCKS = 12


def static_region_box(flag_map: np.ndarray, h: int, w: int, block: int = 8,
                      margin: int = REGION_MARGIN,
                      round_to: int = REGION_ROUND_TO) -> tuple | None:
    """Pixel bounding box (y0, y1, x0, x1) of the flagged blocks (weak-map
    in production; any bool block map works), expanded by `margin` and
    rounded up to `round_to` multiples within the frame.
    None if the map has no flagged blocks."""
    ys, xs = np.nonzero(flag_map)
    if ys.size == 0:
        return None
    y0 = max(int(ys.min()) * block - margin, 0)
    y1 = min((int(ys.max()) + 1) * block + margin, h)
    x0 = max(int(xs.min()) * block - margin, 0)
    x1 = min((int(xs.max()) + 1) * block + margin, w)

    def round_span(lo, hi, limit):
        want = min(-((hi - lo) // -round_to) * round_to, limit)
        grow = want - (hi - lo)
        lo = max(lo - grow // 2, 0)
        hi = min(lo + want, limit)
        lo = hi - want
        return lo, hi

    y0, y1 = round_span(y0, y1, h)
    x0, x1 = round_span(x0, x1, w)
    return y0, y1, x0, x1


def _feather(ch: int, cw: int, box, h: int, w: int,
             margin: int = REGION_MARGIN) -> np.ndarray:
    """[ch, cw] float32 composite weight: 1 in the crop interior, linear
    ramp to 0 at crop edges that are NOT image borders (those pixels lack
    full search context in the crop AND sit where matched already agrees)."""
    y0, y1, x0, x1 = box
    m = float(margin)

    def ramp(n, lo_open, hi_open):
        d_lo = np.arange(n, dtype=np.float32) + 0.5
        d_hi = d_lo[::-1]
        r = np.ones(n, np.float32)
        if lo_open:
            r = np.minimum(r, d_lo / m)
        if hi_open:
            r = np.minimum(r, d_hi / m)
        return r

    wy = ramp(ch, y0 > 0, y1 < h)
    wx = ramp(cw, x0 > 0, x1 < w)
    return np.minimum(wy[:, None], wx[None, :])


def denoise_region_adaptive(noisy, sigma: float, *,
                            dtype: str = "float32", block: int = 8,
                            margin: int = REGION_MARGIN,
                            round_to: int = REGION_ROUND_TO,
                            full_robust_frac: float = REGION_FULL_ROBUST_FRAC,
                            min_weak_blocks: int = REGION_MIN_WEAK_BLOCKS,
                            params_matched: DenoiseParams | None = None,
                            params_robust: DenoiseParams | None = None):
    """Probe-localized preset mixing: matched speed where texture is
    BM-reliable (or flat), robust quality on the weak-texture region,
    feather-composited.

    noisy: [aH, aW, H, W, C] in [0, 255] (numpy or device array).
    Returns (basic, final, info); info records the route taken
    ('matched' | 'robust' | 'region'), the probe stats, and in region mode
    the crop box and its area fraction.

    params_matched/params_robust override the two presets (tests use small
    search windows; production callers leave them None).
    """
    from lfbm5d_tpu.pipeline import run_bm5d

    import jax.numpy as jnp

    h, w = int(noisy.shape[2]), int(noisy.shape[3])
    # device LFs probe via the quantized corner-SAI fetch (shared helper)
    stats, maps = probe_maps(_probe_source(noisy), sigma, block)
    p_m = params_matched or preset_denoise_params("matched", sigma)
    p_r = params_robust or preset_denoise_params("robust", sigma)

    wmap = maps["weak"]
    box = (static_region_box(wmap, h, w, block, margin, round_to)
           if int(wmap.sum()) >= min_weak_blocks else None)
    if box is None:
        if stats["weak_fraction"] >= WEAK_FRACTION_THRESHOLD:
            # weak content the box logic could not localize (e.g. weak
            # blocks everywhere but below the min count) -> LF-level
            # robust, same as select_preset
            basic, final = run_bm5d(noisy, p_r, dtype)
            return basic, final, {"mode": "robust", "stats": stats}
        basic, final = run_bm5d(noisy, p_m, dtype)
        return basic, final, {"mode": "matched", "stats": stats}

    y0, y1, x0, x1 = box
    area_frac = (y1 - y0) * (x1 - x0) / float(h * w)
    if area_frac >= full_robust_frac:
        # The crop saves nothing -> degenerate to the LF-level router's
        # decision. Strong-texture content still has scattered weak blocks
        # whose bounding box can cover most of the frame (weak_fraction
        # ~0.54-0.64, below the threshold): that class belongs on
        # `matched`, exactly as `select_preset` routes it — only content
        # the LF-level router would call weak gets full-frame robust.
        if stats["weak_fraction"] >= WEAK_FRACTION_THRESHOLD:
            basic, final = run_bm5d(noisy, p_r, dtype)
            mode = "robust"
        else:
            basic, final = run_bm5d(noisy, p_m, dtype)
            mode = "matched"
        return basic, final, {"mode": mode, "stats": stats,
                              "box": box, "area_frac": round(area_frac, 3)}

    basic_m, final_m = run_bm5d(noisy, p_m, dtype)
    noisy_j = noisy if isinstance(noisy, jnp.ndarray) else jnp.asarray(
        np.asarray(noisy), jnp.dtype(dtype))
    crop = noisy_j[:, :, y0:y1, x0:x1]
    basic_r, final_r = run_bm5d(crop, p_r, dtype)

    wgt = jnp.asarray(
        _feather(y1 - y0, x1 - x0, box, h, w, margin), jnp.dtype(dtype)
    )[None, None, :, :, None]

    def composite(full, region):
        patch = wgt * region + (1.0 - wgt) * full[:, :, y0:y1, x0:x1]
        return full.at[:, :, y0:y1, x0:x1].set(patch.astype(full.dtype))

    info = {"mode": "region", "stats": stats, "box": box,
            "area_frac": round(area_frac, 3),
            "crop_shape": [y1 - y0, x1 - x0]}
    return composite(basic_m, basic_r), composite(final_m, final_r), info
