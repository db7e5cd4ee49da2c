"""Device measurement of adaptive-region compositing.

The region mode's value claim — matched-class speed with robust-class
quality when the static content is a bounded region. This bench measures it
at flagship scale on the
content class it targets (a static background plane with a moving
foreground = static-MINORITY blocks clustered in a box), against the
whole-LF alternatives:

    matched          fast everywhere, known to lose on static content
    robust           safe everywhere, much slower
    adaptive         LF-level routing (picks ONE of the above)
    adaptive-region  matched everywhere + robust inside the static box

Usage: python experiments/region_adaptive_bench.py [--hw 434 625]
         [--family static-flat|static-min|two-plane] [--seeds 0]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from lfbm5d_tpu.config import preset_denoise_params  # noqa: E402
from lfbm5d_tpu.lf.metrics import psnr_device  # noqa: E402
from lfbm5d_tpu.lf.noise import add_noise_np  # noqa: E402
from lfbm5d_tpu.lf.synth import synthetic_lf, synthetic_lf_multi  # noqa: E402
from lfbm5d_tpu.pipeline import run_bm5d  # noqa: E402
from lfbm5d_tpu.pipeline.adaptive import (  # noqa: E402
    denoise_region_adaptive,
    select_preset,
)
from lfbm5d_tpu.utils.cache import enable_persistent_compilation_cache  # noqa: E402


def make_lf(family, h, w, seed):
    if family == "two-plane":
        return synthetic_lf(9, 9, h, w, 3, disp_bg=1, disp_fg=2, seed=seed)
    if family == "static-min":
        return synthetic_lf(9, 9, h, w, 3, disp_bg=0, disp_fg=2, seed=seed)
    if family == "occl-grad":
        # the measured matched-failure class: weak blocks cluster in the
        # mid-contrast band of the ramp (left is flat, right is strong) —
        # the region mode's target geometry after the round-4 re-tune
        return synthetic_lf_multi(9, 9, h, w, 3, disps=(0.5, 1.5, 3.0),
                                  seed=seed, blob_frac=0.3,
                                  texture_grad=0.7)
    if family == "static-flat":
        return synthetic_lf_multi(9, 9, h, w, 3, disps=(0.0, 2.0),
                                  seed=seed, blob_frac=0.25, flat_frac=0.4)
    raise SystemExit(f"unknown family {family}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="static-flat")
    ap.add_argument("--hw", type=int, nargs=2, default=[434, 625])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0])
    ap.add_argument("--sigma", type=float, default=25.0)
    args = ap.parse_args()
    enable_persistent_compilation_cache()
    h, w = args.hw
    mpix = 81 * h * w / 1e6

    for seed in args.seeds:
        clean = make_lf(args.family, h, w, seed)
        noisy = add_noise_np(clean, args.sigma, seed=seed + 100)
        clean_d = jax.device_put(clean.astype(np.float32))
        lf = jax.device_put(noisy.astype(np.float32))
        routed, stats = select_preset(lf, args.sigma)
        rows = {}

        def sync(x):
            return float(psnr_device(jnp.clip(x, 0, 255), clean_d))

        def timed(fn, runs=2):
            out = jax.block_until_ready(fn())  # compile+warm
            ts = []
            for _ in range(runs):
                t0 = time.time()
                out = jax.block_until_ready(fn())
                ts.append(time.time() - t0)
            return out, min(ts)

        for preset in ("matched", "robust"):
            # default chunk: keep rows comparable with content_family.py
            # and with denoise_region_adaptive's internal presets
            params = preset_denoise_params(preset, args.sigma)
            final, dt = timed(lambda p=params: run_bm5d(lf, p)[1])
            rows[preset] = (round(sync(final), 3), round(dt, 2))

        # region mode (probe + composite inside the timed window)
        final, dt = timed(lambda: denoise_region_adaptive(lf, args.sigma)[1])
        _, _, info = denoise_region_adaptive(lf, args.sigma)
        rows["adaptive-region"] = (round(sync(final), 3), round(dt, 2))

        print(json.dumps({
            "family": args.family, "seed": seed,
            "weak_fraction": round(stats["weak_fraction"], 3),
            "static_fraction": round(stats["static_fraction"], 3),
            "lf_routing": routed,
            "region_mode": info["mode"],
            "region_box": info.get("box"),
            "rows_psnr_s": rows,
            "mpix_s": {k: round(mpix / v[1], 2) for k, v in rows.items()},
        }), flush=True)


if __name__ == "__main__":
    main()
