"""Content-family measurement suite in ONE process, so the big compiled
programs (matched / robust / default / region composite / psnr) compile
once and all rows reuse them.

Produces (JSON lines, incrementally flushed):
  * per (family, seed): probe weak_fraction, matched PSNR, robust PSNR
    (router threshold sweep inputs)
  * the occl3 reference-default anchor
  * min-of-N timings (ended by jax.block_until_ready, never a PSNR fetch
    inside the window) for matched/robust/region rows on the region
    families
  * threshold sensitivity table over t in [0.55, 0.75]

Usage: python experiments/round5_suite.py [--small] [--seeds 0 1 2]
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
from lfbm5d_tpu.pipeline import run_bm5d  # noqa: E402
from lfbm5d_tpu.pipeline.adaptive import (  # noqa: E402
    content_stats,
    denoise_region_adaptive,
)
from lfbm5d_tpu.utils.cache import enable_persistent_compilation_cache  # noqa: E402
from experiments.content_family import make_lf  # noqa: E402

FAMILIES = ["two-plane", "low-disp", "occl3", "occl-grad", "static-min",
            "static-flat"]
REGION_FAMILIES = {"static-min", "occl-grad", "static-flat"}
DEFAULT_ANCHORS_SEED0 = {
    "two-plane": 28.416, "low-disp": 30.800, "occl-grad": 29.733,
    "static-min": 29.666, "static-flat": 30.407,
}


def psnr_of(x, clean_d):
    return float(psnr_device(jnp.clip(x, 0, 255), clean_d))


def timed(fn, runs=2):
    out = jax.block_until_ready(fn())
    ts = []
    for _ in range(runs):
        t0 = time.time()
        out = jax.block_until_ready(fn())
        ts.append(time.time() - t0)
    return out, min(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--families", nargs="*", default=FAMILIES)
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    enable_persistent_compilation_cache()
    h, w = (192, 256) if args.small else (434, 625)
    mpix = 81 * h * w / 1e6

    p_m = preset_denoise_params("matched", 25.0)
    p_r = preset_denoise_params("robust", 25.0)
    p_d = preset_denoise_params("default", 25.0)

    cases = []
    for family in args.families:
        for seed in args.seeds:
            clean = make_lf(family, h, w, seed)
            noisy = add_noise_np(clean, 25.0, seed=seed + 100)
            clean_d = jax.device_put(clean.astype(np.float32))
            lf = jax.device_put(noisy.astype(np.float32))
            wf = content_stats(noisy, 25.0)["weak_fraction"]

            fm, tm = timed(lambda: run_bm5d(lf, p_m)[1], args.runs)
            qm = psnr_of(fm, clean_d)
            fr, tr = timed(lambda: run_bm5d(lf, p_r)[1],
                           args.runs if seed == 0 else 1)
            qr = psnr_of(fr, clean_d)
            row = dict(family=family, seed=seed, weak_fraction=round(wf, 4),
                       matched=round(qm, 3), matched_s=round(tm, 3),
                       robust=round(qr, 3), robust_s=round(tr, 3))
            if seed == 0:
                if family == "occl3":
                    fd, td = timed(lambda: run_bm5d(lf, p_d)[1], 1)
                    row["default"] = round(psnr_of(fd, clean_d), 3)
                    row["default_s"] = round(td, 2)
                elif family in DEFAULT_ANCHORS_SEED0:
                    row["default"] = DEFAULT_ANCHORS_SEED0[family]
                if family in REGION_FAMILIES:
                    fg, tg = timed(
                        lambda: denoise_region_adaptive(lf, 25.0)[1],
                        args.runs,
                    )
                    _, _, info = denoise_region_adaptive(lf, 25.0)
                    row["region"] = round(psnr_of(fg, clean_d), 3)
                    row["region_s"] = round(tg, 3)
                    row["region_mode"] = info["mode"]
                    row["region_area_frac"] = info.get("area_frac")
            cases.append(row)
            print(json.dumps(row), flush=True)

    print("\nthreshold sensitivity (regret vs best-of-two, dB):", flush=True)
    for t100 in range(55, 76):
        t = t100 / 100.0
        regrets = []
        for c in cases:
            routed = c["matched"] if c["weak_fraction"] < t else c["robust"]
            regrets.append(max(c["matched"], c["robust"]) - routed)
        n_wrong = sum(1 for r in regrets if r > 0.05)
        print(f"  t={t:.2f}  max_regret={max(regrets):.3f} "
              f"mean={np.mean(regrets):.4f}  cases>0.05: {n_wrong}/"
              f"{len(regrets)}", flush=True)
    print(f"\n(mpix per LF: {mpix:.2f}; matched/robust/region seconds are "
          f"min-of-{args.runs})", flush=True)


if __name__ == "__main__":
    main()
