"""Preset-constant validation across the broadened synthetic family.

Round-3 verdict: every preset/threshold constant (matched knee, flat_tau=1.3,
adaptive STATIC_FRACTION_THRESHOLD=0.60, robust preset) was tuned on ONE
two-plane content family. This experiment re-validates them on
`synthetic_lf_multi` scenes: moving occluders, >= 3 disparity layers,
fractional disparities, texture gradients, static-majority mixes.

For each family it reports, at the flagship 9x9x434x625 sigma=25 shape:
  * probe stats (static_fraction -> which preset 'adaptive' routes to)
  * matched / robust PSNR + s/LF (the routing's regret if it picks wrong)
  * default-preset PSNR (the quality reference for the matched budget)

Families (seedable via --seeds):
  two-plane      historical bench content (disp 1/2)         -> expect matched
  low-disp       two-plane disp 0/1 (round-3 regression case)
  occl3          3 layers disp 0.5/1.5/3, moving blobs
  occl-grad      occl3 + texture_grad 0.7 (near-flat left)
  static-min     two-plane disp 0/2 static-minority plane    -> robust regime
  static-flat    static bg + flat strip + one moving blob    -> expect robust

Usage: python experiments/content_family.py [--small] [--seeds 0 1 2]
                                            [--families f1 f2 ...]
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax  # noqa: E402
import numpy as np  # noqa: E402

from lfbm5d_tpu.config import preset_denoise_params  # noqa: E402
from lfbm5d_tpu.lf.metrics import psnr_device  # noqa: E402
from lfbm5d_tpu.lf.noise import add_noise_np  # noqa: E402
from lfbm5d_tpu.lf.synth import synthetic_lf, synthetic_lf_multi  # noqa: E402
from lfbm5d_tpu.pipeline import run_bm5d  # noqa: E402
from lfbm5d_tpu.pipeline.adaptive import select_preset  # noqa: E402
from lfbm5d_tpu.utils.cache import enable_persistent_compilation_cache  # noqa: E402


def make_lf(family: str, h: int, w: int, seed: int) -> np.ndarray:
    if family == "two-plane":
        return synthetic_lf(9, 9, h, w, 3, disp_bg=1, disp_fg=2, seed=seed)
    if family == "low-disp":
        return synthetic_lf(9, 9, h, w, 3, disp_bg=0, disp_fg=1, seed=seed)
    if family == "occl3":
        return synthetic_lf_multi(9, 9, h, w, 3, disps=(0.5, 1.5, 3.0),
                                  seed=seed, blob_frac=0.3)
    if family == "occl-grad":
        return synthetic_lf_multi(9, 9, h, w, 3, disps=(0.5, 1.5, 3.0),
                                  seed=seed, blob_frac=0.3, texture_grad=0.7)
    if family == "static-min":
        return synthetic_lf(9, 9, h, w, 3, disp_bg=0, disp_fg=2, seed=seed)
    if family == "static-flat":
        return synthetic_lf_multi(9, 9, h, w, 3, disps=(0.0, 2.0),
                                  seed=seed, blob_frac=0.25, flat_frac=0.4)
    raise SystemExit(f"unknown family {family}")


def run_preset(noisy_d, clean_d, preset: str, mpix: float, runs: int = 2):
    params = preset_denoise_params(preset, 25.0)
    jax.block_until_ready(run_bm5d(noisy_d, params))  # warm-up/compile
    times = []
    for _ in range(runs):
        t0 = time.time()
        _, final = jax.block_until_ready(run_bm5d(noisy_d, params))
        times.append(time.time() - t0)
    q = float(psnr_device(jax.numpy.clip(final, 0, 255), clean_d))
    return q, min(times), mpix / min(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="9x9x192x256 (for CPU smoke / quick look)")
    ap.add_argument("--seeds", type=int, nargs="*", default=[0])
    ap.add_argument("--families", nargs="*", default=[
        "two-plane", "low-disp", "occl3", "occl-grad", "static-min",
        "static-flat"])
    ap.add_argument("--presets", nargs="*",
                    default=["default", "matched", "robust"])
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    enable_persistent_compilation_cache()
    h, w = (192, 256) if args.small else (434, 625)
    mpix = 81 * h * w / 1e6

    for family in args.families:
        for seed in args.seeds:
            clean = make_lf(family, h, w, seed)
            noisy = add_noise_np(clean, 25.0, seed=seed + 100)
            clean_d = jax.device_put(clean.astype(np.float32))
            noisy_d = jax.device_put(noisy.astype(np.float32))
            routed, stats = select_preset(noisy_d, 25.0)
            line = (f"{family:12s} seed={seed} "
                    f"static_frac={stats['static_fraction']:.3f} "
                    f"routed={routed:7s}")
            for preset in args.presets:
                q, t, rate = run_preset(noisy_d, clean_d, preset, mpix, args.runs)
                line += f" | {preset}: {q:.3f} dB {t:.2f}s {rate:.1f}Mpix/s"
            print(line, flush=True)


if __name__ == "__main__":
    main()
