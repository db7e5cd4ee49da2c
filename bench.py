"""Benchmark harness: one denoise cell on the GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "Mpix/s", ...}

Default config is the headline BASELINE.json metric: a 9x9 light field at
EPFL-Lytro resolution (434x625 RGB), sigma=25 AWGN, full two-step HT+Wiener
in OPP color space, at the `matched` preset (config.PRESETS).

No LF datasets are downloaded, so the LF is synthetic with genuine disparity
structure (lf/synth.py, seed 0; noise seed 1); PSNR against the clean LF is
reported alongside throughput.

Measurement protocol: the first run is compile plus warm-up and is never
counted; the timed loop then takes --runs samples (default 3), each ended by
jax.block_until_ready, and reports min plus every sample and the spread.
The device (platform, device_kind, count) and the card's nvidia-smi name and
power limit go to stderr; the script exits non-zero when JAX finds no GPU.

Usage: python bench.py [--quick] [--preset default|fast|matched|robust|...]
                       [--runs N] [--family ...] [--profile DIR]
"""

import argparse
import json
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small LF (3x3x96x128) smoke test")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--preset", default=None,
                    choices=["default", "fast", "matched", "robust",
                             "adaptive", "adaptive-region"],
                    help="'default' = reference-default parameters; 'fast' = "
                    "throughput preset (N=8, p=6, smaller search windows); "
                    "'matched' = fastest preset measured at-or-above "
                    "reference-default PSNR on the bench LF (the headline "
                    "default); 'robust' = within 0.05 dB of default on "
                    "every tested content class; 'adaptive' = content "
                    "probe routes matched/robust per LF — the probe runs "
                    "INSIDE the timed loop")
    ap.add_argument("--sigma", type=float, default=25.0)
    ap.add_argument("--family", default="two-plane",
                    choices=["two-plane", "low-disp", "occl3", "occl-grad",
                             "static-min", "static-flat"],
                    help="bench LF content family (lf/synth.py; default = "
                    "the historical two-plane bench LF). 'occl-grad' is the "
                    "weak-texture class the adaptive router sends to robust "
                    "— '--preset adaptive --family occl-grad' is the "
                    "routed-content row")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="dump a jax.profiler trace of the measured runs "
                    "to DIR and print its device summary (SURVEY.md §5.1)")
    args = ap.parse_args()

    import jax

    from lfbm5d_tpu.utils.cache import enable_persistent_compilation_cache
    from lfbm5d_tpu.utils.device import nvidia_smi_name_power, require_gpu

    device = require_gpu()
    print(f"device: {device}", file=sys.stderr)
    for line in nvidia_smi_name_power():
        print(f"nvidia-smi: {line}", file=sys.stderr)
    enable_persistent_compilation_cache()

    from lfbm5d_tpu.config import preset_denoise_params
    from lfbm5d_tpu.lf import psnr, psnr_device, synthetic_lf
    from lfbm5d_tpu.lf.noise import add_noise_np
    from lfbm5d_tpu.pipeline import run_bm5d

    if args.quick:
        a_h = a_w = 3
        h, w = 96, 128
    else:
        a_h = a_w = 9
        h, w = 434, 625

    if args.preset is None:
        args.preset = "fast" if args.quick else "matched"
    adaptive = args.preset in ("adaptive", "adaptive-region")
    if not adaptive:
        params = preset_denoise_params(args.preset, args.sigma, chunk=128)

    t0 = time.time()
    if args.family == "two-plane":
        clean = synthetic_lf(a_h, a_w, h, w, channels=3, disp_bg=1,
                             disp_fg=2, seed=0)
    else:
        # same family definitions as experiments/content_family.py (the
        # round-4 validation matrix) at the bench shape, seed 0
        from lfbm5d_tpu.lf.synth import synthetic_lf_multi

        fam = {
            "low-disp": lambda: synthetic_lf(
                a_h, a_w, h, w, 3, disp_bg=0, disp_fg=1, seed=0),
            "occl3": lambda: synthetic_lf_multi(
                a_h, a_w, h, w, 3, disps=(0.5, 1.5, 3.0), seed=0,
                blob_frac=0.3),
            "occl-grad": lambda: synthetic_lf_multi(
                a_h, a_w, h, w, 3, disps=(0.5, 1.5, 3.0), seed=0,
                blob_frac=0.3, texture_grad=0.7),
            "static-min": lambda: synthetic_lf(
                a_h, a_w, h, w, 3, disp_bg=0, disp_fg=2, seed=0),
            "static-flat": lambda: synthetic_lf_multi(
                a_h, a_w, h, w, 3, disps=(0.0, 2.0), seed=0,
                blob_frac=0.25, flat_frac=0.4),
        }
        clean = fam[args.family]()
    noisy = add_noise_np(clean, args.sigma, seed=1)
    print(f"synth LF {clean.shape} in {time.time()-t0:.1f}s", file=sys.stderr)

    # The metric times the denoise compute, not the host->device copy:
    # the input goes to the device once, before the timed loop.
    import jax.numpy as jnp

    noisy_dev = jnp.asarray(noisy, jnp.float32)
    jax.block_until_ready(noisy_dev)

    selected = None
    if adaptive:
        # content probe (host, two SAIs) re-runs INSIDE the timed loop —
        # the adaptive row's cost includes choosing the preset. The probe
        # reads the host copy of the noisy LF (real drivers hold the LF on
        # the host, where it was loaded).
        from lfbm5d_tpu.pipeline.adaptive import (
            denoise_region_adaptive,
            select_preset,
        )

        if args.preset == "adaptive-region":
            # probe + (possibly) region compositing inside the timed loop
            def run_once():
                basic, final, info = denoise_region_adaptive(
                    noisy_dev, args.sigma
                )
                return info["mode"], (basic, final)
        else:
            def run_once():
                name, _ = select_preset(noisy, args.sigma)
                p = preset_denoise_params(name, args.sigma, chunk=128)
                return name, run_bm5d(noisy_dev, p)

        t0 = time.time()
        selected, (basic, final) = run_once()
        jax.block_until_ready(final)
        compile_and_first = time.time() - t0
        print(f"adaptive probe selected preset: {selected}", file=sys.stderr)
    else:
        def run_once():
            return args.preset, run_bm5d(noisy_dev, params)

        # warmup / compile
        t0 = time.time()
        basic, final = run_bm5d(noisy_dev, params)
        jax.block_until_ready(final)
        compile_and_first = time.time() - t0
    print(f"compile+first run: {compile_and_first:.1f}s", file=sys.stderr)

    if args.profile:
        jax.profiler.start_trace(args.profile)
    times = []
    for _ in range(args.runs):
        t0 = time.time()
        selected, (basic, final) = run_once()
        jax.block_until_ready((basic, final))
        times.append(time.time() - t0)
    dt = min(times)
    spread = (max(times) - min(times)) / min(times)
    if args.profile:
        jax.profiler.stop_trace()
        print(f"profiler trace written to {args.profile}", file=sys.stderr)
        from lfbm5d_tpu.utils.profiling import summarize_trace

        print(summarize_trace(args.profile), file=sys.stderr)

    mpix = a_h * a_w * h * w / 1e6
    value = mpix / dt
    p_noisy = psnr(np.clip(noisy, 0, 255), clean)
    # PSNR reductions on-device: only the scalar MSE comes back
    p_final = psnr_device(final, clean)
    p_basic = psnr_device(basic, clean)

    tag = "quick smoke config" if args.quick else "9x9 EPFL-scale headline"
    fam_tag = "" if args.family == "two-plane" else f" family={args.family},"
    result = {
        "metric": (
            f"Mpix/s denoised, two-step HT+Wiener, "
            f"{a_h}x{a_w}x{h}x{w} RGB synthetic LF,{fam_tag} "
            f"sigma={args.sigma:g}, preset={args.preset} ({tag})"
        ),
        "value": round(value, 3),
        "unit": "Mpix/s",
        "device": device,
        "seconds_per_lf": round(dt, 3),
        "run_seconds": [round(t, 3) for t in times],
        "spread_frac": round(spread, 3),
        "compile_plus_first_s": round(compile_and_first, 1),
        "mpix": round(mpix, 2),
        "psnr_noisy_db": round(p_noisy, 2),
        "psnr_basic_db": round(p_basic, 2),
        "psnr_final_db": round(p_final, 2),
        "preset": args.preset,
        "family": args.family,
        "shape": [a_h, a_w, h, w, 3],
        "quick": bool(args.quick),
    }
    if adaptive:
        result["adaptive_selected"] = selected
    print(json.dumps(result))


if __name__ == "__main__":
    main()
