"""End-to-end disk->disk streaming measurement (config 5 with I/O included).

In-memory streaming numbers exclude I/O (device-resident inputs). This
bench measures the whole deployment loop: PNG decode -> denoise ->
PNG encode, overlapped by pipeline/stream_io.py's lookahead/encoder pools.
It reports per-LF wall seconds, the device-blocked share, and the implied
Mpix/s including all host codec work.

Usage: python experiments/stream_io_bench.py [--n 4] [--preset matched]
                                             [--hw 434 625] [--a 9]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from lfbm5d_tpu.config import preset_denoise_params  # noqa: E402
from lfbm5d_tpu.lf.io import load_lf, save_lf  # noqa: E402
from lfbm5d_tpu.lf.metrics import psnr  # noqa: E402
from lfbm5d_tpu.lf.noise import add_noise_np  # noqa: E402
from lfbm5d_tpu.lf.synth import synthetic_lf  # noqa: E402
from lfbm5d_tpu.pipeline.stream_io import stream_denoise_dirs  # noqa: E402
from lfbm5d_tpu.utils.cache import enable_persistent_compilation_cache  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--preset", default="matched")
    ap.add_argument("--a", type=int, default=9)
    ap.add_argument("--hw", type=int, nargs=2, default=[434, 625])
    ap.add_argument("--sigma", type=float, default=25.0)
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()
    enable_persistent_compilation_cache()
    a, (h, w) = args.a, args.hw
    pattern = "SAI_%02d_%02d.png"

    root = tempfile.mkdtemp(prefix="stream_io_bench_")
    print(f"staging {args.n} noisy {a}x{a}x{h}x{w} LFs under {root}",
          flush=True)
    cleans = []
    jobs = []
    for i in range(args.n):
        clean = synthetic_lf(a, a, h, w, channels=3, disp_bg=1, disp_fg=2,
                             seed=i)
        noisy = add_noise_np(clean, args.sigma, seed=100 + i)
        in_dir = os.path.join(root, f"in_{i:02d}")
        os.makedirs(in_dir)
        save_lf(noisy, in_dir, pattern)
        cleans.append(clean)
        jobs.append((in_dir, os.path.join(root, f"out_{i:02d}")))

    params = preset_denoise_params(args.preset, args.sigma, chunk=128)

    # warm-up job compiles the program so the timed stream measures the
    # steady state (a deployment stream's first LF pays compile once)
    warm = stream_denoise_dirs(jobs[:1], params, a, a, pattern=pattern)
    t0 = time.perf_counter()
    report = stream_denoise_dirs(jobs, params, a, a, pattern=pattern)
    wall = time.perf_counter() - t0

    mpix = a * a * h * w / 1e6
    psnrs = []
    for i, (in_dir, out_dir) in enumerate(jobs):
        out = load_lf(out_dir, pattern, a, a)
        psnrs.append(round(psnr(out, cleans[i]), 3))

    print(json.dumps({
        "preset": args.preset, "n_lfs": args.n,
        "shape": [a, a, h, w, 3],
        "wall_s": round(wall, 3),
        "s_per_lf": round(wall / args.n, 3),
        "mpix_s_disk_to_disk": round(args.n * mpix / wall, 3),
        "device_blocked_s": round(report.seconds_device, 3),
        "device_fraction": round(report.seconds_device / wall, 3),
        "warmup_first_lf_s": round(warm.lf_seconds[0], 1),
        "lf_seconds": [round(t, 3) for t in report.lf_seconds],
        "psnr_db": psnrs,
        "n_failed": report.n_failed,
    }), flush=True)
    if not args.keep:
        shutil.rmtree(root)


if __name__ == "__main__":
    main()
