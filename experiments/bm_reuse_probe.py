"""Cross-step BM reuse, phase 1: the QUALITY question (round-5 item 1).

The Wiener step re-runs both BM stages on the basic estimate (SURVEY.md
§2.10 step 2), recomputing tables the HT step just built on the noisy LF.
Reusing the HT
tables outright changes the algorithm: Wiener groups inherit the noisy-LF
BM decisions and the HT threshold. Before building the table-reuse fast
path, this probe measures what that SEMANTIC change costs in PSNR, via the
already-exact `StepParams.bm_source='noisy'` mode (oracle-pinned in
tests/test_xla_engine.py).

Variants at the flagship bench LF (9x9x434x625 RGB sigma=25), all on the
matched preset base:
  anchor   wiener: BM on basic, tau=400   (reference semantics; 28.418 dB)
  reuse    wiener: BM on noisy, tau=2500  (exact cross-step reuse: tables
                                           IDENTICAL to the HT step's)
  adj      wiener: BM on noisy, tau=1650  (noise-adjusted re-threshold:
                                           tau_w + 2*sigma0^2 — noisy SSDs
                                           carry a 2 sigma^2 noise floor;
                                           reusable from saved distances)
  naive    wiener: BM on noisy, tau=400   (un-adjusted: expected to reject
                                           nearly all candidates — the
                                           control showing WHY tau must
                                           move with the BM source)

Budget: within 0.05 dB of the reference-default anchor 28.416 dB.
Speed here is NOT the point (bm_source only changes the match input; both
steps still compute BM).

Usage: python experiments/bm_reuse_probe.py [--small] [--variants ...]
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
from lfbm5d_tpu.lf.synth import synthetic_lf  # noqa: E402
from lfbm5d_tpu.pipeline import run_bm5d  # noqa: E402
from lfbm5d_tpu.utils.cache import enable_persistent_compilation_cache  # noqa: E402

VARIANTS = {
    "anchor": dict(),
    "reuse": dict(bm_source="noisy", tau_match=2500.0),
    "adj": dict(bm_source="noisy", tau_match=1650.0),
    "naive": dict(bm_source="noisy", tau_match=400.0),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    enable_persistent_compilation_cache()
    h, w = (192, 256) if args.small else (434, 625)
    mpix = 81 * h * w / 1e6

    clean = synthetic_lf(9, 9, h, w, 3, disp_bg=1, disp_fg=2, seed=args.seed)
    noisy = add_noise_np(clean, 25.0, seed=args.seed + 1)
    clean_d = jax.device_put(clean.astype(np.float32))
    noisy_d = jax.device_put(noisy.astype(np.float32))

    for name in args.variants:
        over = VARIANTS[name]
        params = preset_denoise_params("matched", 25.0, chunk=128)
        if over:
            params = params.replace(wiener=params.wiener.replace(**over))
        t0 = time.time()
        _, final = jax.block_until_ready(run_bm5d(noisy_d, params))
        compile_s = time.time() - t0
        times = []
        for _ in range(args.runs):
            t0 = time.time()
            _, final = jax.block_until_ready(run_bm5d(noisy_d, params))
            times.append(time.time() - t0)
        q = float(psnr_device(jax.numpy.clip(final, 0, 255), clean_d))
        dt = min(times)
        print(
            f"{name:7s} wiener(bm={params.wiener.bm_source},"
            f"tau={params.wiener.tau_match:g}): {q:.3f} dB  {dt:.3f} s/LF "
            f"({mpix/dt:.2f} Mpix/s)  compile+first {compile_s:.1f}s "
            f"runs={[round(t, 3) for t in times]}",
            flush=True,
        )


if __name__ == "__main__":
    main()
