"""SR preset knee sweep (the source of config.SR_SCHEDULES).

Protocol: clean 9x9x434x624 synthetic LF -> box-decimated x2 LR -> bicubic
init -> [LFBM5D filter, IBP] loop; PSNR of the HR estimate vs clean. The
sweep varies the knobs that set the quality/cost knee:

  * step preset (the per-iteration filter cost)
  * n_iter (total cost is ~linear in it)
  * sigma_init of the decreasing schedule (sigma_final pinned at 1)

Usage: python experiments/sr_knee.py [--scale 2] [--hw 434 624]
         [--presets matched] [--iters 3 5 8] [--sigmas 8 12 16]
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

from lfbm5d_tpu.config import SRParams, preset_denoise_params  # noqa: E402
from lfbm5d_tpu.lf.metrics import psnr_device  # noqa: E402
from lfbm5d_tpu.lf.resize import downsample, upsample  # noqa: E402
from lfbm5d_tpu.lf.synth import synthetic_lf  # noqa: E402
from lfbm5d_tpu.pipeline.sr import run_sr  # noqa: E402
from lfbm5d_tpu.utils.cache import enable_persistent_compilation_cache  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--a", type=int, default=9)
    ap.add_argument("--hw", type=int, nargs=2, default=[434, 624])
    ap.add_argument("--presets", nargs="*", default=["matched"])
    ap.add_argument("--iters", type=int, nargs="*", default=[3, 5, 8])
    ap.add_argument("--sigmas", type=float, nargs="*", default=[8.0, 12.0, 16.0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    enable_persistent_compilation_cache()
    a, (h, w) = args.a, args.hw

    clean = synthetic_lf(a, a, h, w, channels=3, disp_bg=1, disp_fg=2,
                         seed=args.seed)
    clean_d = jax.device_put(clean.astype(np.float32))
    lr = downsample(clean_d, args.scale)
    jax.block_until_ready(lr)
    bicubic = jnp.clip(upsample(lr, args.scale), 0, 255)
    print(json.dumps({"bicubic_psnr_db": round(psnr_device(bicubic, clean_d), 3)}),
          flush=True)
    mpix = a * a * h * w / 1e6

    for preset in args.presets:
        dn = preset_denoise_params(preset, 25.0, chunk=128)
        for sigma_init in args.sigmas:
            for n_iter in args.iters:
                params = SRParams(
                    scale=args.scale, n_iter=n_iter,
                    sigma_init=sigma_init, sigma_final=1.0,
                    ht=dn.ht, wiener=dn.wiener, chunk=dn.chunk,
                )
                t0 = time.time()
                hr = run_sr(lr, params)
                q = psnr_device(jnp.clip(hr, 0, 255), clean_d)
                compile_first = time.time() - t0
                t0 = time.time()
                hr = run_sr(lr, params)
                q = psnr_device(jnp.clip(hr, 0, 255), clean_d)
                run_s = time.time() - t0
                print(json.dumps({
                    "step_preset": preset, "n_iter": n_iter,
                    "sigma_init": sigma_init,
                    "psnr_db": round(float(q), 3),
                    "s_per_lf": round(run_s, 2),
                    "mpix_s_hr": round(mpix / run_s, 3),
                    "compile_first_s": round(compile_first, 1),
                }), flush=True)


if __name__ == "__main__":
    main()
