"""Config-5 streaming throughput on the device.

Measures, in ONE session (same-session numbers are the only comparable kind):
  1. single-LF rate through run_bm5d,
  2. denoise_batch with mesh=None at B in {1,2,4,8} (one vmapped program
     over the batch — the single-device streaming form),
  3. denoise_batch over a 1-device mesh at the same B (shard_map around the
     same vmapped program) — isolates what the mesh wrapper costs.

Usage: python experiments/streaming_bench.py [--batches 1 2 4 8]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--shape", type=int, nargs=3, default=[5, 192, 256])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--preset", default="fast",
                    help="named preset from config.PRESETS")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lfbm5d_tpu.config import preset_denoise_params
    from lfbm5d_tpu.lf import synthetic_lf
    from lfbm5d_tpu.lf.noise import add_noise_np
    from lfbm5d_tpu.parallel import make_mesh
    from lfbm5d_tpu.pipeline import run_bm5d
    from lfbm5d_tpu.pipeline.streaming import denoise_batch
    from lfbm5d_tpu.utils.cache import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()

    a, h, w = args.shape
    params = preset_denoise_params(args.preset, 25.0, chunk=128)
    mpix = a * a * h * w / 1e6
    bmax = max(args.batches)
    rng_lfs = []
    for i in range(bmax):
        clean = synthetic_lf(a, a, h, w, channels=3, disp_bg=1, disp_fg=2,
                             seed=i)
        rng_lfs.append(add_noise_np(clean, 25.0, seed=100 + i))
    lfs = jnp.asarray(np.stack(rng_lfs), jnp.float32)
    jax.block_until_ready(lfs)

    def timed(fn):
        jax.block_until_ready(fn())  # compile + warm-up
        ts = []
        for _ in range(args.runs):
            t0 = time.time()
            jax.block_until_ready(fn())
            ts.append(time.time() - t0)
        return min(ts)

    # 1. single-LF baseline
    single = timed(lambda: run_bm5d(lfs[0], params))
    print(json.dumps({"case": "single_lf", "s_per_lf": round(single, 3),
                      "mpix_s": round(mpix / single, 3)}), flush=True)

    # 2. vmapped batch (mesh=None) and 3. the same over a 1-device mesh
    mesh = make_mesh(1)
    for case, m in (("vmap", None), ("shard_map_mesh1", mesh)):
        for b in args.batches:
            dt = timed(lambda: denoise_batch(lfs[:b], params, mesh=m)) / b
            print(json.dumps({"case": f"{case}_B{b}",
                              "s_per_lf": round(dt, 3),
                              "mpix_s": round(mpix / dt, 3),
                              "overhead_vs_single_pct":
                              round(100 * (dt / single - 1), 1)}), flush=True)


if __name__ == "__main__":
    main()
