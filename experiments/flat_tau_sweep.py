"""flat_tau threshold sweep.

The flat fallback shipped with flat_tau=1.3 in the `matched` preset,
validated at exactly two points (0 and 1.3). This sweep measures the
PSNR/throughput trade across thresholds on BOTH content classes:

  * flat_frac=0.0 — fully textured (the bench LF): the fallback must not
    cost quality when it barely triggers; higher tau risks misclassifying
    weak texture as flat.
  * flat_frac=0.5 — half the background genuinely flat: the regime the
    fallback targets.

Usage: python experiments/flat_tau_sweep.py [preset] [taus...]
"""

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


def main():
    enable_persistent_compilation_cache()
    preset = sys.argv[1] if len(sys.argv) > 1 else "matched"
    taus = [float(v) for v in sys.argv[2:]] or [0.0, 0.8, 1.3, 2.0]

    for flat_frac in (0.0, 0.5):
        clean = synthetic_lf(9, 9, 434, 625, 3, disp_bg=1, disp_fg=2, seed=0,
                             flat_frac=flat_frac)
        noisy = add_noise_np(clean, 25.0, seed=1)
        clean_d = jax.device_put(clean.astype(np.float32))
        noisy_d = jax.device_put(noisy.astype(np.float32))
        mpix = clean[..., 0].size / 1e6
        for tau in taus:
            params = preset_denoise_params(preset, 25.0)
            params = params.replace(
                ht=params.ht.replace(flat_tau=tau),
                wiener=params.wiener.replace(flat_tau=tau),
            )
            t0 = time.time()
            jax.block_until_ready(run_bm5d(noisy_d, params))
            compile_s = time.time() - t0
            times = []
            for _ in range(3):
                t0 = time.time()
                basic, final = jax.block_until_ready(
                    run_bm5d(noisy_d, params))
                times.append(time.time() - t0)
            q = psnr_device(jax.numpy.clip(final, 0, 255), clean_d)
            best = min(times)
            print(f"preset={preset} flat_frac={flat_frac} flat_tau={tau}: "
                  f"{best:.3f} s/LF ({mpix/best:.2f} Mpix/s), "
                  f"PSNR {q:.3f} dB, runs={[round(t, 3) for t in times]}, "
                  f"compile+first {compile_s:.1f}s", flush=True)


if __name__ == "__main__":
    main()
