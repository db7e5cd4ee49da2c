"""Probe of the flat-region fallback (StepParams.flat_tau) on the device.

Measures the matched-preset flagship shape on half-flat synthetic content
(synthetic_lf flat_frac=0.5) with the fallback off/on: wall time per LF and
PSNR vs clean. Usage:
    python experiments/flat_probe.py [flat_frac] [preset] [flat_tau]
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
    flat_frac = float(sys.argv[1]) if len(sys.argv) > 1 else 0.5
    preset = sys.argv[2] if len(sys.argv) > 2 else "matched"
    flat_tau = float(sys.argv[3]) if len(sys.argv) > 3 else 1.3

    clean = synthetic_lf(9, 9, 434, 625, 3, disp_bg=1, disp_fg=2, seed=0,
                         flat_frac=flat_frac)
    noisy = add_noise_np(clean, 25.0, seed=1)
    clean_d = jax.device_put(clean.astype(np.float32))
    noisy_d = jax.device_put(noisy.astype(np.float32))
    mpix = clean[..., 0].size / 1e6

    for tau in (0.0, flat_tau):
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
            basic, final = jax.block_until_ready(run_bm5d(noisy_d, params))
            times.append(time.time() - t0)
        q = psnr_device(jax.numpy.clip(final, 0, 255), clean_d)
        best = min(times)
        print(f"preset={preset} flat_frac={flat_frac} flat_tau={tau}: "
              f"{best:.3f} s/LF ({mpix/best:.2f} Mpix/s), PSNR {q:.3f} dB, "
              f"runs={[round(t, 3) for t in times]}, "
              f"compile+first {compile_s:.1f}s", flush=True)


if __name__ == "__main__":
    main()
