"""High-level denoiser API over the two-step pipeline.

The reference exposes only a CLI (SURVEY.md §1: "the CLI is the only
supported API; there is no library packaging"); this class is the library
packaging the rebuild adds: construct once with parameters, then call on any
number of light fields (single or batched/sharded).
"""

from __future__ import annotations

import numpy as np

from lfbm5d_tpu.config import DenoiseParams
from lfbm5d_tpu.lf.metrics import psnr


class LFDenoiser:
    """Two-step (HT -> Wiener) LFBM5D light-field denoiser.

    Example:
        den = LFDenoiser(DenoiseParams(sigma=25.0))
        basic, final = den(noisy_lf)                   # one LF
        basics, finals = den.batch(lfs, mesh=mesh)      # sharded batch
    """

    def __init__(self, params: DenoiseParams | None = None,
                 dtype: str = "float32"):
        self.params = params or DenoiseParams()
        self.dtype = dtype

    def __call__(self, noisy_lf):
        from lfbm5d_tpu.pipeline import run_bm5d

        return run_bm5d(noisy_lf, self.params, dtype=self.dtype)

    def denoise(self, noisy_lf):
        """Returns only the final estimate as a numpy array."""
        _, final = self(noisy_lf)
        return np.asarray(final)

    def batch(self, lfs, mesh=None):
        """Denoise [B, aH, aW, H, W, C]; shard over `mesh` when given."""
        from lfbm5d_tpu.pipeline.streaming import denoise_batch

        return denoise_batch(lfs, self.params, mesh=mesh, dtype=self.dtype)

    def evaluate(self, noisy_lf, clean_lf) -> dict:
        """Denoise and report PSNRs against a clean reference."""
        basic, final = self(noisy_lf)
        basic, final = np.asarray(basic), np.asarray(final)
        return {
            "psnr_noisy_db": psnr(np.clip(np.asarray(noisy_lf), 0, 255), clean_lf),
            "psnr_basic_db": psnr(np.clip(basic, 0, 255), clean_lf),
            "psnr_final_db": psnr(np.clip(final, 0, 255), clean_lf),
        }
