"""High-level super-resolution API (reference SR branch, ICIP18)."""

from __future__ import annotations

import numpy as np

from lfbm5d_tpu.config import SRParams


class LFSuperResolver:
    """LFBM5D-SR: bicubic init + [5D-sparse-prior filter, back-projection]."""

    def __init__(self, params: SRParams | None = None,
                 dtype: str = "float32"):
        self.params = params or SRParams()
        self.dtype = dtype

    def __call__(self, lr_lf, on_iteration=None):
        from lfbm5d_tpu.pipeline.sr import run_sr

        return run_sr(lr_lf, self.params, on_iteration=on_iteration,
                      dtype=self.dtype)

    def upscale(self, lr_lf) -> np.ndarray:
        return np.asarray(self(lr_lf))
