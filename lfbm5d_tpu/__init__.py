"""lfbm5d_tpu — light-field denoising and super-resolution in JAX.

A from-scratch JAX rebuild of the capabilities of V-Sense/LFBM5D
(BM3D-style sparse 5D transform-domain collaborative filtering over the full
sub-aperture-image grid of a light field), designed grid-at-a-time and dense
for an accelerator rather than patch-at-a-time like the C++ reference. The
whole pipeline is plain jax.numpy/lax compiled by XLA; it runs on a GPU, and
on the CPU for tests.

Reference provenance: the reference mount was empty during the survey session
(see SURVEY.md §0); the algorithm spec implemented here is SURVEY.md §2.10,
derived from the LFBM5D papers (MMSP 2017, ICIP 2018) and the IPOL BM3D
lineage, and anchored by the float64 NumPy oracle in `lfbm5d_tpu.oracle`.
"""

from lfbm5d_tpu.config import (  # noqa: F401
    StepParams,
    DenoiseParams,
    SRParams,
    default_ht_params,
    default_wiener_params,
    default_denoise_params,
)

__version__ = "0.1.0"
