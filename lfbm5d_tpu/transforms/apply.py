"""Separable 5D group transform as batched einsums.

A 5D group is a tensor [B, N, aH, aW, k, k, C]: B groups per batch, N-deep
similarity stack, aH x aW angular grid (one patch per SAI), k x k spatial
patch, C channels. The forward transform is tau_2D on (k, k), tau_4D on
(aH, aW), tau_5D along N (SURVEY.md §2.10.6); every factor is a small matrix
from `lfbm5d_tpu.transforms.matrices`, applied with einsum so XLA lowers the
whole chain to batched matmuls.

The stack transform is selected PER GROUP by `lvl = log2(stack_size)` (the
power-of-two truncation of §2.10.4): `stack_matrices` zero-pads each size's
matrix to N x N, so gathering the per-group matrix and batch-matmuling it
handles variable group sizes with fully static shapes.

Every product runs at `Precision.HIGHEST`: at default precision an f32
matmul may run in TF32 on the GPU, and its ~1e-3 relative error reaches the
Wiener step's block matching (which matches on the HT output with distances
quantized to integers), so it can change candidate sets, not only last bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax.numpy as jnp
import numpy as np
from jax import lax

from lfbm5d_tpu.config import StepParams
from lfbm5d_tpu.transforms import matrices as tm


@dataclass(frozen=True)
class GroupTransforms:
    """Baked transform constants for one step's group geometry."""

    f2: Any
    i2: Any
    f4s: Any  # None when tau_4d == 'id'
    f4t: Any
    i4s: Any
    i4t: Any
    stack_f: Any  # [log2(N)+1, N, N]
    stack_i: Any

    @staticmethod
    def build(
        params: StepParams, a_h: int, a_w: int, dtype=jnp.float32
    ) -> "GroupTransforms":
        f2, i2 = tm.transform_pair(params.tau_2d, params.k)
        if params.tau_4d == "id":
            f4s = f4t = i4s = i4t = None
        else:
            f4s, i4s = tm.transform_pair(params.tau_4d, a_h)
            f4t, i4t = tm.transform_pair(params.tau_4d, a_w)
        sf, si = tm.stack_matrices(params.tau_5d, params.n_sim)

        def j(x):
            return None if x is None else jnp.asarray(np.asarray(x), dtype=dtype)

        return GroupTransforms(
            f2=j(f2), i2=j(i2), f4s=j(f4s), f4t=j(f4t), i4s=j(i4s), i4t=j(i4t),
            stack_f=j(sf), stack_i=j(si),
        )


def _ein(spec, a, b):
    return jnp.einsum(spec, a, b, precision=lax.Precision.HIGHEST)


def forward_5d(g, lvl, t: GroupTransforms):
    """Forward separable 5D transform.

    g: [B, N, aH, aW, k, k, C]; lvl: [B] int32 stack-size log2 per group.
    """
    g = _ein("uq,bnstqvc->bnstuvc", t.f2, g)
    g = _ein("vq,bnstuqc->bnstuvc", t.f2, g)
    if t.f4s is not None:
        g = _ein("sq,bnqtuvc->bnstuvc", t.f4s, g)
        g = _ein("tq,bnsquvc->bnstuvc", t.f4t, g)
    m = t.stack_f[lvl]  # [B, N, N]
    g = _ein("bnq,bqstuvc->bnstuvc", m, g)
    return g


def inverse_5d(g, lvl, t: GroupTransforms):
    """Inverse separable 5D transform (stack -> angular -> spatial)."""
    m = t.stack_i[lvl]
    g = _ein("bnq,bqstuvc->bnstuvc", m, g)
    if t.i4s is not None:
        g = _ein("sq,bnqtuvc->bnstuvc", t.i4s, g)
        g = _ein("tq,bnsquvc->bnstuvc", t.i4t, g)
    g = _ein("uq,bnstqvc->bnstuvc", t.i2, g)
    g = _ein("vq,bnstuqc->bnstuvc", t.i2, g)
    return g
