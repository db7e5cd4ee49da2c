"""Dense block-matching distance maps (hot loops A and B of SURVEY.md §3.1).

The C++ reference computes patch SSDs one candidate at a time inside nested
loops. The formulation here is displacement-stacked and dense: for each
displacement d of the search window, the squared-difference image
(I - shift(I, d))^2 is box-filtered with the k x k patch window, yielding the
SSD between the patch at every position and the patch displaced by d — one
vectorized map per displacement, scanned over the (2n+1)^2 window.

Shifts are realized with `lax.dynamic_slice` on a statically zero-extended
plane so every scan iteration has identical static shapes. The zero border can
only influence positions closer than the slice margin to the plane edge;
callers only ever sample positions in the interior (the LF is symmetrically
padded by n_search + n_disp before any of this runs), so the border garbage is
never read.

Candidate/displacement order is row-major (dy outer, dx inner) everywhere and
ties resolve to the first occurrence — the same convention as the float64
oracle, so candidate sets match exactly.

Distance quantization (parity-critical spec choice): near the mirrored
borders of the symmetric padding, two candidate patches can be exact
permutations of each other (reflection maps one onto the other), so their
SSDs tie in exact arithmetic and floating-point summation order would decide
the argmin differently in any two implementations (numpy pairwise vs XLA
reduce_window). To make matching deterministic across implementations and
dtypes, every BM distance is quantized to the nearest 1/8 in k^2-normalized
[0,255]^2 units (round-half-even) before ranking: exact ties then resolve by
scan order identically everywhere, and sub-0.125 cross-implementation float
noise cannot flip a comparison. 0.125 distance resolution against tau_match
thresholds of O(10^2..10^3) has no measurable quality effect.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

DIST_QUANT = 8.0  # quantization: distances are integers of 1/DIST_QUANT units


def displacements(n: int) -> np.ndarray:
    """Row-major displacement list [(2n+1)^2, 2] of (dy, dx) in [-n, n]."""
    r = np.arange(-n, n + 1)
    dy, dx = np.meshgrid(r, r, indexing="ij")
    return np.stack([dy.ravel(), dx.ravel()], axis=1).astype(np.int32)


def center_index(n: int) -> int:
    """Flat index of displacement (0, 0) in `displacements(n)`."""
    return n * (2 * n + 1) + n


def _box_sum(e, k: int):
    """Sliding k x k window sum, VALID: [H, W] -> [H-k+1, W-k+1]."""
    s = lax.reduce_window(e, 0.0, lax.add, (k, 1), (1, 1), "VALID")
    return lax.reduce_window(s, 0.0, lax.add, (1, k), (1, 1), "VALID")


def self_distances(plane, ys: np.ndarray, xs: np.ndarray, k: int, n: int):
    """Self-similarity SSDs at reference-grid positions.

    plane: [Hp, Wp] channel-0 SAI (padded). ys/xs: static top-left coordinate
    grids (padded coords). Returns [len(ys)*len(xs), (2n+1)^2] distances
    normalized by k^2, candidate axis in row-major window order.
    """
    hp, wp = plane.shape
    disp = jnp.asarray(displacements(n))
    ext = jnp.pad(plane, n)
    ysj = jnp.asarray(ys, dtype=jnp.int32)
    xsj = jnp.asarray(xs, dtype=jnp.int32)

    def body(_, d):
        shifted = lax.dynamic_slice(ext, (n + d[0], n + d[1]), (hp, wp))
        box = _box_sum((plane - shifted) ** 2, k)
        q = jnp.round(box[ysj][:, xsj] * (DIST_QUANT / (k * k)))
        return _, q.astype(jnp.int32)

    _, maps = lax.scan(body, 0, disp)  # [Ds, Ty, Tx]
    ds = maps.shape[0]
    return maps.reshape(ds, -1).T


def cross_argmin(ref_plane, other_plane, k: int, nd: int):
    """Disparity-compensated angular BM map (hot loop B).

    For every patch position q of `ref_plane`, the row-major-first-occurrence
    argmin over displacements d in [-nd, nd]^2 of
    SSD(ref_plane patch at q, other_plane patch at q + d).
    Returns [Hp-k+1, Wp-k+1] int32 flat displacement indices.
    """
    hp, wp = ref_plane.shape
    v0, v1 = hp - k + 1, wp - k + 1
    disp = displacements(nd)
    di = jnp.asarray(
        np.concatenate([np.arange(disp.shape[0], dtype=np.int32)[:, None], disp], 1)
    )
    ext = jnp.pad(other_plane, nd)
    init = (
        jnp.full((v0, v1), np.iinfo(np.int32).max, dtype=jnp.int32),
        jnp.zeros((v0, v1), dtype=jnp.int32),
    )

    def body(carry, d):
        best, bidx = carry
        shifted = lax.dynamic_slice(ext, (nd + d[1], nd + d[2]), (hp, wp))
        box = _box_sum((ref_plane - shifted) ** 2, k)
        q = jnp.round(box * (DIST_QUANT / (k * k))).astype(jnp.int32)
        better = q < best
        return (jnp.where(better, q, best), jnp.where(better, d[0], bidx)), None

    (best, bidx), _ = lax.scan(body, init, di)
    return bidx


def self_distances_batch(planes, ys, xs, k: int, n: int):
    """vmap of `self_distances` over a leading SAI axis."""
    return jax.vmap(lambda p: self_distances(p, ys, xs, k, n))(planes)


def _shifted_stack(plane, disps: np.ndarray, m: int):
    """[D, H, W] stack of plane shifted by each displacement (zero-extended).

    Static slices of the padded plane — a handful of large copies instead of
    a D-iteration scan of small ops."""
    hp, wp = plane.shape[-2:]
    ext = jnp.pad(plane, [(0, 0)] * (plane.ndim - 2) + [(m, m), (m, m)])
    return jnp.stack(
        [
            ext[..., m + dy : m + dy + hp, m + dx : m + dx + wp]
            for dy, dx in disps
        ],
        axis=0,
    )


def self_distances_batched(plane, ys, xs, k: int, n: int):
    """Displacement-batched variant of `self_distances` (identical results).

    One shifted stack + one squared-diff + one box-sum + one sample instead
    of a (2n+1)^2-step scan."""
    disp = displacements(n)
    stack = _shifted_stack(plane, disp, n)  # [D, Hp, Wp]
    e = (plane[None] - stack) ** 2
    s = lax.reduce_window(e, 0.0, lax.add, (1, k, 1), (1, 1, 1), "VALID")
    box = lax.reduce_window(s, 0.0, lax.add, (1, 1, k), (1, 1, 1), "VALID")
    q = jnp.round(
        box[:, ys][:, :, xs] * (DIST_QUANT / (k * k))
    ).astype(jnp.int32)
    ds = q.shape[0]
    return q.reshape(ds, -1).T  # [T, D]


def cross_argmin_all(ref_plane, planes, k: int, nd: int, a_chunk: int = 16):
    """First-occurrence disparity argmin maps against EVERY SAI at once.

    planes: [A, Hp, Wp]. Returns [A, Hp-k+1, Wp-k+1] int32 flat displacement
    indices (row-major window order, first occurrence on ties — matching
    `cross_argmin`). Chunks the SAI axis to bound the [D, Ac, Hp, Wp]
    intermediate.
    """
    a = planes.shape[0]
    disp = displacements(nd)
    outs = []
    for a0 in range(0, a, a_chunk):
        chunk = planes[a0 : a0 + a_chunk]  # [Ac, Hp, Wp]
        stack = _shifted_stack(chunk, disp, nd)  # [D, Ac, Hp, Wp]
        e = (ref_plane[None, None] - stack) ** 2
        s = lax.reduce_window(e, 0.0, lax.add, (1, 1, k, 1), (1, 1, 1, 1), "VALID")
        box = lax.reduce_window(s, 0.0, lax.add, (1, 1, 1, k), (1, 1, 1, 1), "VALID")
        q = jnp.round(box * (DIST_QUANT / (k * k))).astype(jnp.int32)
        outs.append(jnp.argmin(q, axis=0).astype(jnp.int32))  # [Ac, V0, V1]
    return jnp.concatenate(outs, axis=0)
