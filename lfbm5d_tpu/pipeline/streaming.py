"""Batched multi-LF streaming throughput (driver config 5).

Shards a batch of light fields over the device mesh: each device runs the
full two-step pipeline on its sub-batch (vmap over the local shard inside
shard_map). No cross-chip communication is needed inside a light field
(SURVEY.md §5.8) — collectives appear only if a reduction over the batch is
requested by the caller.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from lfbm5d_tpu.config import DenoiseParams
from lfbm5d_tpu.pipeline.denoise import _sigma_channels, build_denoise_fn


@lru_cache(maxsize=None)
def _jit_per_lf(fn):
    """Cache jit wrappers across calls: a fresh jax.jit(fn) per call
    re-traces the whole pipeline on its first use."""
    return jax.jit(fn)


@lru_cache(maxsize=None)
def _jit_vmapped(fn):
    return jax.jit(jax.vmap(fn, in_axes=(0, None)))


@lru_cache(maxsize=None)
def _jit_sharded_vmap(fn, mesh, axis):
    # check_vma=False: the per-LF pipeline uses no collectives, and its
    # scan carries are initialized replicated (vma tracking rejects them).
    return jax.jit(shard_map(
        jax.vmap(fn, in_axes=(0, None)),
        mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    ))


def _run_with_retry(call, args, retries: int, on_fail: str, fallback):
    """Driver-level failure isolation (SURVEY.md §5.3): retry a per-LF (or
    per-chunk) device call, then degrade per `on_fail`.

    'raise' re-raises; 'identity' substitutes `fallback()` (the noisy
    input as both basic and final — the batch survives, the bad LF is
    reported). Returns (result, n_attempts, error_or_None)."""
    err = None
    for attempt in range(retries + 1):
        try:
            return call(*args), attempt + 1, None
        except Exception as e:  # XlaRuntimeError etc. — device faults
            err = e
    if on_fail == "identity":
        return fallback(), retries + 1, err
    raise err


def denoise_batch(
    lfs,
    params: DenoiseParams,
    mesh: Mesh | None = None,
    dtype: str = "float32",
    retries: int = 0,
    on_fail: str = "raise",
    return_report: bool = False,
):
    """Denoise a batch of LFs [B, aH, aW, H, W, C].

    With a mesh, the batch axis is sharded over the mesh's single axis
    (B must be divisible by the axis size) and each device vmaps the
    pipeline over its local shard; whole LFs stay embarrassingly parallel
    with zero collectives inside an LF (SURVEY.md §5.8). Returns
    (basic, final) batches.

    Failure isolation (SURVEY.md §5.3): with retries > 0 the batch's device
    call is retried; with on_fail='identity' a call that still fails is
    replaced by the identity estimate (the noisy input) instead of raising.
    The batch runs as ONE program, so a fault degrades the whole batch;
    per-LF isolation is the disk-to-disk driver's job (pipeline/stream_io).
    With return_report=True, also returns a list of
    {index, attempts, error} entries (index None: the whole batch).
    """
    # device arrays stay on the device (np.asarray would copy the whole
    # batch back to the host and up again)
    if isinstance(lfs, jax.Array):
        lfs = lfs.astype(jnp.dtype(dtype))
    else:
        lfs = jnp.asarray(np.asarray(lfs), jnp.dtype(dtype))
    b, a_h, a_w, h, w, c = lfs.shape
    sigma_c = _sigma_channels(params.sigma, params.color_space, c, dtype)
    fn = build_denoise_fn(params, a_h, a_w, h, w, c, dtype)

    if mesh is None:
        call = _jit_vmapped(fn)
    else:
        (axis,) = mesh.axis_names
        if b % mesh.size:
            raise ValueError(
                f"batch {b} not divisible by mesh size {mesh.size}"
            )
        lfs = jax.device_put(lfs, NamedSharding(mesh, P(axis)))
        call = _jit_sharded_vmap(fn, mesh, axis)

    out, attempts, err = _run_with_retry(
        call, (lfs, sigma_c), retries, on_fail, lambda: (lfs, lfs),
    )
    if return_report:
        report = [] if err is None else [
            {"index": None, "attempts": attempts, "error": repr(err)}
        ]
        return out, report
    return out
