"""Streaming driver: denoise many on-disk light fields through the mesh.

The reference has no fault handling (single-shot CLI, SURVEY.md §5.3); the
streaming config gets the minimal production story: batch LF
directories through `denoise_batch`, retry each failed batch per-LF, and
report per-LF status so one corrupt input cannot sink a streaming job.
"""

from __future__ import annotations

import os

import numpy as np

from lfbm5d_tpu.config import DenoiseParams
from lfbm5d_tpu.lf import load_lf, save_lf


def stream_directories(
    inputs: list[str],
    outputs: list[str],
    pattern: str,
    a_h: int,
    a_w: int,
    params: DenoiseParams,
    mesh=None,
    bit_depth: int = 8,
    retries: int = 1,
) -> list[dict]:
    """Denoise each input LF directory into the matching output directory.

    LFs are processed in mesh-sized batches when a mesh is given. Returns a
    per-LF status list: {"input", "ok", "error"?}.
    """
    from lfbm5d_tpu.pipeline.streaming import denoise_batch

    if len(inputs) != len(outputs):
        raise ValueError("inputs and outputs must pair up")
    group = mesh.size if mesh is not None else 1
    status: list[dict] = [{"input": p, "ok": False} for p in inputs]

    def run_batch(idxs: list[int]) -> None:
        lfs = np.stack(
            [load_lf(inputs[i], pattern, a_h, a_w) for i in idxs]
        )
        use_mesh = mesh if len(idxs) == group else None
        _, finals = denoise_batch(lfs, params, mesh=use_mesh)
        finals = np.asarray(finals)
        for j, i in enumerate(idxs):
            save_lf(finals[j], outputs[i], pattern, bit_depth=bit_depth)
            status[i]["ok"] = True

    batches = [
        list(range(b, min(b + group, len(inputs))))
        for b in range(0, len(inputs), group)
    ]
    for idxs in batches:
        try:
            run_batch(idxs)
        except Exception as batch_err:  # retry per-LF to isolate the culprit
            for i in idxs:
                done = False
                for _ in range(max(retries, 1)):
                    try:
                        run_batch([i])
                        done = True
                        break
                    except Exception as e:
                        status[i]["error"] = str(e)
                if not done and "error" not in status[i]:
                    status[i]["error"] = str(batch_err)
    return status
