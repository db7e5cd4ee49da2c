"""Disk-to-disk LF streaming: overlap host PNG codec work with device compute.

The reference processes one LF per process invocation (SURVEY.md §3.1: load
-> denoise -> save, serial). For deployment-scale throughput (driver config
5) the host side must not serialize with the device: this driver runs

    decode(i+1)  ||  denoise(i) on the device  ||  encode(i-1)

with a lookahead decode thread pool and an encoder pool. Decode/encode use
the thread-pooled native libpng codec when available (lf/io.py); device
results are quantized ON DEVICE (fetch_rounded) so the device-to-host copy
is uint8, not float32.

Failure isolation (SURVEY.md §5.3): each LF's device call retries
`retries` times; a still-failing LF is recorded in the returned report and
skipped (or written as the identity estimate), never poisoning the stream.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import jax.numpy as jnp

from lfbm5d_tpu.config import DenoiseParams
from lfbm5d_tpu.lf.io import fetch_rounded, load_lf, save_lf
from lfbm5d_tpu.pipeline.denoise import _sigma_channels, build_denoise_fn
from lfbm5d_tpu.pipeline.streaming import _jit_per_lf


@dataclass
class StreamReport:
    """Per-stream accounting returned by stream_denoise_dirs."""

    n_done: int = 0
    n_failed: int = 0
    failures: list = field(default_factory=list)  # {job, attempts, error}
    seconds_total: float = 0.0
    seconds_device: float = 0.0  # device-blocked time in the main thread
    lf_seconds: list = field(default_factory=list)  # end-to-end per LF


def _default_run(fn, lf_dev, sigma_c):
    jfn = _jit_per_lf(fn)
    basic, final = jfn(lf_dev, sigma_c)
    return final


def stream_denoise_dirs(
    jobs,
    params: DenoiseParams,
    a_h: int,
    a_w: int,
    pattern: str = "SAI_%02d_%02d.png",
    out_pattern: str | None = None,
    s_offset: int = 0,
    t_offset: int = 0,
    bit_depth: int = 8,
    dtype: str = "float32",
    retries: int = 1,
    on_fail: str = "skip",
    lookahead: int = 2,
    _run=None,
) -> StreamReport:
    """Stream (input_dir, output_dir) jobs through the denoiser.

    jobs: iterable of (input_dir, output_dir) pairs; every LF must share
    the (a_h, a_w, pattern) layout (one compiled program serves the
    stream). `lookahead` LFs are decoded ahead of the device; encodes run
    asynchronously behind it. on_fail: 'skip' leaves no output for a
    failed LF; 'identity' writes the noisy input; 'raise' aborts the
    stream. `_run` overrides the per-LF device call (tests inject faults
    through it).

    Returns a StreamReport (counts, failures, wall/device seconds).
    """
    jobs = list(jobs)
    run = _run or _default_run
    report = StreamReport()
    t_start = time.perf_counter()
    if not jobs:
        return report

    fn_cache: dict[tuple, object] = {}
    sigma_c = None

    def decode(job):
        in_dir, _ = job
        t0 = time.perf_counter()
        lf = load_lf(in_dir, pattern, a_h, a_w, s_offset=s_offset,
                     t_offset=t_offset)
        return lf, time.perf_counter() - t0

    def encode(job, arr_q):
        _, out_dir = job
        os.makedirs(out_dir, exist_ok=True)
        save_lf(arr_q, out_dir, out_pattern or pattern,
                s_offset=s_offset, t_offset=t_offset, bit_depth=bit_depth)

    with ThreadPoolExecutor(max_workers=max(1, lookahead)) as dec_pool, \
            ThreadPoolExecutor(max_workers=2) as enc_pool:
        dec_futs = [dec_pool.submit(decode, j)
                    for j in jobs[: lookahead + 1]]
        enc_futs = []
        for i, job in enumerate(jobs):
            t_lf = time.perf_counter()
            lf, _dec_s = dec_futs[i].result()
            if i + lookahead + 1 < len(jobs):
                dec_futs.append(
                    dec_pool.submit(decode, jobs[i + lookahead + 1])
                )

            key = lf.shape
            if key not in fn_cache:
                h, w = lf.shape[2], lf.shape[3]
                c = lf.shape[4]
                fn_cache[key] = build_denoise_fn(
                    params, a_h, a_w, h, w, c, dtype
                )
                sigma_c = _sigma_channels(
                    params.sigma, params.color_space, c, dtype
                )
            fn = fn_cache[key]

            lf_dev = jnp.asarray(lf, jnp.dtype(dtype))
            t_dev = time.perf_counter()
            err = None
            out_q = None
            for attempt in range(retries + 1):
                try:
                    final = run(fn, lf_dev, sigma_c)
                    # on-device quantization: download uint8, not float32
                    out_q = fetch_rounded(final, bit_depth=bit_depth)
                    err = None
                    break
                except Exception as e:
                    err = e
            report.seconds_device += time.perf_counter() - t_dev
            if err is not None:
                if on_fail == "raise":
                    raise err
                report.n_failed += 1
                report.failures.append(
                    {"job": job, "attempts": retries + 1, "error": repr(err)}
                )
                if on_fail == "identity":
                    out_q = fetch_rounded(lf_dev, bit_depth=bit_depth)
                else:  # skip
                    report.lf_seconds.append(time.perf_counter() - t_lf)
                    continue
            enc_futs.append(enc_pool.submit(encode, job, out_q))
            report.n_done += 1
            report.lf_seconds.append(time.perf_counter() - t_lf)
        for f in enc_futs:
            f.result()  # surface encoder errors
    report.seconds_total = time.perf_counter() - t_start
    return report
