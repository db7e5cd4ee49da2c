"""Smoke test of the LFBM5D pipeline on the GPU, through its user entry points.

    python chip_smoke.py               # one card: phases a-f below
    python chip_smoke.py --four        # four cards: the multi-LF phase only
    python chip_smoke.py --trace DIR   # also trace one headline run to DIR

Phases (one process, in order; any failure exits non-zero):
  a. device   JAX must find GPUs; prints versions, XLA_FLAGS, nvidia-smi
  b. denoise  9x9 x 434x625 RGB synthetic LF, sigma 25, `matched`, f32,
              through run_bm5d twice: times, PSNRs, peak memory, and the
              run-to-run difference; final PSNR >= noisy + 5 dB
  c. precision  the same LF in f64 (f32 final within 0.05 dB of it), and
              run_bm5d f64 on the card against the NumPy f64 oracle on two
              small LFs (max abs diff <= 1e-9)
  d. cli      clean LF as 8-bit PNGs -> `lfbm5d denoise --sigma-add 25`
              in-process -> every output SAI written, PSNR gain > 5 dB
  e. sr       x2 SR of a 9x9 x 217x312 LR LF at the `matched` schedule;
              PSNR >= bicubic + 1 dB
  f. stream   stream_denoise_dirs over 3 LFs at the headline shape,
              on_fail='raise': 3 done, 0 failed
  four        (--four only) denoise_batch of 4 LFs at 17x17 x 512x512 RGB
              over a 4-card mesh, each shard on its own card, each LF equal
              to its single-card run_bm5d result

The last line of stdout is {"ok": true, "device": {...}}; nothing is printed
there unless every phase passed. jax_enable_x64 is set at start for phase c;
the library pins its own dtypes, so phase b still runs in f32.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

HEADLINE = (9, 9, 434, 625, 3)
SIGMA = 25.0
FOUR_SHAPE = (17, 17, 512, 512, 3)

PHASES = ("device", "denoise", "precision", "cli", "sr", "stream")


def phases(argv=None) -> list[str]:
    """The phases a command line runs, in order."""
    args = _parse(argv)
    return ["device", "four"] if args.four else list(PHASES)


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card multi-LF phase")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="trace one extra headline run to DIR")
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    log(f"  check {'PASS' if ok else 'FAIL'}: {what}")
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def phase_device() -> dict:
    import jax

    from lfbm5d_tpu.utils.device import nvidia_smi_name_power, require_gpu

    info = require_gpu()
    log(f"jax {jax.__version__}; device_kind {info['kind']}; "
        f"count {info['count']}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    for line in nvidia_smi_name_power():
        log(f"nvidia-smi: {line}")
    return info


def headline_lf():
    from lfbm5d_tpu.lf.noise import add_noise_np
    from lfbm5d_tpu.lf.synth import synthetic_lf

    a_h, a_w, h, w, c = HEADLINE
    clean = synthetic_lf(a_h, a_w, h, w, channels=c, disp_bg=1, disp_fg=2,
                         seed=0)
    return clean, add_noise_np(clean, SIGMA, seed=1)


def matched_params():
    from lfbm5d_tpu.config import preset_denoise_params

    return preset_denoise_params("matched", SIGMA, chunk=128)


def phase_denoise(clean, noisy, trace_dir=None) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lfbm5d_tpu.lf.metrics import psnr, psnr_device
    from lfbm5d_tpu.pipeline import run_bm5d

    params = matched_params()
    noisy_dev = jax.block_until_ready(jnp.asarray(noisy, jnp.float32))
    t0 = time.perf_counter()
    basic, final = jax.block_until_ready(run_bm5d(noisy_dev, params))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, final2 = jax.block_until_ready(run_bm5d(noisy_dev, params))
    run_s = time.perf_counter() - t0
    mpix = np.prod(HEADLINE[:4]) / 1e6
    rr = float(jnp.max(jnp.abs(final - final2)))
    p_noisy = psnr(np.clip(noisy, 0, 255), clean)
    p_basic = psnr_device(basic, clean)
    p_final = psnr_device(final, clean)
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log(f"  compile + first run: {first_s:.3f} s")
    log(f"  second run: {run_s:.3f} s/LF = {mpix / run_s:.3f} Mpix/s "
        f"({mpix:.3f} Mpix)")
    log(f"  PSNR noisy {p_noisy:.3f} dB, basic {p_basic:.3f} dB, "
        f"final {p_final:.3f} dB")
    log(f"  peak device memory: {peak} bytes")
    log(f"  run-to-run max abs diff of the finals: {rr!r} (reported)")
    check(p_final >= p_noisy + 5.0,
          f"final {p_final:.3f} dB >= noisy {p_noisy:.3f} + 5 dB")
    if trace_dir:
        from lfbm5d_tpu.utils.profiling import summarize_trace

        jax.profiler.start_trace(trace_dir)
        jax.block_until_ready(run_bm5d(noisy_dev, params))
        jax.profiler.stop_trace()
        log(summarize_trace(trace_dir))
    return {"final": final, "psnr_final": p_final, "run_to_run": rr}


def phase_precision(clean, noisy, f32_psnr: float) -> None:
    import jax
    import numpy as np

    from lfbm5d_tpu.config import DenoiseParams, StepParams
    from lfbm5d_tpu.lf.metrics import psnr_device
    from lfbm5d_tpu.lf.noise import add_noise_np
    from lfbm5d_tpu.lf.synth import synthetic_lf
    from lfbm5d_tpu.oracle import oracle_denoise
    from lfbm5d_tpu.pipeline import run_bm5d

    check(jax.config.jax_enable_x64, "jax_enable_x64 is on")
    _, final64 = jax.block_until_ready(
        run_bm5d(noisy, matched_params(), dtype="float64"))
    check(final64.dtype == np.float64, "the f64 run computes in float64")
    p64 = psnr_device(final64, clean)
    d = abs(f32_psnr - p64)
    log(f"  headline final PSNR f32 {f32_psnr:.4f} dB, f64 {p64:.4f} dB")
    check(d <= 0.05, f"|f32 - f64| = {d:.4f} dB <= 0.05 dB")

    tiny = dict(n_sim=8, n_search=4, n_disp=1, k=8, p=3)
    cases = [
        ("grey 2x2x20x24", (2, 2, 20, 24, 1), 20.0, 0),
        ("RGB OPP 3x3x32x32", (3, 3, 32, 32, 3), 25.0, 4),
    ]
    for name, (a_h, a_w, h, w, c), sigma, seed in cases:
        lf_clean = synthetic_lf(a_h, a_w, h, w, channels=c, seed=seed)
        lf = add_noise_np(lf_clean, sigma, seed=seed + 1)
        params = DenoiseParams(
            sigma=sigma, ht=StepParams(tau_match=2500.0, **tiny),
            wiener=StepParams(tau_match=400.0, **tiny), chunk=32,
        )
        t0 = time.perf_counter()
        ob, of = oracle_denoise(lf, params)
        oracle_s = time.perf_counter() - t0
        tb, tf = run_bm5d(lf, params, dtype="float64")
        diff = max(float(np.abs(ob - np.asarray(tb)).max()),
                   float(np.abs(of - np.asarray(tf)).max()))
        log(f"  oracle ({oracle_s:.1f} s on the host) vs card, {name}: "
            f"max abs diff {diff:.3e} (tolerance 1e-9)")
        check(diff <= 1e-9, f"{name} matches the f64 oracle")


def phase_cli(clean) -> None:
    import numpy as np

    from lfbm5d_tpu import cli, native
    from lfbm5d_tpu.lf.io import save_lf

    a_h, a_w = HEADLINE[:2]
    pattern = "SAI_%02d_%02d.png"
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "clean"), os.path.join(tmp, "out")
        save_lf(np.clip(clean, 0, 255), src, pattern)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([
                "denoise", "--input", src, "--pattern", pattern,
                "--aheight", str(a_h), "--awidth", str(a_w),
                "--sigma-add", str(SIGMA), "--preset", "matched",
                "--output", out, "--json",
            ])
        check(rc == 0, f"cli exit code {rc} == 0")
        rep = json.loads(buf.getvalue().strip().splitlines()[-1])
        missing = [
            (s, t) for s in range(a_h) for t in range(a_w)
            if not os.path.isfile(os.path.join(out, pattern % (s, t)))
        ]
        check(not missing, f"all {a_h * a_w} output SAIs written")
    log(f"  cli: noisy {rep['psnr_noisy_db']} dB -> final "
        f"{rep['psnr_final_db']} dB, denoise {rep['seconds_denoise']} s, "
        f"load {rep['seconds_load']} s, save {rep['seconds_save']} s")
    check(rep["psnr_final_db"] > rep["psnr_noisy_db"] + 5.0,
          "cli final PSNR > noisy + 5 dB")
    if native.available():
        codec = "native libpng (lfbm5d_tpu.native)"
    else:
        used = [m for m, mod in (("OpenCV", "cv2"), ("Pillow", "PIL"))
                if mod in sys.modules]
        codec = (f"Python fallback ({' + '.join(used) or 'none'}): the "
                 "native libpng codec did not build")
    log(f"  PNG codec: {codec}")


def phase_sr(clean) -> None:
    import jax
    import jax.numpy as jnp

    from lfbm5d_tpu.config import SR_SCHEDULES, SRParams
    from lfbm5d_tpu.lf.metrics import psnr_device
    from lfbm5d_tpu.lf.resize import downsample, upsample
    from lfbm5d_tpu.pipeline.sr import run_sr

    h, w = HEADLINE[2] // 2, HEADLINE[3] // 2  # 217 x 312 at the headline
    hr_ref = jnp.asarray(clean[:, :, : 2 * h, : 2 * w], jnp.float32)
    lr = downsample(hr_ref, 2)
    check(lr.shape[2:4] == (h, w), f"LR extent {lr.shape[2:4]}")
    dn = matched_params()
    sched = SR_SCHEDULES["matched"]
    params = SRParams(scale=2, n_iter=sched["n_iter"],
                      sigma_init=sched["sigma_init"], ht=dn.ht,
                      wiener=dn.wiener, chunk=dn.chunk)
    t0 = time.perf_counter()
    hr = jax.block_until_ready(run_sr(lr, params))
    sr_s = time.perf_counter() - t0
    check(hr.shape == hr_ref.shape, f"HR shape {hr.shape}")
    p_bic = psnr_device(upsample(lr, 2), hr_ref)
    p_sr = psnr_device(hr, hr_ref)
    log(f"  SR x2 ({params.n_iter} iterations from sigma "
        f"{params.sigma_init:g}, compile included): {sr_s:.3f} s")
    log(f"  PSNR bicubic {p_bic:.3f} dB, SR {p_sr:.3f} dB")
    check(p_sr >= p_bic + 1.0, f"SR {p_sr:.3f} dB >= bicubic + 1.0 dB")


def phase_stream(n_jobs: int = 3) -> None:
    import numpy as np

    from lfbm5d_tpu.lf.io import load_lf, save_lf
    from lfbm5d_tpu.lf.metrics import psnr
    from lfbm5d_tpu.lf.noise import add_noise_np
    from lfbm5d_tpu.lf.synth import synthetic_lf
    from lfbm5d_tpu.pipeline.stream_io import stream_denoise_dirs

    a_h, a_w, h, w, c = HEADLINE
    pattern = "SAI_%02d_%02d.png"
    with tempfile.TemporaryDirectory() as tmp:
        jobs, cleans = [], []
        for i in range(n_jobs):
            clean = synthetic_lf(a_h, a_w, h, w, channels=c, disp_bg=1,
                                 disp_fg=2, seed=10 + i)
            src = os.path.join(tmp, f"in_{i}")
            save_lf(np.clip(add_noise_np(clean, SIGMA, seed=20 + i), 0, 255),
                    src, pattern)
            jobs.append((src, os.path.join(tmp, f"out_{i}")))
            cleans.append(clean)
        rep = stream_denoise_dirs(jobs, matched_params(), a_h, a_w,
                                  pattern=pattern, retries=0,
                                  on_fail="raise")
        log(f"  stream: done {rep.n_done}, failed {rep.n_failed}, "
            f"{rep.seconds_total:.3f} s total, device-blocked "
            f"{rep.seconds_device:.3f} s, per LF "
            f"{[round(t, 3) for t in rep.lf_seconds]} s")
        check(rep.n_done == n_jobs and rep.n_failed == 0,
              f"{n_jobs} done, 0 failed")
        for (src, out), clean in zip(jobs, cleans):
            p_in = psnr(load_lf(src, pattern, a_h, a_w), clean)
            p_out = psnr(load_lf(out, pattern, a_h, a_w), clean)
            check(p_out > p_in + 5.0,
                  f"{os.path.basename(out)}: {p_out:.3f} dB > "
                  f"input {p_in:.3f} + 5 dB")


def phase_four() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lfbm5d_tpu.lf.noise import add_noise_np
    from lfbm5d_tpu.lf.synth import synthetic_lf
    from lfbm5d_tpu.parallel import denoise_batch, make_mesh
    from lfbm5d_tpu.pipeline import run_bm5d

    a_h, a_w, h, w, c = FOUR_SHAPE
    params = matched_params()
    lfs = np.stack([
        add_noise_np(synthetic_lf(a_h, a_w, h, w, channels=c, disp_bg=1,
                                  disp_fg=2, seed=30 + i), SIGMA, seed=40 + i)
        for i in range(4)
    ]).astype(np.float32)
    mpix = a_h * a_w * h * w / 1e6
    log(f"  4 LFs of {FOUR_SHAPE}, {mpix:.3f} Mpix each, preset matched")

    # tolerance: the headline run-to-run difference, measured as phase b
    # does (the scatter-add's summation order varies between runs)
    x = jnp.asarray(headline_lf()[1], jnp.float32)
    _, f1 = jax.block_until_ready(run_bm5d(x, params))
    _, f2 = jax.block_until_ready(run_bm5d(x, params))
    tol = float(jnp.max(jnp.abs(f1 - f2)))
    log(f"  headline run-to-run max abs diff on card 0: {tol!r}")

    dev0 = jax.devices()[0]
    singles, t_one = [], None
    for i in range(4):
        t0 = time.perf_counter()
        _, f = jax.block_until_ready(
            run_bm5d(jax.device_put(lfs[i], dev0), params))
        dt = time.perf_counter() - t0
        log(f"  LF {i} alone on card 0: {dt:.3f} s"
            f"{' (compile included)' if i == 0 else ''}")
        if i == 1:
            t_one = dt
        singles.append(f)

    mesh = make_mesh(4)
    t0 = time.perf_counter()
    _, final = jax.block_until_ready(denoise_batch(lfs, params, mesh=mesh))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, final = jax.block_until_ready(denoise_batch(lfs, params, mesh=mesh))
    t_four = time.perf_counter() - t0
    log(f"  4-card batch: compile + first {first:.3f} s, second run "
        f"{t_four:.3f} s = {4 * mpix / t_four:.3f} Mpix/s; one LF on one "
        f"card {t_one:.3f} s = {mpix / t_one:.3f} Mpix/s; scaling "
        f"{4 * t_one / t_four:.3f}x")
    shards = sorted(final.addressable_shards, key=lambda s: s.index[0].start)
    devs = [s.device for s in shards]
    log(f"  output shard devices: {devs}")
    platform = jax.devices()[0].platform  # "gpu": phase a checked it
    check(len({d.id for d in devs}) == 4 and all(
        d.platform == platform for d in devs),
        f"shards on four distinct {platform} devices")
    for i, s in enumerate(shards):
        ref = jax.device_put(singles[i], s.device)
        d = float(jnp.max(jnp.abs(s.data[0] - ref)))
        log(f"  LF {i} on {s.device}: max abs diff vs single card {d!r} "
            f"(tolerance {tol!r})")
        check(d <= tol, f"LF {i} matches its single-card run")


def main(argv=None) -> int:
    args = _parse(argv)
    run = phases(argv)
    import jax

    jax.config.update("jax_enable_x64", True)
    from lfbm5d_tpu.utils.cache import enable_persistent_compilation_cache

    t_all = time.perf_counter()
    seconds = {}

    def timed(name, fn, *a):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        log(f"  phase {name}: {seconds[name]:.3f} s")
        return out

    info = timed("device", phase_device)
    enable_persistent_compilation_cache()
    if "four" in run:
        timed("four", phase_four)
    else:
        clean, noisy = headline_lf()
        b = timed("denoise", phase_denoise, clean, noisy, args.trace)
        timed("precision", phase_precision, clean, noisy, b["psnr_final"])
        timed("cli", phase_cli, clean)
        timed("sr", phase_sr, clean)
        timed("stream", phase_stream)
    used = 4 if "four" in run else 1
    log(f"phase seconds: {json.dumps({k: round(v, 3) for k, v in seconds.items()})}; "
        f"total {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"], "count": used}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
