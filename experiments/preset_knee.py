"""Preset knee sweep: throughput vs PSNR for candidate presets.

Runs a list of parameter presets on ONE synthetic LF (the bench LF: same
seeds/disparity structure as bench.py) in a single process, so all timings
are same-session comparable. Prints one JSON line per preset with PSNR and
run times; the PSNR values feed the matched-PSNR preset selection
(BASELINE.json:5 demands <= 0.05 dB below reference-default quality).

Usage:
  python experiments/preset_knee.py --shape 9 224 320 \
      --presets default fast N16n8p4 N16n8p4A2 ... [--runs 2]

Preset grammar: 'default', 'fast', or N{n_sim}n{n_search}p{p}[d{n_disp}][A{p_ang}];
'HT/WIENER' (two presets joined by '/') sets the steps asymmetrically —
the steps have different costs (Wiener runs 9 chain passes vs HT's 6) and
different quality roles (HT only builds the Wiener pilot), so the knee
need not be symmetric.
"""

import argparse
import json
import re
import sys
import time

import numpy as np

sys.path.insert(0, __import__("os").path.dirname(
    __import__("os").path.dirname(__import__("os").path.abspath(__file__))))


def parse_preset(name: str) -> dict:
    """Grammar: default|fast|N{..}n{..}p{..}[d{..}][A{..}] plus optional
    trailing quality-knob tokens (any order): F{tau} flat fallback,
    L{lam} HT lambda (DenoiseParams.lambda_3d), B bior1.5 tau_2d,
    S use_sd aggregation weights."""
    extras: dict = {}
    while True:
        m = re.search(r"(?:F(\d+(?:\.\d+)?)|L(\d+(?:\.\d+)?)|B|S)$", name)
        if not m:
            break
        tok = m.group(0)
        if tok.startswith("F"):
            extras["flat_tau"] = float(m.group(1))
        elif tok.startswith("L"):
            extras["_lambda_3d"] = float(m.group(2))
        elif tok == "B":
            extras["tau_2d"] = "bior"
        elif tok == "S":
            extras["use_sd"] = True
        name = name[: m.start()]
    if name == "default":
        return dict(n_sim=16, n_search=16, n_disp=2, k=8, p=3, **extras)
    if name == "fast":
        return dict(n_sim=8, n_search=8, n_disp=2, k=8, p=6, **extras)
    m = re.fullmatch(r"N(\d+)n(\d+)p(\d+)(?:d(\d+))?(?:A(\d+))?", name)
    if not m:
        raise ValueError(f"bad preset {name!r}")
    d = dict(n_sim=int(m[1]), n_search=int(m[2]), p=int(m[3]), k=8,
             n_disp=int(m[4]) if m[4] else 2)
    if m[5]:
        d["p_ang"] = int(m[5])
    d.update(extras)
    return d


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=3, default=[9, 224, 320],
                    metavar=("A", "H", "W"))
    ap.add_argument("--presets", nargs="+", required=True)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=256,
                    help="reference-patch chunk (rounds 1-3 swept at 128; "
                    "256 = the preset/bench default)")
    ap.add_argument("--sigma", type=float, default=25.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="synthetic-LF content seed (vary to check a preset "
                    "is not tuned to one LF)")
    ap.add_argument("--disp", type=int, nargs=2, default=[1, 2],
                    metavar=("BG", "FG"), help="background/foreground "
                    "disparity of the synthetic LF")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lfbm5d_tpu.utils.cache import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()  # compile_first_s becomes a cache
    # load on repeat shapes; LFBM5D_NO_COMPILE_CACHE=1 restores cold compiles

    from lfbm5d_tpu.config import DenoiseParams, StepParams
    from lfbm5d_tpu.lf import psnr, synthetic_lf
    from lfbm5d_tpu.lf.metrics import psnr_device
    from lfbm5d_tpu.lf.noise import add_noise_np
    from lfbm5d_tpu.pipeline import run_bm5d

    a, h, w = args.shape
    clean = synthetic_lf(a, a, h, w, channels=3, disp_bg=args.disp[0],
                         disp_fg=args.disp[1], seed=args.seed)
    noisy = add_noise_np(clean, args.sigma, seed=args.seed + 1)
    noisy_dev = jnp.asarray(noisy, jnp.float32)
    clean_dev = jnp.asarray(clean, jnp.float32)
    jax.block_until_ready(noisy_dev)
    p_noisy = psnr(np.clip(noisy, 0, 255), clean)
    print(f"# {a}x{a}x{h}x{w} sigma={args.sigma:g} noisy={p_noisy:.3f} dB "
          f"backend={jax.default_backend()}",
          file=sys.stderr, flush=True)

    for name in args.presets:
        if "/" in name:
            ht_name, wn_name = name.split("/", 1)
            step_ht = parse_preset(ht_name)
            step_wn = parse_preset(wn_name)
        else:
            step_ht = step_wn = parse_preset(name)
        lam = step_ht.pop("_lambda_3d", 2.7)
        step_wn.pop("_lambda_3d", None)
        step = {"ht": step_ht, "wiener": step_wn}
        params = DenoiseParams(
            sigma=args.sigma,
            lambda_3d=lam,
            ht=StepParams(tau_match=2500.0, **step_ht),
            wiener=StepParams(tau_match=400.0, **step_wn),
            chunk=args.chunk,
        )
        t0 = time.time()
        try:
            basic, final = jax.block_until_ready(run_bm5d(noisy_dev, params))
        except Exception as e:
            print(json.dumps({"preset": name, "error": f"{type(e).__name__}: {e}"}),
                  flush=True)
            continue
        compile_s = time.time() - t0
        times = []
        for _ in range(args.runs):
            t0 = time.time()
            basic, final = jax.block_until_ready(run_bm5d(noisy_dev, params))
            times.append(time.time() - t0)
        p_final = float(psnr_device(jnp.clip(final, 0, 255), clean_dev))
        mpix = a * a * h * w / 1e6
        print(json.dumps({
            "preset": name, "step": step,
            "psnr_db": round(p_final, 3),
            "s_per_lf": round(min(times), 3),
            "mpix_s": round(mpix / min(times), 3),
            "runs": [round(t, 3) for t in times],
            "compile_first_s": round(compile_s, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
