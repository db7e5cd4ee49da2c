"""Device-trace aggregation for jax.profiler dumps (SURVEY.md §5.1).

bench.py --profile DIR and chip_smoke.py --trace DIR write an xplane trace.
`summarize_trace` reduces it with nothing but JAX (jax.profiler.ProfileData):
for every line of every GPU plane, its event count, summed duration, busy
union and top events, plus the busy and idle share of the kernel streams over
the traced window.

Usage:
  python -m lfbm5d_tpu.utils.profiling /tmp/trace_dir [top_n]
"""

from __future__ import annotations

import glob
import sys


def _find_xplane(trace_dir: str) -> str:
    hits = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))
    if not hits:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return hits[-1]


def _union_ns(intervals) -> float:
    total, end = 0.0, None
    for s0, s1 in sorted(intervals):
        if end is None or s0 > end:
            total += s1 - s0
            end = s1
        elif s1 > end:
            total += s1 - end
            end = s1
    return total


def summarize_trace(trace_dir: str, top_n: int = 12) -> str:
    """Text summary of the GPU planes of the newest trace under trace_dir."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(_find_xplane(trace_dir))
    out = []
    streams = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        out.append(f"plane {plane.name}")
        for line in plane.lines:
            evs = [(e.name, e.start_ns, e.duration_ns) for e in line.events]
            if not evs:
                continue
            iv = [(s0, s0 + d) for _, s0, d in evs]
            if line.name.startswith("Stream"):
                streams += iv
            by = {}
            for name, _, d in evs:
                n, t = by.get(name, (0, 0.0))
                by[name] = (n + 1, t + d)
            out.append(
                f"  line {line.name!r}: {len(evs)} events, sum "
                f"{sum(d for *_, d in evs) / 1e9:.6f} s, busy "
                f"{_union_ns(iv) / 1e9:.6f} s"
            )
            for name, (n, t) in sorted(by.items(), key=lambda kv: -kv[1][1])[
                :top_n
            ]:
                out.append(f"    {t / 1e9:10.6f} s {n:8d}x {name[:100]}")
    if streams:
        window = max(s1 for _, s1 in streams) - min(s0 for s0, _ in streams)
        busy = _union_ns(streams)
        out.append(
            f"kernel streams: window {window / 1e9:.6f} s, busy "
            f"{busy / 1e9:.6f} s, idle share {1 - busy / window:.4f}"
        )
    return "\n".join(out)


if __name__ == "__main__":
    print(summarize_trace(sys.argv[1],
                          int(sys.argv[2]) if len(sys.argv) > 2 else 12))
