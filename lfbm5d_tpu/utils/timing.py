"""Structured per-stage timing (SURVEY.md §5.1/§5.5).

The reference prints wall-clock per step via printf; here stages are named
contexts collected into a dict for the CLI's structured report. For deep
kernel profiling use jax.profiler:

    with jax.profiler.trace("/tmp/jax-trace"):
        run_bm5d(...)
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class StageTimer:
    def __init__(self):
        self._times: dict[str, float] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self._times[name] = self._times.get(name, 0.0) + time.time() - t0

    def seconds(self, name: str) -> float:
        return self._times.get(name, 0.0)

    def items(self):
        return self._times.items()

