"""The JAX-only trace reduction (utils/profiling.py)."""

import jax
import jax.numpy as jnp

from lfbm5d_tpu.utils.profiling import _union_ns, summarize_trace


def test_union_of_intervals():
    assert _union_ns([]) == 0.0
    assert _union_ns([(20, 30), (0, 10), (5, 15)]) == 25.0
    assert _union_ns([(0, 10), (2, 3)]) == 10.0


def test_summarize_trace_reads_a_trace(tmp_path):
    """A CPU trace has no GPU plane: the summary is empty, not an error."""
    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    jax.profiler.start_trace(str(tmp_path))
    f(x).block_until_ready()
    jax.profiler.stop_trace()
    assert summarize_trace(str(tmp_path)) == ""
