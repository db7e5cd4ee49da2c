"""Test harness configuration.

Tests run on CPU with 8 virtual devices (SURVEY.md §4.2.6): fast, deterministic,
and lets sharding/streaming tests exercise a real multi-device mesh without
a GPU. chip_smoke.py and bench.py are what run on the card.

The platform is set through jax.config rather than the environment, so it
holds even where jax was imported before this file runs.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Allow float64 in tests (oracle comparisons); library code pins its own dtypes.
jax.config.update("jax_enable_x64", True)
