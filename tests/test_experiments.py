"""Every experiment script imports without running anything."""

import glob
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = [
    "bm_reuse_probe", "content_family", "flat_probe", "flat_tau_sweep",
    "preset_knee", "region_adaptive_bench", "round5_suite", "sr_knee",
    "stream_io_bench", "streaming_bench",
]


def test_script_list_is_complete():
    found = sorted(os.path.basename(p)[:-3] for p in
                   glob.glob(os.path.join(REPO, "experiments", "*.py")))
    assert found == sorted(SCRIPTS)


@pytest.mark.parametrize("name", SCRIPTS)
def test_experiment_imports_without_running(name, monkeypatch):
    import jax

    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr("sys.argv", ["never-parsed"])
    path = os.path.join(REPO, "experiments", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"exp_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main)
    assert jax.config.jax_compilation_cache_dir == prev  # no side effects
