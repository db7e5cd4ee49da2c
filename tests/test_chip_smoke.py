"""chip_smoke.py off the card: it must refuse to run, and print no result."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_device_phase_fails_without_gpu(args):
    r = _run(args, REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run([], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_four_selects_only_its_phase():
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke.phases(["--four"]) == ["device", "four"]
    assert chip_smoke.phases([]) == [
        "device", "denoise", "precision", "cli", "sr", "stream"]
    assert chip_smoke.phases(["--trace", "t"]) == chip_smoke.phases([])
