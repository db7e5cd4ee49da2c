"""PNG header probe and the native codec path without Pillow."""

import os
import subprocess
import sys

import numpy as np
import pytest

from lfbm5d_tpu.lf.io import png_header, save_lf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("bit_depth,channels", [(8, 1), (8, 3), (16, 1),
                                                (16, 3)])
def test_ihdr_probe(tmp_path, bit_depth, channels):
    lf = np.random.default_rng(0).uniform(
        0, 255, (1, 1, 7, 11, channels))
    save_lf(lf, str(tmp_path), "s_%d_%d.png", bit_depth=bit_depth)
    assert png_header(str(tmp_path / "s_0_0.png")) == (
        7, 11, channels, bit_depth)


def test_ihdr_probe_rejects_non_png(tmp_path):
    p = tmp_path / "x.png"
    p.write_bytes(b"not a png at all, just bytes")
    with pytest.raises(ValueError):
        png_header(str(p))


def test_native_round_trip_leaves_pil_unimported(tmp_path):
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from lfbm5d_tpu import native\n"
        "from lfbm5d_tpu.lf.io import load_lf, save_lf\n"
        "assert native.available()\n"
        "lf = np.random.default_rng(1).uniform(0, 255, (2, 3, 9, 10, 3))\n"
        f"save_lf(lf, {str(tmp_path)!r}, 'S_%02d_%02d.png')\n"
        f"got = load_lf({str(tmp_path)!r}, 'S_%02d_%02d.png', 2, 3)\n"
        "assert np.abs(got - np.floor(lf + 0.5)).max() == 0\n"
        "print(sorted(m for m in ('PIL', 'cv2') if m in sys.modules))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
