"""End-to-end CLI tests (the reference's only supported API, SURVEY.md §2.9)."""

import json

import numpy as np
import pytest

from lfbm5d_tpu.cli import main
from lfbm5d_tpu.lf import load_lf, save_lf, synthetic_lf

TINY = [
    "--ht-nsim", "8", "--ht-nsearch", "4", "--ht-ndisp", "1", "--ht-p", "3",
    "--wien-nsim", "8", "--wien-nsearch", "4", "--wien-ndisp", "1",
    "--wien-p", "3", "--chunk", "32",
]


@pytest.fixture(scope="module")
def lf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lf")
    clean = synthetic_lf(2, 2, 20, 24, channels=3, seed=0)
    save_lf(clean, str(d), "SAI_%02d_%02d.png")
    return d, clean


def test_denoise_cli_with_noise_synthesis(lf_dir, tmp_path, capsys):
    d, clean = lf_dir
    rc = main([
        "denoise", "--input", str(d), "--aheight", "2", "--awidth", "2",
        "--sigma-add", "20", "--output", str(tmp_path / "out"),
        "--basic", str(tmp_path / "basic"), "--diff", str(tmp_path / "diff"),
        "--per-sai-psnr", "--json", *TINY,
    ])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["psnr_final_db"] > rep["psnr_noisy_db"] + 2.0
    grid = np.asarray(rep["psnr_per_sai_db"])
    assert grid.shape == (2, 2)
    # per-SAI values bracket the aggregate (0.02 = reported rounding slack)
    assert grid.min() - 0.02 <= rep["psnr_final_db"] <= grid.max() + 0.02
    out = load_lf(str(tmp_path / "out"), "SAI_%02d_%02d.png", 2, 2)
    assert out.shape == clean.shape
    # basic checkpoint written (SURVEY §5.4)
    basic = load_lf(str(tmp_path / "basic"), "SAI_%02d_%02d.png", 2, 2)
    assert basic.shape == clean.shape


def test_denoise_cli_requires_sigma(lf_dir, tmp_path, capsys):
    d, _ = lf_dir
    rc = main([
        "denoise", "--input", str(d), "--aheight", "2", "--awidth", "2",
        "--output", str(tmp_path / "o"), *TINY,
    ])
    assert rc == 2


def test_sr_cli(lf_dir, tmp_path, capsys):
    d, clean = lf_dir
    rc = main([
        "sr", "--input", str(d), "--aheight", "2", "--awidth", "2",
        "--scale", "2", "--n-iter", "2", "--output", str(tmp_path / "hr"),
        "--checkpoint", str(tmp_path / "ck"), "--json", *TINY,
    ])
    assert rc == 0
    hr = load_lf(str(tmp_path / "hr"), "SAI_%02d_%02d.png", 2, 2)
    assert hr.shape == (2, 2, 40, 48, 3)
    ck = load_lf(str(tmp_path / "ck" / "iter_00"), "SAI_%02d_%02d.png", 2, 2)
    assert ck.shape == hr.shape


def test_positional_reference_cli(tmp_path):
    """SURVEY.md §2.9: the reference-style ~30-positional-arg block runs the
    same config-2 semantics as the flagged form."""
    import numpy as np

    from lfbm5d_tpu.cli import main
    from lfbm5d_tpu.lf import load_lf, save_lf, synthetic_lf

    clean = synthetic_lf(2, 2, 16, 16, channels=3, seed=3)
    inp = str(tmp_path / "clean")
    save_lf(clean, inp, "SAI_%02d_%02d.png")
    out = str(tmp_path / "out")
    basic = str(tmp_path / "basic")
    argv = (
        f"denoise {inp} SAI_%02d_%02d.png 2 2 0 0 20 1 2.7 "
        "4 3 1 8 4 dct 0 dct haar "
        "4 3 1 8 4 dct 0 dct haar "
        "opp " + out + " " + basic + " none"
    ).split()
    assert main(argv) == 0
    lf = load_lf(out, "SAI_%02d_%02d.png", 2, 2)
    assert lf.shape == clean.shape
    # the denoised output must beat the sigma-20 noise floor by several dB
    from lfbm5d_tpu.lf import psnr
    from lfbm5d_tpu.lf.noise import add_noise_np
    noisy = add_noise_np(clean, 20.0, seed=0)
    assert psnr(np.clip(lf, 0, 255), clean) > psnr(np.clip(noisy, 0, 255), clean) + 2.0


def test_positional_sr_cli(lf_dir, tmp_path):
    """SURVEY.md §2 component 11: the reference SR branch
    ships its own positional main; the 33-positional sr block must run the
    same semantics as the flagged form (order documented at
    cli._POSITIONAL_SR)."""
    d, clean = lf_dir
    out = str(tmp_path / "hr")
    ck = str(tmp_path / "ck")
    argv = (
        f"sr {d} SAI_%02d_%02d.png 2 2 0 0 "
        "2 2 12 4 1.0 2.7 "
        "4 3 1 8 4 dct 0 dct haar "
        "4 3 1 8 4 dct 0 dct haar "
        "opp " + out + " " + ck + " 4"
    ).split()
    assert main(argv) == 0
    hr = load_lf(out, "SAI_%02d_%02d.png", 2, 2)
    assert hr.shape == (2, 2, 40, 48, 3)
    ck_lf = load_lf(str(tmp_path / "ck" / "iter_00"), "SAI_%02d_%02d.png", 2, 2)
    assert ck_lf.shape == hr.shape
    # wrong arity fails loudly, not silently misparsed
    with pytest.raises(SystemExit):
        main(["sr", str(d), "SAI_%02d_%02d.png", "2", "2"])
