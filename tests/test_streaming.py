"""Multi-device streaming tests on the 8-way virtual CPU mesh (SURVEY §4.2.6)."""

import numpy as np
import pytest

from lfbm5d_tpu.config import DenoiseParams, StepParams
from lfbm5d_tpu.lf import synthetic_lf
from lfbm5d_tpu.lf.noise import add_noise_np
from lfbm5d_tpu.parallel import denoise_batch, make_mesh
from lfbm5d_tpu.pipeline import run_bm5d

TINY = dict(n_sim=4, n_search=3, n_disp=1, k=8, p=4)


def params():
    return DenoiseParams(
        sigma=20.0,
        ht=StepParams(tau_match=2500.0, **TINY),
        wiener=StepParams(tau_match=400.0, **TINY),
        chunk=32,
    )


@pytest.fixture(scope="module")
def batch():
    lfs = []
    for s in range(4):
        clean = synthetic_lf(2, 2, 16, 16, channels=1, seed=s)
        lfs.append(add_noise_np(clean, 20.0, seed=100 + s))
    return np.stack(lfs)


def test_mesh_creation():
    import jax

    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    mesh = make_mesh(4)
    assert mesh.size == 4 and mesh.axis_names == ("lf",)
    with pytest.raises(ValueError):
        make_mesh(99)


@pytest.mark.slow
def test_batch_matches_single(batch):
    p = params()
    _, f_batch = denoise_batch(batch, p)
    _, f_single = run_bm5d(batch[1], p)
    np.testing.assert_allclose(
        np.asarray(f_batch)[1], np.asarray(f_single), atol=1e-4
    )


def test_sharded_matches_unsharded(batch):
    p = params()
    mesh = make_mesh(4)
    b_u, f_u = denoise_batch(batch, p)
    b_s, f_s = denoise_batch(batch, p, mesh=mesh)
    np.testing.assert_allclose(np.asarray(f_s), np.asarray(f_u), atol=1e-4)
    np.testing.assert_allclose(np.asarray(b_s), np.asarray(b_u), atol=1e-4)


def test_batch_not_divisible_raises(batch):
    with pytest.raises(ValueError):
        denoise_batch(batch[:3], params(), mesh=make_mesh(4))


def test_retry_per_lf_isolates_fault(batch, monkeypatch):
    """SURVEY §5.3: a faulted batch call is retried, then degraded to the
    identity estimate instead of raising, and the report names it. The
    batch is one program, so the fault (and the identity fallback) covers
    the whole batch; a transient fault recovers exactly through the retry."""
    import lfbm5d_tpu.pipeline.streaming as S

    p = params()
    _, f_ref = denoise_batch(batch, p)

    calls = {"n": 0}
    real_jit = S._jit_vmapped.__wrapped__  # undecorated builder

    def flaky_jit(fn):
        jfn = real_jit(fn)

        def wrapper(lfs, sigma_c):
            calls["n"] += 1
            if calls["n"] in (1, 2):  # the first TWO attempts fault
                raise RuntimeError("injected device fault")
            return jfn(lfs, sigma_c)

        return wrapper

    monkeypatch.setattr(S, "_jit_vmapped", flaky_jit)

    # retries=1 is not enough for a double fault -> identity fallback
    (b_out, f_out), report = denoise_batch(
        batch, p, retries=1, on_fail="identity", return_report=True,
    )
    assert [r["index"] for r in report] == [None]
    assert report[0]["attempts"] == 2
    assert "injected device fault" in report[0]["error"]
    np.testing.assert_allclose(np.asarray(f_out), batch, atol=1e-5)
    np.testing.assert_allclose(np.asarray(b_out), batch, atol=1e-5)

    # a single transient fault recovers exactly via retry
    calls["n"] = 1
    (b2, f2), report2 = denoise_batch(
        batch, p, retries=1, on_fail="identity", return_report=True,
    )
    assert report2 == [] and calls["n"] == 3
    np.testing.assert_allclose(np.asarray(f2), np.asarray(f_ref), atol=1e-6)


def test_default_behavior_still_raises(batch, monkeypatch):
    import lfbm5d_tpu.pipeline.streaming as S

    def always_fail(fn):
        def wrapper(lfs, sigma_c):
            raise RuntimeError("hard fault")

        return wrapper

    monkeypatch.setattr(S, "_jit_vmapped", always_fail)
    with pytest.raises(RuntimeError, match="hard fault"):
        denoise_batch(batch, params())


def test_stream_denoise_dirs_roundtrip(batch, tmp_path):
    """Disk->disk streaming driver: decode -> denoise -> encode with
    prefetch overlap; outputs match the in-memory batch path after
    save-quantization."""
    from lfbm5d_tpu.lf.io import load_lf, save_lf
    from lfbm5d_tpu.pipeline.stream_io import stream_denoise_dirs

    p = params()
    jobs = []
    for i in range(3):
        d_in = tmp_path / f"in_{i}"
        d_out = tmp_path / f"out_{i}"
        save_lf(np.clip(batch[i], 0, 255), str(d_in), "SAI_%02d_%02d.png")
        jobs.append((str(d_in), str(d_out)))

    report = stream_denoise_dirs(jobs, p, 2, 2)
    assert report.n_done == 3 and report.n_failed == 0
    assert report.seconds_total > 0 and len(report.lf_seconds) == 3

    # parity vs the in-memory path on the SAVED inputs (save quantizes)
    quant = np.stack(
        [load_lf(j[0], "SAI_%02d_%02d.png", 2, 2) for j in jobs]
    )
    _, f_ref = denoise_batch(quant, p)
    for i, j in enumerate(jobs):
        got = load_lf(j[1], "SAI_%02d_%02d.png", 2, 2)
        want = np.clip(np.round(np.asarray(f_ref)[i]), 0, 255)
        np.testing.assert_allclose(got, want, atol=1.0)


def test_stream_denoise_dirs_fault_isolation(batch, tmp_path):
    from lfbm5d_tpu.lf.io import save_lf
    from lfbm5d_tpu.pipeline.stream_io import (
        _default_run,
        stream_denoise_dirs,
    )

    p = params()
    jobs = []
    for i in range(3):
        d_in = tmp_path / f"fin_{i}"
        d_out = tmp_path / f"fout_{i}"
        save_lf(np.clip(batch[i], 0, 255), str(d_in), "SAI_%02d_%02d.png")
        jobs.append((str(d_in), str(d_out)))

    calls = {"n": 0}

    def flaky(fn, lf_dev, sigma_c):
        calls["n"] += 1
        # job 1 faults on BOTH attempts (calls 2 and 3 with retries=1)
        if calls["n"] in (2, 3):
            raise RuntimeError("injected stream fault")
        return _default_run(fn, lf_dev, sigma_c)

    report = stream_denoise_dirs(
        jobs, p, 2, 2, retries=1, on_fail="skip",
        _run=flaky,
    )
    assert report.n_done == 2 and report.n_failed == 1
    assert report.failures[0]["job"] == jobs[1]
    assert report.failures[0]["attempts"] == 2
    import os

    assert not os.path.exists(jobs[1][1])  # skip: no output for the bad LF
    assert os.path.exists(jobs[0][1]) and os.path.exists(jobs[2][1])
