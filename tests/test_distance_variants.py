"""Batched BM alternatives must agree exactly with the scan-based forms."""

import numpy as np
import jax.numpy as jnp

from lfbm5d_tpu.lf import synthetic_lf
from lfbm5d_tpu.lf.noise import add_noise_np
from lfbm5d_tpu.lf.pad import ind_initialize, pad_lf
from lfbm5d_tpu.ops.distances import (
    cross_argmin,
    cross_argmin_all,
    self_distances,
    self_distances_batched,
)


def _planes():
    clean = synthetic_lf(2, 2, 24, 28, channels=1, seed=0)
    noisy = add_noise_np(clean, 20.0, seed=1)
    padded = pad_lf(noisy, 5)
    return jnp.asarray(padded[..., 0].reshape(4, 34, 38), jnp.float32)


def test_self_distances_batched_matches_scan():
    planes = _planes()
    ys = ind_initialize(24, 8, 3) + 5
    xs = ind_initialize(28, 8, 3) + 5
    a = np.asarray(self_distances(planes[0], ys, xs, 8, 4))
    b = np.asarray(self_distances_batched(planes[0], ys, xs, 8, 4))
    np.testing.assert_array_equal(a, b)


def test_cross_argmin_all_matches_scan():
    planes = _planes()
    got = np.asarray(cross_argmin_all(planes[0], planes, 8, 1, a_chunk=3))
    for ai in range(4):
        want = np.asarray(cross_argmin(planes[0], planes[ai], 8, 1))
        np.testing.assert_array_equal(got[ai], want)
