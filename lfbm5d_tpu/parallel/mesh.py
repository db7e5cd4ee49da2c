"""Device-mesh helpers for multi-chip scaling.

The reference has no distributed backend at all (SURVEY.md §2: single
process, OpenMP only). The scaling story here (SURVEY.md §5.8) is:

  * Streaming throughput (driver config 5): whole light fields are
    embarrassingly parallel — shard the LF batch axis over a 1D device
    mesh ('lf' axis) with shard_map; zero collectives inside a light field.
  * A single LF never crosses chips at target sizes; the halo-exchange SAI
    sharding reserved for that case would ride `ppermute` over the same mesh.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def ensure_virtual_devices(n_devices: int) -> bool:
    """Provision an `n_devices` virtual CPU platform for mesh testing.

    Forcing the host platform only works BEFORE the first JAX backend use
    (a post-init `jax.config.update("jax_platforms")` is silently ignored
    and there is no clear_backends), so this must be the
    first JAX-touching call in the process. Returns True if the virtual
    platform was (or already had been) provisioned, False if a backend was
    already initialized and the flags could not be applied.

    Intended for dryrun/test contexts (SURVEY.md §4.2.6): it trades the real
    accelerator for an n-way CPU mesh. Production code paths should build
    meshes from real devices via make_mesh.
    """
    from jax._src import xla_bridge

    if xla_bridge.backends_are_initialized():
        return len(jax.devices()) >= n_devices
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={n_devices}"
        ).strip()
    jax.config.update("jax_platforms", "cpu")
    return True


def make_mesh(n_devices: int | None = None, axis: str = "lf") -> Mesh:
    """A 1D mesh over the first `n_devices` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devs)} "
                "(call parallel.ensure_virtual_devices(N) before any JAX "
                "use, or set XLA_FLAGS=--xla_force_host_platform_device_"
                "count=N in the environment)"
            )
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))
