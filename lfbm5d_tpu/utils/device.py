"""What a measurement ran on: the JAX device and the card's power limit.

Every timing this repository prints names its device. A measurement path
that finds no GPU fails; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess


def nvidia_smi_name_power() -> list[str]:
    """One `name, power.limit` line per card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def require_gpu() -> dict:
    """{platform, kind, count} of the JAX devices; SystemExit(2) unless GPU."""
    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if info["platform"] != "gpu":
        raise SystemExit(
            f"error: JAX found no GPU (platform {info['platform']!r}); "
            "device measurements need the card"
        )
    return info
