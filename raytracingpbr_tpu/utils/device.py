"""Which device a measurement ran on.

Every result ``bench.py`` and ``chip_smoke.py`` print names the device; a
measurement path that finds no GPU fails instead of falling back to the CPU.
"""
from __future__ import annotations

import subprocess
from typing import Optional, Sequence


def nvidia_smi_name_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu(devices: Optional[Sequence] = None) -> dict:
    """Raise unless JAX's first device is a GPU; return
    ``{"platform", "kind", "count"}`` as JAX reports them."""
    if devices is None:
        import jax
        devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"needs an NVIDIA GPU; JAX found platform {dev.platform!r} "
            f"({dev.device_kind})")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}
