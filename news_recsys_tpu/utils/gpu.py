"""The GPU a measurement runs on: refuse any other device, and name the card.

Measurement entry points (``bench.py``, ``chip_smoke.py``) call
:func:`require_gpu` first: a number taken on the CPU is never reported as a
device number. :func:`card_info` reads the card's name and power limit, which
go beside every number, because a card set below its top limit runs slower
under load.
"""

from __future__ import annotations

import subprocess
from typing import Dict

import jax


def require_gpu():
    """JAX's first device, or ``SystemExit`` when it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default device is {dev.platform!r} "
                         f"({dev.device_kind})")
    return dev


def nvidia_smi_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def card_info() -> Dict[str, object]:
    """Device kind and count as JAX reports them, plus the first card's
    nvidia-smi name and power limit."""
    devs = jax.devices()
    name, power = (x.strip() for x in nvidia_smi_name_power().splitlines()[0].split(","))
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "card": name, "power_limit": power}
