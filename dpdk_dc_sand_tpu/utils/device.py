"""What a result ran on: the JAX device and the card behind it."""

from __future__ import annotations

import subprocess


def device_record() -> dict:
    """``platform``, ``kind`` and ``count`` of JAX's devices."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def card_info() -> list[str]:
    """One ``name, power.limit`` line per NVIDIA card, from ``nvidia-smi``.

    Runs ``nvidia-smi`` as a child that never touches JAX; raises
    ``FileNotFoundError`` or ``CalledProcessError`` where it cannot.
    """
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
