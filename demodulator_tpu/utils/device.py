"""The device a measurement runs on: refuse anything but a GPU, and name
the card the way every reported number must carry it."""
from __future__ import annotations

import subprocess

__all__ = ["require_gpu", "card_lines"]


def require_gpu():
    """Return jax.devices() if JAX's default backend is the GPU; raise
    RuntimeError otherwise (measurements never fall back to the CPU)."""
    import jax
    plat = jax.default_backend()
    if plat != "gpu":
        raise RuntimeError(f"JAX found no GPU (default backend {plat!r})")
    return jax.devices()


def card_lines() -> list[str]:
    """One line per card, as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (a card set below its maximum power
    limit runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
