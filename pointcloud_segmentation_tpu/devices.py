"""Which accelerator a run is on, for every number a run reports.

Measurements name their device: JAX's platform, ``device_kind`` and device
count, plus the card's name and power limit as ``nvidia-smi`` reports them
(a card set below its maximum power runs slower under load).  A
measurement path refuses to run without a GPU instead of falling back to
the CPU.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader")


class NoGpuError(RuntimeError):
    """JAX's default device is not a GPU."""


def nvidia_smi_lines() -> list[str]:
    """``name, power.limit`` per card, read by ``nvidia-smi`` in a child
    process (no JAX there); empty when the tool is absent or fails."""
    try:
        r = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                           timeout=30)
    except (OSError, subprocess.SubprocessError):
        return []
    if r.returncode != 0:
        return []
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def device_tag() -> dict:
    """{"platform", "kind", "count", "gpu"} of the default JAX backend."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "gpu": nvidia_smi_lines()}


def require_gpu() -> dict:
    """The device tag, or NoGpuError when JAX's default device is no GPU."""
    tag = device_tag()
    if tag["platform"] != "gpu":
        raise NoGpuError(
            f"needs a GPU; JAX's default device is {tag['platform']} "
            f"({tag['kind']}, x{tag['count']})")
    return tag
