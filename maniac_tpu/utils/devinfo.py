"""Names of the device a number was measured on.

Every timing the tools print carries the JAX device (platform, kind,
count) and, on an NVIDIA card, its name and power limit: a card set
below its maximum power runs slower under load, so a number without the
limit beside it cannot be compared with another.
"""

from __future__ import annotations

import subprocess


def device_info() -> dict:
    """The default JAX device as JAX reports it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def device_bytes_limit() -> int | None:
    """Memory the default device grants this process (None where the
    backend reports no limit, as the CPU does)."""
    import jax

    stats = jax.devices()[0].memory_stats()
    return stats.get("bytes_limit") if stats else None


def card_info() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` (first card), read by a
    child process that does not touch JAX; "not available" without
    nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "not available"


def device_label() -> str:
    """One-line label for printed measurements."""
    d = device_info()
    return (f"{d['platform']}/{d['kind']} x{d['count']} "
            f"[card: {card_info()}]")
