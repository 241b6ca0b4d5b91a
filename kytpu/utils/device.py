"""What a measurement ran on: JAX's device and the card behind it.

Every benchmark line and every on-card check names the device, the card
and its power limit, because a card set below its maximum power runs
slower under load. The nvidia-smi query runs in a child process that never
touches JAX (a second JAX process on the card would reserve its memory).
"""

from __future__ import annotations

import subprocess


def card_info() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    (one line per card), or a note saying why it is unavailable."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    text = out.stdout.strip()
    return text if out.returncode == 0 and text else \
        f"nvidia-smi failed (rc={out.returncode})"


def device_record(card: str | None = None) -> dict:
    """{"platform", "kind", "count", "card"} of JAX's default devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs),
            "card": card if card is not None else card_info()}


def require_gpu() -> None:
    """Fail (SystemExit 1) unless JAX's default devices are GPUs: device
    timings from a CPU run are never reported."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU found (JAX platform {platform!r}): "
                         "this measurement runs only on the card")
