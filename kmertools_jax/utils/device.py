"""What the program runs on: the card's name and power limit as
nvidia-smi reports them, and JAX's view of the devices.

Every measurement names its device with these, and a measurement path
calls `require_gpu` so that it fails, instead of falling back to the
CPU, when JAX finds no GPU.
"""

from __future__ import annotations

import subprocess


def card_facts() -> str:
    """`name, power.limit` of each card, one line per card, or a line
    saying why nvidia-smi gave none."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    if r.returncode != 0:
        return f"nvidia-smi failed: {r.stderr.strip()[-200:]}"
    return r.stdout.strip()


def require_gpu() -> dict:
    """{"platform", "kind", "count"} of JAX's default backend, or exit
    (status 1, the reason on stderr) when that backend is not a GPU."""
    import jax

    devs = jax.devices()
    facts = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    if facts["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {facts['platform']} "
            f"({facts['kind']}); refusing to measure it in the GPU's place"
        )
    return facts
