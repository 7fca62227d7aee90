"""What a measurement ran on: JAX's devices and the cards' name and power
limit, so that every number printed can name its hardware."""

from __future__ import annotations

import shutil
import subprocess


def card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    one card per ``;``-separated entry ("no nvidia-smi" on other hosts).
    Runs nvidia-smi itself as the child, which never imports JAX."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "no nvidia-smi"
    r = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    return "; ".join(lines) or "nvidia-smi failed: " + r.stderr.strip()


def device_info() -> dict:
    """JAX's view of the device set: platform, device kind and count."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
