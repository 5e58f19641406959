"""Machine fingerprint for benchmark provenance.

The port of ``repro/core/machine.py``. A number taken on the card is only
comparable with another taken on the same card at the same power limit (an
H100 set below its 700 W runs slower under load), so a benchmark record
says where it came from: the host's stable keys, as the reference's, and in
place of its jax version, backend and devices, the torch and CUDA versions,
the backend, and each card's name and power limit as ``nvidia-smi`` reports
them.

Nothing volatile goes in (no load, clocks or timestamps): two calls on one
machine return equal dicts.
"""

from __future__ import annotations

import os
import platform
import subprocess

import torch

from repro_torch.device import resolve_device

__all__ = ["machine_fingerprint"]


def _power_limits() -> list[str]:
    """Each card's ``power.limit`` from ``nvidia-smi`` (e.g. "700.00 W");
    raises if ``nvidia-smi`` fails or reports no card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    rows = [line.rsplit(",", 1) for line in out.strip().splitlines() if line.strip()]
    if not rows or any(len(r) != 2 for r in rows):
        raise RuntimeError(f"nvidia-smi reported no card: {out!r}")
    return [limit.strip() for _name, limit in rows]


def machine_fingerprint(device: str | torch.device | None = None) -> dict:
    """Stable description of the host and the torch stack a benchmark ran
    on. ``device=None`` means the card (raising without one); on the CPU,
    ``devices`` is empty and ``power_limit`` None."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    return {
        "platform": platform.platform(),
        "machine": platform.machine(),
        "cpu_count": os.cpu_count(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": dev.type,
        "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                    if on_card else []),
        "power_limit": _power_limits() if on_card else None,
    }
