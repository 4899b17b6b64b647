"""The card a run uses: the look for it, and what the result line says of
it.  A run that finds fewer cards than its cell asks for exits before it
loads anything; nothing falls back to the CPU."""

from __future__ import annotations

import subprocess
import sys

import torch


def require(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        sys.exit(f"the cell asks for {chips} cards; "
                 f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def power_limit() -> str | None:
    """``name, power.limit`` as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def clocks() -> str | None:
    """SM clock, power draw, temperature and active throttle reasons, as
    nvidia-smi reads them now, or None: beside a run's numbers, so that a
    card held below its clock shows."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu,"
             "clocks_throttle_reasons.active", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def info(device: torch.device, chips: int, peak_bytes: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": peak_bytes,
            "power_limit": power_limit()}


def peak_bytes(device: torch.device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
