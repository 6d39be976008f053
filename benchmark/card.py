"""The card a run uses: its name, its power limit and its published
memory bandwidth peak (``peaks.json``, matched by a part of the name as
``torch.cuda.get_device_name`` gives it)."""

from __future__ import annotations

import json
import os
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))


def hbm_peak(name: str, table: str = os.path.join(HERE, "peaks.json")
             ) -> float:
    """The published HBM bytes a second of the card called ``name``; a
    card with no entry raises."""
    with open(table) as f:
        rows = json.load(f)["hbm_bytes_per_s"]
    for part, peak in rows:
        if part in name:
            return float(peak)
    raise ValueError(f"no published HBM peak for {name!r} in {table}")


def power_limit(index: int = 0) -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e.__class__.__name__})"
    line = out.stdout.strip().splitlines()
    return line[0] if out.returncode == 0 and line else "unknown"
