"""What the long runs share: the card's line, JSON records and the
checkout's root."""

from __future__ import annotations

import json
import os
import subprocess
import tempfile


def card_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card), or None where nvidia-smi is absent or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def environment(device) -> dict:
    """The device's name, the card's line and the torch build, for a
    record.  Reads the card's name from nvidia-smi, so a process that
    never used the card does not start CUDA here."""
    import torch

    card = card_line()
    device = torch.device(device)
    name = card.split(",")[0] if device.type == "cuda" and card else str(
        device)
    return {"device": name, "card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def write_json(path: str, obj: dict) -> None:
    """Write ``obj`` as indented JSON, replacing ``path`` atomically."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def repo_root() -> str:
    """The checkout's root: the directory that holds the package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
