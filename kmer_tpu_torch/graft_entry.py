"""Single-device entry point of the flagship pipeline: the counterpart of
``__graft_entry__.entry`` (the multi-device dryrun waits for the
multi-device port).

    fn, args = entry("cuda")
    table = fn(*args)
"""

from __future__ import annotations

import numpy as np
import torch

from .config import EngineConfig
from .models.pipeline import KmerCounter
from .ops.extract import simulate_reads


def entry(device: str | torch.device):
    """(fn, example_args): ``KmerCounter._forward`` at k = 8, canonical,
    over 256 reads of 64 bases from ``simulate_reads(seed=0)`` on
    ``device`` (the sort route: 8 > DENSE_ROUTE_K)."""
    cfg = EngineConfig(k=8, canonical=True, read_len=64)
    model = KmerCounter(cfg, device=device)
    reads = simulate_reads(num_reads=256, read_len=cfg.read_len, seed=0)
    lengths = np.full(256, cfg.read_len, np.int32)
    return model._forward, (torch.as_tensor(reads, device=model.device),
                            torch.as_tensor(lengths, device=model.device))
