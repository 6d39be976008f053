"""Predicate queries over a kmer column sharded on the "data" axis.

The counterpart of ``kmer_tpu/parallel/query.py``: each rank evaluates the
vectorized predicate on its shard of the column, and the shards' hit
masks are all-gathered over "data".  Every rank is given the whole
column and gets the whole answer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.predicates import (
    qkmer_mask_vector, v_contains, v_equals, v_starts_with)
from ..packed import KmerColumn, PackedKmers, key_from_hi_lo
from ..types import Kmer, Qkmer
from .comm import all_gather_tiled
from .mesh import AXIS_DATA, Mesh


def make_filter_step(mesh: Mesh, op: str, query):
    """step(key_l, length_l) -> the global bool mask: op "eq" | "prefix" |
    "pattern" of the Kmer/Qkmer literal ``query`` on this rank's shard,
    gathered over "data"."""
    if op in ("eq", "prefix"):
        probe = KmerColumn.from_packed(PackedKmers.single(Kmer(query)),
                                       mesh.device)[0]
    elif op == "pattern":
        masks, qlen = qkmer_mask_vector(Qkmer(query))
    else:
        raise ValueError(op)

    def step(key_l: torch.Tensor, length_l: torch.Tensor) -> torch.Tensor:
        col = KmerColumn(key=key_l, length=length_l)
        if op == "eq":
            m = v_equals(col, probe)
        elif op == "prefix":
            m = v_starts_with(col, probe)
        else:
            m = v_contains(col, masks, qlen)
        return all_gather_tiled(m.to(torch.uint8), mesh, AXIS_DATA) != 0

    return step


def filter_sharded(col: PackedKmers, op: str, query, mesh: Mesh
                   ) -> np.ndarray:
    """Row ids matching the predicate, computed data-parallel."""
    n = col.hi.shape[0]
    pad = (-n) % mesh.n_parts
    key = np.pad(key_from_hi_lo(col.hi, col.lo), (0, pad))
    # padding rows get length -1, which matches no query
    ln = np.pad(np.asarray(col.length, np.int32), (0, pad),
                constant_values=-1)
    n_loc = key.size // mesh.shape[0]
    d = mesh.coords[0]
    at = slice(d * n_loc, (d + 1) * n_loc)
    step = make_filter_step(mesh, op, query)
    mask = step(torch.from_numpy(key[at]).to(mesh.device),
                torch.from_numpy(ln[at]).to(mesh.device))
    return np.flatnonzero(mask.cpu().numpy()[:n])
