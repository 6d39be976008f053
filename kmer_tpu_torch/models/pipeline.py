"""KmerCounter: the engine's flagship pipeline (counterpart of
``kmer_tpu/models/pipeline.py``).

Extraction, canonicalization and counting over padded read batches on
one device.  Up to ``DENSE_ROUTE_K`` the count is the dense histogram
(``ops/dense_count``); above it, the sort and the segment-count kernel
(``ops/count.count_kmers``).  ``sharded_step``/``count_sharded`` count
over a mesh of ranks (``parallel.dist``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import EngineConfig
from ..device import resolve_device
from ..ops.count import CountTable, count_kmers
from ..ops.dense_count import DENSE_ROUTE_K, check_bin_max, count_kmers_dense


class KmerCounter:
    """Configured extract + count pipeline over padded read batches on
    ``device``."""

    def __init__(self, config: EngineConfig, *, device: str | torch.device):
        self.config = config
        self.device = resolve_device(device)
        # running max of the dense route's bin counts, kept on the device
        # and read once by check_exact: a host read a step would
        # synchronize every step
        self._dense_max: torch.Tensor | None = None
        self._sharded_steps: dict = {}

    def _forward(self, codes: torch.Tensor, lengths: torch.Tensor
                 ) -> CountTable:
        k, canonical = self.config.k, self.config.canonical
        if k <= DENSE_ROUTE_K:
            return count_kmers_dense(codes, lengths, k, canonical)
        return count_kmers(codes, lengths, k, canonical=canonical)

    def step(self, codes: np.ndarray | torch.Tensor,
             lengths: np.ndarray | torch.Tensor) -> CountTable:
        """Padded reads [B, L] + lengths [B] (numpy or tensors, moved to
        the counter's device) -> CountTable.

        The dense route's exactness is tracked on the device; call
        ``check_exact()`` after the last step.
        """
        out = self._forward(torch.as_tensor(codes, device=self.device),
                            torch.as_tensor(lengths, device=self.device))
        if self.config.k <= DENSE_ROUTE_K:
            m = out.counts.max()
            self._dense_max = m if self._dense_max is None else \
                torch.maximum(self._dense_max, m)
        return out

    def check_exact(self) -> None:
        """Raise if a dense-route bin reached the int32 counts lane's
        limit: one host read over the whole stream; a no-op on the sort
        route."""
        if self._dense_max is not None:
            check_bin_max(int(self._dense_max))

    # --- multi device --------------------------------------------------------

    def sharded_step(self, mesh=None):
        """The multi-rank counting step (gather merge) of a mesh, built
        once per mesh; the default mesh is ``config.mesh_shape`` over the
        process group, on the counter's device."""
        from ..parallel.dist import make_sharded_count_step
        from ..parallel.mesh import make_mesh

        if mesh is None:
            mesh = make_mesh(self.config.mesh_shape, device=self.device)
        key = (id(mesh), self.config.k, self.config.canonical)
        if key not in self._sharded_steps:
            self._sharded_steps[key] = make_sharded_count_step(
                mesh, self.config.k, self.config.canonical)
        return self._sharded_steps[key]

    def count_sharded(self, codes, lengths, mesh=None) -> CountTable:
        """The whole table of a global batch, on every rank."""
        return self.sharded_step(mesh)(codes, lengths)
