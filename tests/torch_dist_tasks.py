"""Rank-side tasks of the port's multi-device tests (no JAX).

Each function runs on every rank of a ``kmer_tpu_torch.parallel.launch``
world (or in the test process for a one-rank mesh, which needs no process
group) and returns numpy arrays or plain values.  Inputs are rebuilt on
every rank from a seed, as the tests build them for ``kmer_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from kmer_tpu_torch.native import pack2bit_rows
from kmer_tpu_torch.ops.count import count_windows
from kmer_tpu_torch.parallel.dist import (
    _extract_with_halo, _wire_keys_with_halo, count_kmers_sharded,
    local_block, make_sharded_count_step, merge_efficiency)
from kmer_tpu_torch.parallel.mesh import make_mesh


def make_batch(seed: int, n_reads: int, read_len: int, all_t: bool = True):
    """Seeded codes [n_reads, read_len] uint8 and lengths [n_reads] int32:
    ragged lengths (some shorter than any k, some 0) and, with ``all_t``,
    a full-length all-t read (its 32-mers equal the sentinel bit for
    bit)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n_reads, read_len), dtype=np.uint8)
    lengths = rng.integers(0, read_len + 1, n_reads).astype(np.int32)
    lengths[1] = read_len
    if all_t:
        codes[0] = 3
        lengths[0] = read_len
    return codes, lengths


def rows_of(table) -> tuple[np.ndarray, ...]:
    """(hi, lo, length, int64 counts) of a table's live groups."""
    t = table.trim()
    hi, lo, length = t.to_numpy()[:3]
    counts = (t.counts64() if hasattr(t, "counts64")
              else t.counts.numpy().astype(np.int64))
    return hi, lo, length, counts


def count_task(shape, k, canonical, merge, seed, n_reads, read_len,
               slack=2.0):
    """make_sharded_count_step on this rank: its table's live rows, the
    mesh's n_unique and overflow, and its local table's merge
    efficiency."""
    codes, lengths = make_batch(seed, n_reads, read_len)
    mesh = make_mesh(shape, device="cpu")
    out = make_sharded_count_step(mesh, k, canonical, merge, slack)(
        codes, lengths)
    table, overflow = out if merge == "partition" else (out, 0)
    keys, valid = _extract_with_halo(*local_block(codes, lengths, mesh), k,
                                     mesh, canonical)
    local = count_windows(keys, valid, k)
    eff = merge_efficiency(local, mesh.n_parts, merge, slack,
                           slots=keys.numel())
    return {"rows": rows_of(table), "n_unique": int(table.n_unique),
            "overflow": int(overflow), "efficiency": eff}


def retry_task(shape, k, seed, n_reads, read_len, cap):
    """count_kmers_sharded's partition merge with every bucket cut to
    ``cap`` slots (``dist.bucket_cap`` patched in this rank): the step's
    overflow and the retried (gathered) table."""
    from kmer_tpu_torch.parallel import dist

    codes, lengths = make_batch(seed, n_reads, read_len)
    mesh = make_mesh(shape, device="cpu")
    real = dist.bucket_cap
    dist.bucket_cap = lambda slots, n_parts, slack: cap
    try:
        _, overflow = make_sharded_count_step(mesh, k, merge="partition")(
            codes, lengths)
        table = count_kmers_sharded(codes, lengths, k, mesh,
                                    merge="partition")
    finally:
        dist.bucket_cap = real
    return {"overflow": int(overflow), "rows": rows_of(table)}


def halo_task(shape, k, canonical, seed, n_reads, read_len):
    """This rank's window keys and valid mask two ways: the eager
    extraction of its codes block, and one wire_keys call over its packed
    words with the halo words and the clamped length column."""
    codes, lengths = make_batch(seed, n_reads, read_len)
    mesh = make_mesh(shape, device="cpu")
    keys, valid = _extract_with_halo(*local_block(codes, lengths, mesh), k,
                                     mesh, canonical)
    wkeys, wvalid = _wire_keys_with_halo(
        *local_block(pack2bit_rows(codes), lengths, mesh), k, mesh,
        canonical)
    return keys.numpy(), valid.numpy(), wkeys.numpy(), wvalid.numpy()


def comm_task(shape):
    """Each collective of ``comm`` on rank-numbered int64 tensors."""
    from kmer_tpu_torch.parallel import comm

    mesh = make_mesh(shape, device="cpu")
    r = mesh.rank
    x = torch.arange(3, dtype=torch.int64) + 10 * r
    slabs = torch.arange(mesh.n_parts * 2, dtype=torch.int64).reshape(
        mesh.n_parts, 2) + 100 * r
    return {
        "gather": comm.all_gather_tiled(x, mesh).numpy(),
        "gather_data": comm.all_gather_tiled(x, mesh, "data").numpy(),
        "a2a": comm.all_to_all_slabs(slabs, mesh).numpy(),
        "sum": int(comm.all_reduce_sum(torch.tensor(r + 1), mesh)),
        "sum_data": int(comm.all_reduce_sum(torch.tensor(r + 1), mesh,
                                            "data")),
        "ring": comm.ring_shift(x, mesh).numpy(),
        "coords": mesh.coords,
    }


def counter_task(shape, k, seed, n_reads, read_len):
    """KmerCounter.count_sharded on this rank."""
    from kmer_tpu_torch.config import EngineConfig
    from kmer_tpu_torch.models.pipeline import KmerCounter

    codes, lengths = make_batch(seed, n_reads, read_len)
    model = KmerCounter(EngineConfig(k=k, canonical=True, mesh_shape=shape),
                        device="cpu")
    return rows_of(model.count_sharded(codes, lengths))


def stream_task(shape, k, canonical, seed, n_batches, n_reads, read_len,
                acc_capacity, ckpt=None, ckpt_every=4, stop_after=None):
    """stream_sharded_count over ``n_batches`` seeded batches (the first
    ``stop_after`` of them when given), checkpointing to ``ckpt``: this
    rank's shard, n_unique and overflow."""
    from kmer_tpu_torch.parallel.streaming import (
        ResumableStream, batches_of, stream_sharded_count)

    codes, lengths = make_batch(seed, n_batches * n_reads, read_len,
                                all_t=False)
    mesh = make_mesh(shape, device="cpu")
    batches = list(batches_of(codes, lengths, n_reads))[:stop_after]
    resumable = ResumableStream(ckpt) if ckpt else None
    acc, overflow = stream_sharded_count(
        batches, k, mesh, canonical=canonical, acc_capacity=acc_capacity,
        resumable=resumable, ckpt_every=ckpt_every)
    return {"rows": rows_of(acc), "n_unique": int(acc.n_unique),
            "overflow": overflow}


def packed_step_task(shape, k, canonical, seed, n_reads, read_len,
                     acc_capacity):
    """One sharded stream step from raw codes and one from the packed wire
    of the same batch: both accumulators' live rows and overflows."""
    from kmer_tpu_torch.parallel.streaming import (
        empty_sharded_acc, make_sharded_stream_step)

    codes, lengths = make_batch(seed, n_reads, read_len)
    mesh = make_mesh(shape, device="cpu")
    zero = torch.zeros((), dtype=torch.int64)
    out = []
    for width, batch in ((None, codes), (read_len, pack2bit_rows(codes))):
        step = make_sharded_stream_step(mesh, k, canonical, acc_capacity,
                                        packed_width=width)
        acc, ovf = step(empty_sharded_acc(mesh, acc_capacity), zero, batch,
                        lengths.astype(np.uint16))
        out.append((rows_of(acc), int(ovf)))
    return out


def index_task(shape, kmers, eq, prefixes, patterns, cap):
    """ShardedIndex answers on this rank."""
    from kmer_tpu_torch.packed import PackedKmers
    from kmer_tpu_torch.parallel.shindex import ShardedIndex

    mesh = make_mesh(shape, device="cpu")
    sidx = ShardedIndex.build(PackedKmers.from_strings(kmers), mesh)
    return {"eq": [r.tolist() for r in sidx.search_eq(eq, cap=cap)],
            "prefix": [r.tolist() for r in
                       sidx.search_prefix(prefixes, cap=cap)],
            "pattern": [r.tolist() for r in
                        sidx.search_pattern(patterns, cap=cap)]}


def filter_task(shape, kmers, queries):
    """filter_sharded answers on this rank: [(op, query, row ids)]."""
    from kmer_tpu_torch.packed import PackedKmers
    from kmer_tpu_torch.parallel.query import filter_sharded

    mesh = make_mesh(shape, device="cpu")
    col = PackedKmers.from_strings(kmers)
    return [filter_sharded(col, op, q, mesh).tolist() for op, q in queries]


def shq_task(n_keys, n_queries):
    """run_sharded_query_bench over the world's ranks."""
    from kmer_tpu_torch.bench import run_sharded_query_bench

    return run_sharded_query_bench(n_keys, n_queries, device="cpu")


class Worlds:
    """Gloo worlds of CPU ranks by size, started once and reused (a test
    module holds one ``Worlds`` for its whole run); a one-rank mesh runs
    in the calling process."""

    def __init__(self, timeout_s: float = 120.0):
        self.timeout_s = timeout_s
        self._worlds: dict = {}

    def run(self, shape, fn, *args, **kwargs) -> list:
        """``fn`` on every rank of a mesh of ``shape``; results by rank."""
        from kmer_tpu_torch.parallel.launch import World

        n = shape[0] * shape[1]
        if n == 1:
            return [fn(*args, **kwargs)]
        if n not in self._worlds:
            self._worlds[n] = World(n, "gloo", "cpu", self.timeout_s,
                                    threads=1)
        return self._worlds[n].run(fn, *args, **kwargs)

    def close(self) -> None:
        for w in self._worlds.values():
            w.close(kill=True)
        self._worlds.clear()
