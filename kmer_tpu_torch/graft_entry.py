"""Entry points of the flagship pipeline: the one-device step and the
multi-device dryrun (counterparts of ``__graft_entry__.entry`` and
``dryrun_multichip``).

    fn, args = entry("cuda")
    table = fn(*args)
    dryrun_multichip(4, "cuda")  # 4 gloo ranks sharing the card
"""

from __future__ import annotations

import collections
import os
import tempfile

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


def _oracle(seqs, k: int) -> dict:
    want = collections.Counter()
    for s in seqs:
        want.update(s[i: i + k] for i in range(max(len(s) - k + 1, 0)))
    return dict(want)


def _write_fasta(path: str, seqs) -> None:
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">r{i}\n{s}\n")


def _dryrun_inputs(shape):
    dp, sp = shape
    batch, read_len = 4 * dp, 8 * sp
    reads = simulate_reads(num_reads=batch, read_len=read_len, seed=1)
    lengths = np.full(batch, read_len, np.int32)
    lengths[0] = max(5, read_len // 2)  # one ragged read through the halo
    reads4 = simulate_reads(num_reads=4 * batch, read_len=read_len, seed=2)
    return reads, lengths, reads4, np.tile(lengths, 4), batch


def _dryrun_rank(shape, tmp: str, device: str) -> dict:
    """One rank's share of ``dryrun_multichip``: returns its tables as
    {kmer: count} dicts (partition shards are disjoint)."""
    from .index import KmerIndex
    from .packed import PackedKmers
    from .parallel.dist import count_kmers_sharded
    from .parallel.driver import run_distcount
    from .parallel.mesh import make_mesh
    from .parallel.shindex import ShardedIndex
    from .parallel.streaming import batches_of, stream_sharded_count

    from .parallel.multihost import local_rank, rank_device

    from .kernels import launches, zero_launches

    mesh = make_mesh(shape, device=rank_device(device, local_rank()))
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    zero_launches()
    cfg = EngineConfig(k=5, canonical=True)
    model = KmerCounter(cfg, device=mesh.device)
    reads, lengths, reads4, lengths4, batch = _dryrun_inputs(shape)
    table = model.count_sharded(reads, lengths, mesh)
    part = count_kmers_sharded(reads, lengths, cfg.k, mesh,
                               canonical=cfg.canonical, merge="partition")
    acc, overflow = stream_sharded_count(
        batches_of(reads4, lengths4, batch), cfg.k, mesh,
        canonical=cfg.canonical, acc_capacity=1024)
    assert overflow == 0, overflow
    ref = model.count_sharded(reads4, lengths4, mesh)

    # sharded index serving: per-shard sorts + replicated queries
    kmers = ["acgta", "cgtac", "acgta", "", "t" * 32, "acg"]
    col = PackedKmers.from_strings(kmers)
    sidx = ShardedIndex.build(col, mesh)
    host = KmerIndex.build(col)
    for q in ["acgta", "", "ttt"]:
        assert sidx.search_eq([q], cap=4)[0].tolist() == \
            host.search_eq(q).tolist(), q
    for q in ["ac", "", "t"]:
        assert sidx.search_prefix([q], cap=8)[0].tolist() == \
            host.search_prefix(q).tolist(), q

    # distcount: the ranks of one seq group read their data rank's file
    d = mesh.coords[0]
    local, overflow = run_distcount(
        os.path.join(tmp, f"reads{d}.fasta"), cfg.k, batch=4, width=16 * shape[1],
        acc_capacity=512, mesh=mesh, ckpt=os.path.join(tmp, "ck"),
        ckpt_every=1, device=mesh.device)
    assert overflow == 0, overflow
    spill = _dryrun_spill_resume(mesh, tmp)
    return {"table": table.to_dict(), "total": table.total(),
            "n_unique": int(table.n_unique), "part": part.to_dict(),
            "acc": acc.to_dict(), "ref": ref.to_dict(),
            "distcount": local.to_dict(),
            "spill": spill,
            "launches": launches()}


def _dryrun_spill_resume(mesh, tmp: str) -> dict:
    """A distcount stream whose capacity forces spills, and a resume from
    a checkpoint written over the first half of the file: both must
    equal the uninterrupted run.  Returns this rank's spill-run count and
    table."""
    from .parallel.driver import run_distcount

    d = mesh.coords[0]
    full = os.path.join(tmp, f"spill{d}.fasta")
    half = os.path.join(tmp, f"spill_half{d}.fasta")
    common = dict(k=8, batch=64, width=32, acc_capacity=4096, mesh=mesh,
                  ckpt_every=2, spill_threshold=0.5, device=mesh.device)
    straight, ovf = run_distcount(
        full, ckpt=os.path.join(tmp, "ck_a"),
        spill_dir=os.path.join(tmp, f"runs_a{mesh.rank}"), **common)
    assert ovf == 0, ovf
    n_runs = len(os.listdir(os.path.join(tmp, f"runs_a{mesh.rank}")))
    _, ovf = run_distcount(
        half, ckpt=os.path.join(tmp, "ck_b"),
        spill_dir=os.path.join(tmp, f"runs_b{mesh.rank}"), **common)
    assert ovf == 0, ovf
    resumed, ovf = run_distcount(
        full, ckpt=os.path.join(tmp, "ck_b"),
        spill_dir=os.path.join(tmp, f"runs_b{mesh.rank}"), **common)
    assert ovf == 0, ovf
    assert resumed.to_dict() == straight.to_dict(), \
        "mid-stream resume != uninterrupted run"
    return {"runs": n_runs, "table": straight.to_dict()}


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout_s: float = 600.0) -> dict:
    """One full sharded workout over n gloo ranks sharing ``device`` (one
    process per rank, ``parallel.launch.World``), on a (data, seq) mesh
    with seq = 2 where n is even, so the halo crosses ranks: the gather
    and partition merges agree with each other and a one-rank count, a
    4-step sharded stream equals a one-shot count, the sharded index
    equals the host index, and the distcount driver, with forced spills
    and a mid-stream resume, equals a host oracle.  Returns the mesh
    shape, the spill runs and each rank's count-path kernel launches."""
    from .parallel.launch import World
    from .parallel.mesh import make_mesh, mesh_shape_for
    from .parallel.streaming import batches_of, stream_sharded_count

    seq = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    shape = mesh_shape_for(n_devices, seq_parallel=seq)
    dp = shape[0]
    cfg = EngineConfig(k=5, canonical=True)
    reads, lengths, reads4, lengths4, batch = _dryrun_inputs(shape)
    rng = np.random.default_rng(3)
    lut = np.array(list("acgt"))
    with tempfile.TemporaryDirectory() as tmp:
        seqs = []
        for d in range(dp):
            part = ["".join(rng.choice(lut, int(rng.integers(6, 40))))
                    for _ in range(8)]
            _write_fasta(os.path.join(tmp, f"reads{d}.fasta"), part)
            seqs += part
        spill_rng = np.random.default_rng(11)
        spill_seqs = []
        for d in range(dp):
            codes = spill_rng.integers(0, 4, (64 * 64, 32), dtype=np.uint8)
            rows = ["".join(lut[c]) for c in codes]
            _write_fasta(os.path.join(tmp, f"spill{d}.fasta"), rows)
            _write_fasta(os.path.join(tmp, f"spill_half{d}.fasta"),
                         rows[: len(rows) // 2])
            spill_seqs += rows
        with World(n_devices, "gloo", device, timeout_s) as world:
            out = world.run(_dryrun_rank, shape, tmp, device)

    table = out[0]["table"]
    expect_total = int(np.maximum(lengths - cfg.k + 1, 0).sum())
    assert out[0]["total"] == expect_total, (out[0]["total"], expect_total)
    assert all(o["table"] == table for o in out), "ranks' gathers differ"

    def union(name):
        merged: dict = {}
        for o in out:
            assert not set(merged) & set(o[name]), f"{name} shards overlap"
            merged.update(o[name])
        return merged

    assert union("part") == table, "partition merge != gather merge"
    assert union("acc") == out[0]["ref"], "streamed accumulator != one-shot"
    # one rank (this process): the windows fold straight into the
    # accumulator
    acc1, ovf1 = stream_sharded_count(
        batches_of(reads4, lengths4, batch), cfg.k,
        make_mesh((1, 1), device=device), canonical=cfg.canonical,
        acc_capacity=1024)
    assert ovf1 == 0 and acc1.to_dict() == out[0]["ref"], \
        "one-rank fold != sharded stream"
    assert union("distcount") == _oracle(seqs, cfg.k), \
        "distcount != host oracle"
    spills = sum(o["spill"]["runs"] for o in out)
    assert spills > 0, "the spill workout did not spill"
    spill_table: dict = {}
    for o in out:
        assert not set(spill_table) & set(o["spill"]["table"])
        spill_table.update(o["spill"]["table"])
    assert spill_table == _oracle(spill_seqs, 8), "spilled distcount != oracle"
    print(f"dryrun_multichip ok: mesh={shape}, {expect_total} kmers counted, "
          f"{out[0]['n_unique']} unique (gather + partition merges agree; "
          "4-step sharded stream exact; sharded index == host index; "
          f"distcount driver exact; spill workout: {spills} spill runs "
          "K-way-merged exact, mid-stream resume exact)")
    return {"shape": shape, "spills": spills,
            "launches": [o["launches"] for o in out]}
