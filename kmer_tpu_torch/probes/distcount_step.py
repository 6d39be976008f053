"""The distcount step split up: ``scripts/probe_r5g.py`` on the port.

The workload is the script's: the 313 MB FASTQ of ``count_phases``
through ``pipeline.file_batch_feed`` at batch 65,536, width 160 and
128 MiB chunks (16 batches, the last padded), and
``make_sharded_stream_step`` with ``packed_width=160`` and 8M slots on a
(1,1) mesh of a one-rank ``torch.distributed`` group (NCCL on a card, as
``distcount --backend nccl`` runs one rank; gloo on the CPU).  Timed:
the feed; the first and the second step; 8 steps blocked one by one
(each synchronized); 6 steps pipelined (one synchronize after them).

On one rank the step folds the windows straight into its accumulator and
skips the all_to_all (``parallel/streaming.py``: one rank owns the whole
hash range).  So the same steps run again on a (2,1) mesh of two gloo
processes sharing the device, where each step partitions its table and
swaps the buckets with one all_to_all.  gloo takes no CUDA tensor there,
so ``parallel.comm`` stages it through pinned host memory; each rank
then times, on the last step's own bucket tensors (caught on their way
to ``all_to_all_slabs``), the whole staged call and its three legs: the
copy to a pinned host buffer, the gloo collective, the copy back.

Check: no overflow; the one rank's table equals ``count_file``'s on the
same file row for row; the two ranks' groups and totals add up to it;
the legs deliver what the staged call does.  ``small``: 1,024 reads in
batches of 64, 64 KiB chunks, 2^18 slots, and on the CPU one torch
thread a rank.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..parallel import dist as pdist
from ..parallel.launch import World, free_port
from ..parallel.mesh import make_mesh
from ..parallel.multihost import initialize_multihost, rank_device
from ..parallel.streaming import empty_sharded_acc, make_sharded_stream_step
from ..pipeline import count_file, file_batch_feed
from .common import PhaseRecord, card_of, table_digest, wall, workspace
from .count_phases import ingest_fastq

K, WIDTH = 21, 160
BATCH, CHUNK, ACC = 65536, 128 << 20, 8 * 1024 * 1024
SMALL = (64, 64 << 10, 1 << 18)  # batch, chunk, slots
SITE = "scripts/probe_r5g.py"


def host_feed(path: str, batch: int, chunk: int) -> list:
    """The file's (words, lengths) batches, drained to a list."""
    it, _, _, _ = file_batch_feed(path, "fastq", K, batch, WIDTH, chunk)
    return list(it)


def timed_steps(mesh, host: list, cap: int):
    """r5g's steps over ``host``'s batches (the first 16 timed as the
    script timed them, any after folded untimed); (accumulator, overflow,
    the times)."""
    device = mesh.device
    step = make_sharded_stream_step(mesh, K, True, cap, packed_width=WIDTH)
    state = [empty_sharded_acc(mesh, cap),
             torch.zeros((), dtype=torch.int64, device=device)]

    def run(batches):
        for words, lengths in batches:
            state[:] = step(*state, words, lengths)

    times = {}
    for name, part in (("first", host[:1]), ("second", host[1:2])):
        _, times[name] = wall(lambda: run(part), device)
    times["8 blocked"] = [wall(lambda: run([b]), device)[1]
                          for b in host[2:10]]
    _, times["6 pipelined"] = wall(lambda: run(host[10:16]), device)
    run(host[16:])
    acc, overflow = state
    return acc, int(overflow), times


@contextlib.contextmanager
def one_rank_group(device: torch.device):
    """A torch.distributed group of this process alone (NCCL on a card,
    gloo on the CPU), destroyed afterwards."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized here")
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                         backend="nccl" if device.type == "cuda" else "gloo",
                         device=device)
    try:
        yield
    finally:
        dist.destroy_process_group()


def staged_legs(send: torch.Tensor, mesh) -> dict:
    """The staged all_to_all of ``send``: the whole call as the steps ran
    it, then its three legs as ``comm._host_staged`` runs them (each host
    buffer pinned by torch's caching allocator, which the steps and the
    whole call have warmed); every rank calls it."""
    device, group = mesh.device, mesh.group("all")
    pin = send.is_cuda
    dist.barrier(group)
    whole, whole_s = wall(lambda: pdist.all_to_all_slabs(send, mesh), device)
    dist.barrier(group)
    h_in, d2h = wall(lambda: torch.empty(send.shape, dtype=send.dtype,
                                         pin_memory=pin).copy_(send), device)
    h_out = torch.empty(send.shape, dtype=send.dtype, pin_memory=pin)
    dist.barrier(group)
    _, coll = wall(lambda: dist.all_to_all_single(h_out, h_in, group=group),
                   device)
    out, h2d = wall(lambda: torch.empty_like(send).copy_(h_out), device)
    return {"d2h": d2h, "gloo all_to_all": coll, "h2d": h2d,
            "staged call": whole_s, "bytes": send.nbytes,
            "legs_equal_call": bool(torch.equal(out, whole))}


def rank_task(path: str, batch: int, chunk: int, cap: int,
              device: str) -> dict:
    """One rank of the (2,1) world: the feed, the timed steps, and the
    last step's staged all_to_all in legs."""
    dev = rank_device(device, dist.get_rank())
    host, feed_s = wall(lambda: host_feed(path, batch, chunk), dev)
    mesh = make_mesh((2, 1), device=dev)
    sends = []
    shipped = pdist.all_to_all_slabs

    def catch(send, mesh_):
        sends[:] = [send]
        return shipped(send, mesh_)

    pdist.all_to_all_slabs = catch
    try:
        acc, overflow, times = timed_steps(mesh, host, cap)
    finally:
        pdist.all_to_all_slabs = shipped
    legs = staged_legs(sends[0], mesh)
    return {"feed": feed_s, "times": times, "overflow": overflow,
            "groups": int((acc.counts > 0).sum()), "total": acc.total(),
            "legs": legs}


def run(device: torch.device, small: bool = False, workdir=None):
    """Yields the one-rank records, then the (2,1) world's."""
    card = card_of(device)
    batch, chunk, cap = SMALL if small else (BATCH, CHUNK, ACC)
    with workspace(workdir) as d:
        path = ingest_fastq(d, small)
        want = table_digest(count_file(path, "fastq", K, canonical=True,
                                       device=device))
        host, feed_s = wall(lambda: host_feed(path, batch, chunk), device)
        backend = "nccl" if device.type == "cuda" else "gloo"
        with one_rank_group(device):
            mesh = make_mesh((1, 1), device=device)
            acc, overflow, times = timed_steps(mesh, host, cap)
        n_batches = len(host)
        del host
        got = table_digest(acc)
        del acc
        yield PhaseRecord(
            f"(1,1) step, one {backend} rank", "distcount_step", SITE,
            str(device), overflow == 0 and got == want,
            {"feed": feed_s, **times},
            {"n_batches": n_batches, "overflow": overflow, "slots": cap},
            {"(1,1)": got, "count_file": want},
            card=card)
        with World(2, "gloo", str(device), timeout_s=600,
                   threads=1 if device.type == "cpu" else None) as world:
            ranks = world.run(rank_task, path, batch, chunk, cap,
                              str(device))
        groups = sum(r["groups"] for r in ranks)
        total = sum(r["total"] for r in ranks)
        for rank, out in enumerate(ranks):
            legs = out["legs"]
            yield PhaseRecord(
                f"(2,1) step, gloo rank {rank}", "distcount_step", SITE,
                str(device),
                out["overflow"] == 0 and legs["legs_equal_call"]
                and (groups, total) == (want["groups"], want["total"]),
                {"feed": out["feed"], **out["times"],
                 **{k: legs[k] for k in ("d2h", "gloo all_to_all", "h2d",
                                         "staged call")}},
                {"all_to_all_bytes": legs["bytes"],
                 "overflow": out["overflow"], "groups": out["groups"],
                 "groups_of_both": groups, "total_of_both": total},
                card=card)
