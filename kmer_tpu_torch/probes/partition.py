"""The sample-partition count engine of ``scripts/probe_r3c.py``
(``make_partition_count``, :116-180), on the port's kernels.

An exact k-mer count without one global sort: the N keys are cut into R
rows of C keys, and

1. stage 1 sorts each row (``row_sort`` or ``torch.sort(dim=1)``);
2. the P - 1 splitters are quantiles of sorted row 0;
3. ``torch.searchsorted`` finds each row's P segment offsets;
4. stage 2 copies the R * P segments into ``[P * R, seg]`` slots in
   (p, r) order with ``segment_copy`` (an int64 key is a pair of words);
   each window starts at ``min(offset, C - seg)`` as in r3c, and the
   slot's keys outside the segment become pads;
5. stage 3 sorts each of the P partition rows (``torch.sort(dim=1)``:
   1.1M to 8.5M keys a row is past ``row_sort``'s width);
6. the live prefixes of the partition rows (their lengths are read to
   the host with the longest segment's), laid end to end by one
   ``torch.cat``, are the sorted run of ``count_windows``, and
   ``segment_counts`` counts it; r3c's four scalars (n_unique, total and
   two checksums) come with the table, as r3c's engine returned them.

Partitions are disjoint key ranges in order, so the concatenated live
prefixes are one ascending run, which the segment-count kernel needs (it
finds a tile's open segment by galloping backward).

Keys are the port's flipped keys (``key ^ SIGN_FLIP``, signed order).
Pads are the count path's sentinel in flipped form (``SENTINEL_KEY ^
SIGN_FLIP``, the largest int64), which sorts last in every row.  No real
key equals it for k <= 31 (its padding bits are ones); an all-``t``
32-mer does, so k = 32 raises ``ValueError``.  ``seg``, the slot width, is
the longest segment, read to the host once and rounded up: r3c fixed it
at 9,216 and a longer segment would have lost keys.

``run`` is the ``partition`` probe family: engines A, B and C on r3c's two
workloads at its sizes, each held against ``ops/count.count_windows`` on
the same keys (the trimmed table and r3c's four scalars).
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..kernels.row_sort import row_sort
from ..kernels.segment_copy import CopyPlan, segment_copy
from ..kernels.segment_counts import segment_counts
from ..kernels.wire_keys import stream_keys
from ..native import pack2bit_rows
from ..ops.count import SENTINEL_KEY, CountTable, count_windows
from ..ops.extract import simulate_coverage_reads, simulate_reads
from ..packed import SIGN_FLIP
from .common import Record, max_abs_err

PAD = SENTINEL_KEY ^ SIGN_FLIP  # the largest int64
SEG_ALIGN = 64  # keys: seg is the longest segment rounded up to this
MASK32 = 0xFFFFFFFF
STAGE1 = ("torch.sort", "row_sort")
SITE = "scripts/probe_r3c.py:116-180"

READ_LEN, K = 150, 21
N = 130 << 20  # 136,314,880 keys
SMALL_N = 130 << 10  # r3c's SMALL (KMER_PROBE_SMALL) size
GENOME = 5_000_000  # the coverage workload's genome (r3c; 5,000 small)

# (name, R, C, P, stage 1): r3c's A and B, and the port's C, whose rows
# of 16,384 keys (2,048 small) go through row_sort
CONFIGS = (("A_R130_P128", 130, 1 << 20, 128, "torch.sort"),
           ("B_R1040_P16", 1040, 1 << 17, 16, "torch.sort"),
           ("C_R8320_P16", 8320, 1 << 14, 16, "row_sort"))
SMALL_CONFIGS = (("A_R130_P128", 130, 1 << 10, 128, "torch.sort"),
                 ("B_R1040_P16", 1040, 1 << 7, 16, "torch.sort"),
                 ("C_R65_P16", 65, 1 << 11, 16, "row_sort"))


@functools.lru_cache(maxsize=2)
def make_lanes(coverage: bool, device: torch.device,
               small: bool = False) -> torch.Tensor:
    """r3c's ``make_lanes`` (:79-102) as flipped int64 keys [N]: the first
    N canonical 21-mer windows of 2^20 reads of 150 bp (2^10 small) packed
    back to back, phase-major as ``extract_from_words`` lays them out
    (one ``stream_keys`` launch on the card);
    ``uniform`` reads from seed 0, ``coverage`` reads of a 5 Mbp genome
    (5 kbp small) from seed 7, half reverse-complemented.  Windows that
    cross a read boundary or run past the stream's end count too, as in
    r3c."""
    n_reads = 1 << 10 if small else 1 << 20
    if coverage:
        reads = simulate_coverage_reads(
            n_reads, READ_LEN, GENOME // 1000 if small else GENOME, seed=7)
    else:
        reads = simulate_reads(n_reads, READ_LEN, seed=0)
    words = torch.from_numpy(
        pack2bit_rows(reads.reshape(1, -1))[0].view(np.int32)).to(device)
    keys, _ = stream_keys(words, K, True, READ_LEN, n_reads)
    return keys.reshape(-1)[: SMALL_N if small else N] ^ SIGN_FLIP


def stage1_sort(rows: torch.Tensor, stage1: str) -> torch.Tensor:
    """Each row of ``rows`` [R, C] sorted, by ``row_sort`` or
    ``torch.sort(dim=1)``."""
    if stage1 == "row_sort":
        return row_sort(rows)
    if stage1 == "torch.sort":
        return torch.sort(rows, dim=1).values
    raise ValueError(f"stage 1 is one of {STAGE1}, not {stage1!r}")


def splitter_offsets(sorted_rows: torch.Tensor, P: int) -> torch.Tensor:
    """int64 [R, P + 1]: where each row's P segments start, the splitters
    being every (C // P)-th key of sorted row 0 after the first, and
    the row's end."""
    R, C = sorted_rows.shape
    splitters = sorted_rows[0, :: C // P][1:P].contiguous()
    inner = torch.searchsorted(
        sorted_rows, splitters.expand(R, P - 1).contiguous(), side="left")
    off = torch.empty((R, P + 1), dtype=torch.int64,
                      device=sorted_rows.device)
    off[:, 0] = 0
    off[:, 1:P] = inner
    off[:, P] = C
    return off


def redistribute(sorted_rows: torch.Tensor, off: torch.Tensor,
                 seg: int) -> torch.Tensor:
    """int64 [P * R, seg]: slot p * R + r holds row r's segment p, from
    a window of ``seg`` keys that starts at ``min(off[r, p], C - seg)``
    (r3c's clamp), and pads outside the segment.  Needs seg >= every
    segment's length and seg <= C."""
    R, C = sorted_rows.shape
    P = off.shape[1] - 1
    dev = sorted_rows.device
    length = (off[:, 1:] - off[:, :-1]).t().reshape(-1)  # [P * R], (p, r)
    o = off[:, :-1].t().reshape(-1)
    r = torch.arange(R, device=dev).repeat(P)
    start = torch.clamp(o, max=C - seg)
    d = o - start  # where the segment starts in its window
    # every window lies inside its row and the slots tile the destination,
    # so the plan needs no host check (copy_plan's) and has no overlap
    plan = CopyPlan(in_off=2 * (r * C + start),
                    out_off=2 * seg * torch.arange(P * R, device=dev),
                    seg=2 * seg, n_in=2 * R * C, n_out=2 * P * R * seg,
                    serial=False, overlap=False)
    out = torch.empty(plan.n_out, dtype=torch.int32, device=dev)
    slots = segment_copy(sorted_rows.view(torch.int32).reshape(-1), plan,
                         out).view(torch.int64).view(P * R, seg)
    j = torch.arange(seg, device=dev)[None, :]
    outside = (j < d[:, None]) | (j >= (d + length)[:, None])
    return slots.masked_fill_(outside, PAD)


SCALARS = ("n_unique", "total", "c1", "c2")


def r3c_scalars(table: CountTable) -> torch.Tensor:
    """r3c's four scalars of a table, as int64 [4] on its device (no
    read to the host): n_unique, total, c1 = sum(hi * count) and c2 =
    sum(((lo >> 16) + 1) * count), the last two mod 2^32 as the uint32
    sums of ``probe_r3c.prod_scalars`` wrap."""
    cnt = table.counts.to(torch.int64)
    hi = (table.keys >> 32) & MASK32
    lo16 = (table.keys >> 16) & 0xFFFF
    c1 = ((hi * cnt) & MASK32).sum() & MASK32
    c2 = (((lo16 + 1) * cnt) & MASK32).sum() & MASK32
    return torch.stack([torch.as_tensor(table.n_unique, device=cnt.device)
                        .to(torch.int64), cnt.sum(), c1, c2])


def scalar_dict(scalars: torch.Tensor) -> dict[str, int]:
    """``r3c_scalars``' tensor as {name: int}."""
    return dict(zip(SCALARS, scalars.tolist()))


@dataclasses.dataclass
class PartitionCount:
    """``partition_count``'s result: the sorted-run table of the N keys
    (``count_windows``' layout, no sentinel slots), the longest segment
    ``max_seg`` and the slot width ``seg`` (>= max_seg), the ms of each
    stage where ``partition_count`` was asked to time them, and r3c's
    four scalars of the table."""

    table: CountTable
    max_seg: int
    seg: int
    stage_ms: dict[str, float] | None = None

    @property
    def scalars(self) -> torch.Tensor:
        """``r3c_scalars`` of the table, computed when asked for, outside
        the engine's timed call: eager PyTorch takes them in some ten
        passes over the table, which r3c's jit fused into its count."""
        return r3c_scalars(self.table)


class _Clock:
    """Stage marks: CUDA events on a card, the host clock (after a
    synchronize) elsewhere; nothing when off."""

    def __init__(self, device: torch.device, on: bool):
        self.on, self.cuda = on, device.type == "cuda"
        self.marks: list[tuple[str, object]] = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if not self.on:
            return
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> dict[str, float] | None:
        if not self.on:
            return None
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = (a.elapsed_time(b) if self.cuda
                         else 1e3 * (b - a))
        return out


def partition_count(keys: torch.Tensor, k: int, R: int, C: int, P: int, *,
                    stage1: str, time_stages: bool = False
                    ) -> PartitionCount:
    """The exact count of ``keys`` (flipped int64 keys of one k, R * C of
    them) by sample partition, with r3c's four scalars of it; see the
    module docstring.  The table's keys are unflipped, ascending in
    unsigned order, every slot live."""
    if k == 32:
        raise ValueError("partition_count pads with the sentinel key, which "
                         "an all-t 32-mer equals; k = 32 would miscount")
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    if keys.dtype != torch.int64 or keys.numel() != R * C:
        raise ValueError(f"partition_count needs R * C = {R * C} int64 keys, "
                         f"got {keys.numel()} of {keys.dtype}")
    if not 2 <= P <= C:
        raise ValueError(f"P must be in [2, C], got P = {P}, C = {C}")
    if stage1 not in STAGE1:
        raise ValueError(f"stage 1 is one of {STAGE1}, not {stage1!r}")
    clock = _Clock(keys.device, time_stages)
    rows = stage1_sort(keys.reshape(R, C), stage1)
    clock.mark("stage1")
    off = splitter_offsets(rows, P)
    length = off[:, 1:] - off[:, :-1]  # [R, P]
    # the one read to the host: the longest segment, and each partition's
    # live keys
    max_seg, *live = torch.cat([length.max().reshape(1),
                                length.sum(0)]).tolist()
    seg = min(C, -(-max_seg // SEG_ALIGN) * SEG_ALIGN)
    clock.mark("offsets")
    slots = redistribute(rows, off, seg)
    del rows
    clock.mark("stage2")
    parts = torch.sort(slots.view(P, R * seg), dim=1).values
    del slots
    clock.mark("stage3")
    run = torch.cat([parts[p, :n] for p, n in enumerate(live)])
    del parts
    clock.mark("gather")
    counts, n_unique = segment_counts(run)
    clock.mark("counts")
    table = CountTable(keys=run.bitwise_xor_(SIGN_FLIP),
                       length=torch.full_like(counts, k), counts=counts,
                       n_unique=n_unique)
    return PartitionCount(table, max_seg, seg, clock.ms())


# --- the probe family ------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _wall_ms(fn, device: torch.device, iters: int) -> tuple[float, object]:
    """Best host ms of ``iters`` synchronized calls after one warm-up, and
    the last result."""
    out = fn()
    best = float("inf")
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        best = min(best, 1e3 * (time.perf_counter() - t0))
    return best, out


def _trimmed(table: CountTable) -> tuple[torch.Tensor, torch.Tensor]:
    live = table.counts > 0
    return table.keys[live], table.counts[live]


def run(device: torch.device, small: bool = False, workdir=None):
    """Yields, for each workload, the production count's record and one
    record an engine: its wall (best of 3 synchronized calls; r3c's
    scalars are computed after the timed calls, on both sides), its
    stages' ms, ``max_seg`` and ``seg``, and whether its trimmed table and
    four scalars equal ``count_windows``'."""
    iters = 1 if small else 3
    for workload in ("uniform", "coverage"):
        keys = make_lanes(workload == "coverage", device, small)
        plain = keys ^ SIGN_FLIP
        prod_ms, ref = _wall_ms(lambda: count_windows(plain, None, K),
                                device, iters)
        want = scalar_dict(r3c_scalars(ref))
        want_keys, want_counts = _trimmed(ref)
        yield Record(f"{workload}/count_windows_prod", "partition",
                     "torch.sort + segment_counts", "scripts/probe_r3c.py:105",
                     str(device), correct=want["total"] == keys.numel(),
                     max_abs_err=0, ms=prod_ms, plain_ms=None,
                     detail={**want, "keys": keys.numel()})
        del ref
        for name, R, C, P, stage1 in SMALL_CONFIGS if small else CONFIGS:
            ms, got = _wall_ms(
                lambda: partition_count(keys, K, R, C, P, stage1=stage1),
                device, iters)
            stage_ms = partition_count(keys, K, R, C, P, stage1=stage1,
                                       time_stages=True).stage_ms
            scalars = scalar_dict(got.scalars)
            got_keys, got_counts = _trimmed(got.table)
            same = (got_keys.shape == want_keys.shape
                    and got_counts.shape == want_counts.shape)
            err = (max(max_abs_err(got_keys.view(torch.int32),
                                   want_keys.view(torch.int32)),
                       max_abs_err(got_counts, want_counts))
                   if same else -1)
            yield Record(
                f"{workload}/partition_{name}", "partition",
                f"{stage1} (stage 1), segment_copy, segment_counts", SITE,
                str(device),
                correct=same and err == 0 and scalars == want
                and got.max_seg <= got.seg,
                max_abs_err=err, ms=ms, plain_ms=prod_ms,
                detail={"R": R, "C": C, "P": P, "stage1": stage1,
                        "max_seg": got.max_seg, "seg": got.seg, **scalars,
                        "stage_ms": stage_ms})
            del got
