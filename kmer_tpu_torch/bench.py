"""Throughput benchmark of the port: canonical k-mer counting on one card.

The counterpart of ``kmer_tpu/bench.py``'s counting modes, with the same
JSON: metric names, units, ``vs_baseline`` against the same reference
(Postgres HashAggregate counting at ~1.3e6 k-mers/s on one CPU core,
BASELINE.md) and the same ``detail`` keys; ``detail.device`` is the
card's name.

* ``run_bench`` (fused; coverage with ``coverage_genome``): packed reads
  -> keys (unpack, extract and canonicalize in one kernel,
  ``kernels/wire_keys``) -> ``count_windows`` (one ``torch.sort`` of the
  sign-flipped int64 key + the segment-count kernel).  The headline
  times it with the words already on the device; the host-wire pass
  starts from the numpy words inside the timed region.  Detail carries
  the extract / sort / segment_counts phases.
* ``run_bench_stream``: phase-major windows straight from the packed
  words of reads laid back to back (keys and valid mask in one kernel,
  ``kernels/wire_keys.stream_keys``), invalid slots folded into the
  sentinel.
* ``run_chr_bench``: one ~252 Mbp sequence, k = 31, phase-major through
  the same kernel.
* ``run_query_bench``: index lookups over random 21-mers: the hash
  index's equality lookups (the headline), binary-search equality and
  fenced 8-base prefix ranges on the sorted column, and the builds.
* ``run_pattern_bench``: qkmer containment (``@>``) through
  ``DeviceIndex.pattern_hits`` at three selectivities.
* ``run_sharded_query_bench`` (shq): ``ShardedIndex`` build and batched
  equality lookups over the ranks of the process group.

Every pass is timed warm and ends in a read of ``n_unique`` to the host,
which waits for the device.  Each function takes an explicit ``device``:
on ``cuda`` the kernels launch; on ``cpu`` it runs the plain
versions, and then no number in the result is a device number.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .device import resolve_device
from .index import (
    DeviceHashIndex,
    DeviceIndex,
    device_sort_column,
    searchsorted_packed,
)
from .kernels.segment_counts import segment_counts
from .kernels.wire_keys import stream_keys, wire_keys
from .native import pack2bit_rows
from .ops.count import count_windows
from .ops.extract import simulate_coverage_reads, simulate_reads
from .packed import SIGN_FLIP, KmerColumn, PackedKmers, key_from_hi_lo
from .utils.profiling import Profile, phase_timer, synchronize

REFERENCE_KMERS_PER_S = 1.3e6

# Published HBM peaks (NVIDIA's H100 data sheet), matched against
# torch.cuda.get_device_name in order: the SXM part reports "H100 80GB
# HBM3".
_HBM_BY_NAME = [
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100 80GB HBM3", 3.35e12),
]


def device_name(device: torch.device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def hbm_bytes_per_s(device: torch.device | str = "cuda") -> float | None:
    """Published device-memory peak of the card, or None on the CPU.  A
    card with no entry raises: a %-of-peak against another card's figure
    would be wrong."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for frag, bw in _HBM_BY_NAME:
        if frag in name:
            return bw
    raise ValueError(f"no published HBM peak for {name!r}; add it to "
                     "kmer_tpu_torch/bench.py:_HBM_BY_NAME")


def _sol(nbytes: float, dt: float, sol_bytes_per_s: float | None) -> dict:
    return {
        "gb_per_s": round(nbytes / dt / 1e9, 3),
        "pct_sol": (None if sol_bytes_per_s is None
                    else round(100 * nbytes / dt / sol_bytes_per_s, 3)),
    }


def _upload(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 words to the device as int32 bits (widened where used)."""
    return torch.from_numpy(words.view(np.int32)).to(device)


def run_bench(
    n_reads: int = 1 << 20,
    read_len: int = 150,
    k: int = 21,
    canonical: bool = True,
    seed: int = 0,
    coverage_genome: int | None = None,
    device: torch.device | str = "cuda",
) -> dict:
    """Headline: wire -> keys (one kernel) -> count, words on the device.
    Reads are full length, so every window is valid: no mask, no
    sentinel, exactly ``n_reads * (read_len - k + 1)`` keys are sorted.

    ``coverage_genome``: sample the reads from one random genome of that
    many bases (k-mers repeat ~n_reads*read_len/genome times) instead of
    uniform-random reads.
    """
    device = torch.device(device)
    total = n_reads * (read_len - k + 1)
    if coverage_genome:
        reads = simulate_coverage_reads(n_reads, read_len, coverage_genome,
                                        seed=seed)
    else:
        reads = simulate_reads(n_reads, read_len, seed=seed)
    words_host = pack2bit_rows(reads)

    def extract_all(wire):  # full-length reads: no length column, no mask
        return wire_keys(wire, read_len, k, canonical,
                         lengths=False)[0].reshape(-1)

    def count_all(wire):
        return count_windows(extract_all(wire), None, k)

    # host-wire pass: the numpy words cross to the device inside the clock
    int(count_all(_upload(words_host, device)).n_unique)  # warm
    t0 = time.perf_counter()
    n_unique = int(count_all(_upload(words_host, device)).n_unique)
    dt_wire = time.perf_counter() - t0

    # headline: the words already on the device
    wire = _upload(words_host, device)
    synchronize(device)
    t0 = time.perf_counter()
    n_unique2 = int(count_all(wire).n_unique)
    dt_dev = time.perf_counter() - t0
    if n_unique2 != n_unique:
        raise RuntimeError(f"device-resident pass counted {n_unique2} "
                           f"distinct, host-wire pass {n_unique}")

    out = _result(total, dt_dev, n_reads, read_len, k, canonical, 1,
                  n_unique, "coverage" if coverage_genome else "fused",
                  device)
    detail = out["detail"]
    if coverage_genome:
        detail["genome_bases"] = coverage_genome
        detail["mean_kmer_multiplicity"] = round(total / n_unique, 2)
    detail["host_wire_kmers_per_s"] = round(total / dt_wire, 1)
    detail["host_wire_wall_s"] = round(dt_wire, 6)

    # Phases on the same data, each warm and synchronised.  kmer_tpu
    # publishes them only for 16 < k <= 24, the one k tier its (hi,
    # lo16) lane model fits; the port has one int64 key at every k, so
    # the same model holds at every k.  Byte models are the least
    # device-memory traffic, read + write, at 8 bytes per key:
    #   extract: the words in, the keys out;
    #   sort: the keys in and out (the xor pass, the int64 indices torch
    #     writes beside them and the sort's own passes are extra);
    #   segment_counts: the sorted keys in, int32 counts out.
    keys = extract_all(wire)
    flipped = torch.sort(keys ^ SIGN_FLIP).values
    sol_bw = hbm_bytes_per_s(device)
    prof = Profile()
    for name, fn, nbytes in [
        ("extract", lambda: extract_all(wire), wire.numel() * 4 + total * 8),
        # the sort count_windows runs (ops/count.py)
        ("sort", lambda: torch.sort(keys ^ SIGN_FLIP), 2 * total * 8),
        ("segment_counts", lambda: segment_counts(flipped, None),
         total * 8 + total * 4),
    ]:
        fn()
        synchronize(device)
        with phase_timer(prof, name, nbytes=nbytes, sync=device):
            fn()
    detail["phases"] = {
        name: {"ms": round(dt * 1e3, 4), **_sol(prof.bytes[name], dt, sol_bw)}
        for name, dt in prof.phases.items()
    }
    detail["phases_sum_ms"] = round(sum(prof.phases.values()) * 1e3, 4)
    detail["hbm_sol_bytes_per_s"] = sol_bw
    return out


def run_bench_stream(
    n_reads: int = 1 << 20,
    read_len: int = 150,
    k: int = 21,
    canonical: bool = True,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> dict:
    """Phase-major variant: windows straight from the packed words of the
    reads laid back to back (no unpack: 4 bytes in per 16 bases).  Slots
    whose window crosses a read's end, or the stream's, fold into the
    sentinel, so ``16 * n_words`` slots are sorted."""
    device = torch.device(device)
    total = n_reads * (read_len - k + 1)
    n_bases = n_reads * read_len
    if n_bases % 16:
        raise ValueError(f"the base count {n_bases} must be a multiple of "
                         "16 (whole words)")
    words_host = pack2bit_rows(
        simulate_reads(n_reads, read_len, seed=seed).reshape(1, -1))[0]

    def count_all(wire):
        keys, valid = stream_keys(wire, k, canonical, read_len, n_reads)
        return count_windows(keys.reshape(-1), valid.reshape(-1), k)

    wire = _upload(words_host, device)
    int(count_all(wire).n_unique)  # warm
    t0 = time.perf_counter()
    n_unique = int(count_all(wire).n_unique)
    dt = time.perf_counter() - t0
    return _result(total, dt, n_reads, read_len, k, canonical, 1, n_unique,
                   "stream", device)


def chr_codes(n_bases: int, seed: int) -> np.ndarray:
    """The uniform-random sequence of ``run_chr_bench`` (uint8 codes)."""
    return np.random.default_rng(seed).integers(0, 4, n_bases, dtype=np.uint8)


def run_chr_bench(
    n_bases: int = 15 << 24,  # ~251.7 Mbp, human chr1 scale, word-aligned
    k: int = 31,
    canonical: bool = True,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> dict:
    """Chromosome-scale counting of one sequence (BASELINE configs[4]):
    phase-major extraction from the packed words + the count, with the
    words already on the device."""
    device = torch.device(device)
    n_bases = (n_bases // 16) * 16
    total_windows = n_bases - k + 1
    wire = _upload(pack2bit_rows(chr_codes(n_bases, seed)[None, :])[0],
                   device)

    def count_all(w):
        # one "read" of n_bases: valid iff p <= n_bases - k
        keys, valid = stream_keys(w, k, canonical, n_bases, 1)
        return count_windows(keys.reshape(-1), valid.reshape(-1), k)

    int(count_all(wire).n_unique)  # warm
    t0 = time.perf_counter()
    n_unique = int(count_all(wire).n_unique)
    dt = time.perf_counter() - t0

    kmers_per_s = total_windows / dt
    return {
        "metric": "chr_scale_kmers_counted_per_s_chip",
        "value": round(kmers_per_s, 1),
        "unit": "kmers/s",
        "vs_baseline": round(kmers_per_s / REFERENCE_KMERS_PER_S, 2),
        "detail": {
            "mode": "chr",
            "n_bases": n_bases,
            "k": k,
            "canonical": canonical,
            "chunks": 1,
            "wall_s": round(dt, 6),
            "total_kmers": total_windows,
            "unique_kmers": n_unique,
            "device": device_name(device),
        },
    }


def run_sharded_query_bench(n_keys: int = 1 << 20, n_queries: int = 1 << 14,
                            seed: int = 0, mesh=None, *,
                            device: torch.device | str = "cuda") -> dict:
    """Multi-rank index serving: ``ShardedIndex`` build and batched
    equality lookups (cap 4) over the mesh's ranks (the process group's,
    or one rank), every rank with the same seeded keys and queries.  Each
    query's exact hit count must equal a one-device ``DeviceIndex`` range
    over the whole column, and every query key exists."""
    from .parallel.mesh import make_mesh
    from .parallel.shindex import ShardedIndex

    device = resolve_device(device)
    if mesh is None:
        mesh = make_mesh(device=device)
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**32, n_keys, dtype=np.uint64).astype(np.uint32)
    lo = np.zeros(n_keys, np.uint32)
    ln = np.full(n_keys, 16, np.int32)
    col = PackedKmers(hi=hi, lo=lo, length=ln)

    synchronize(mesh.device)
    t0 = time.perf_counter()
    sidx = ShardedIndex.build(col, mesh)
    synchronize(mesh.device)
    build_s = time.perf_counter() - t0

    qsel = rng.integers(0, n_keys, n_queries)
    qkey = torch.from_numpy(key_from_hi_lo(hi[qsel], lo[qsel])).to(
        mesh.device)
    qln = torch.full((n_queries,), 16, dtype=torch.int32, device=mesh.device)
    sidx.lookup("eq", qkey, qln, 4)  # warm
    synchronize(mesh.device)
    t0 = time.perf_counter()
    _, _, count = sidx.lookup("eq", qkey, qln, 4)
    hits = int(count.sum())
    dt = time.perf_counter() - t0
    _check(hits >= n_queries, "every query key exists")
    one = DeviceIndex.build(KmerColumn.from_packed(col, mesh.device))
    left, right = one.eq_ranges(qkey, qln)
    _check(torch.equal(count, right - left),
           "sharded counts == one-device DeviceIndex ranges")
    return {
        "metric": "sharded_index_eq_lookups_per_s",
        "value": round(n_queries / dt, 1),
        "unit": "lookups/s",
        "vs_baseline": round((n_queries / dt) / 4.7e3, 1),
        "detail": {
            "n_devices": mesh.n_parts,
            "n_keys": n_keys,
            "n_queries": n_queries,
            "hits": hits,
            "build_s": round(build_s, 3),
            "lookup_s": round(dt, 4),
            "device": device_name(mesh.device),
        },
    }


def _result(total, dt, n_reads, read_len, k, canonical, n_chunks, n_unique,
            mode, device):
    kmers_per_s = total / dt
    return {
        "metric": "canonical_kmers_counted_per_s_chip",
        "value": round(kmers_per_s, 1),
        "unit": "kmers/s",
        "vs_baseline": round(kmers_per_s / REFERENCE_KMERS_PER_S, 2),
        "detail": {
            "mode": mode,
            "n_reads": n_reads,
            "read_len": read_len,
            "k": k,
            "canonical": canonical,
            "chunks": n_chunks,
            "wall_s": round(dt, 6),
            "total_kmers": total,
            "unique_kmers": n_unique,
            "device": device_name(device),
        },
    }


def _random_21mers(rng, n_keys: int) -> PackedKmers:
    """``kmer_tpu``'s bench keys: random hi, the top 10 bits of lo."""
    hi = rng.integers(0, 2**32, n_keys, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n_keys, dtype=np.uint64).astype(
        np.uint32) & np.uint32(0xFFC00000)
    return PackedKmers(hi=hi, lo=lo, length=np.full(n_keys, 21, np.int32))


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"bench check failed: {what}")


def run_query_bench(n_keys: int = 1 << 22, n_queries: int = 1 << 20,
                    seed: int = 0, device: torch.device | str = "cuda"
                    ) -> dict:
    """Index lookup throughput over random 21-mers, against the
    reference's SP-GiST scans (eq 0.214 ms => ~4.7e3/s; ^@ 0.968 ms =>
    ~1.03e3/s, kmer-tests.sql:1321-1353):

    * headline: equality through ``DeviceHashIndex`` (1-2 bucket-row
      gathers a query);
    * detail: equality and fenced 8-base prefix ranges by binary search
      on the sorted column, and both builds.

    Every query key exists, so every lookup must find it; each hash
    lookup's rows must equal its binary-search range's.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    host = _random_21mers(rng, n_keys)
    col = KmerColumn.from_packed(host, device)

    device_sort_column(col)  # warm
    synchronize(device)
    t0 = time.perf_counter()
    sorted_col, rid = device_sort_column(col)
    synchronize(device)
    build_s = time.perf_counter() - t0

    qsel = rng.integers(0, n_keys, n_queries)
    qkey = torch.from_numpy(key_from_hi_lo(host.hi[qsel], host.lo[qsel])
                            ).to(device)
    qln = torch.full((n_queries,), 21, dtype=torch.int32, device=device)

    def lookup():
        return tuple(searchsorted_packed(sorted_col.key, sorted_col.length,
                                         qkey, qln, side)
                     for side in ("left", "right"))

    lookup()
    synchronize(device)
    t0 = time.perf_counter()
    left, right = lookup()
    hits = int(((right - left) > 0).sum())
    dt = time.perf_counter() - t0
    _check(hits == n_queries, f"binary search found {hits} of {n_queries}")

    # prefix ranges (^@, strategy 28): the top 8 bases of each query key
    dev_idx = DeviceIndex(key=sorted_col.key, length=sorted_col.length,
                          row_ids=torch.arange(n_keys, device=device))
    pkey = qkey & -(1 << 48)
    pln = torch.full((n_queries,), 8, dtype=torch.int32, device=device)
    fence = dev_idx.build_fence(bits=18)
    dev_idx.prefix_ranges(pkey, pln, fence=fence)
    synchronize(device)
    t0 = time.perf_counter()
    pl_, pr_ = dev_idx.prefix_ranges(pkey, pln, fence=fence)
    phits = int(((pr_ - pl_) > 0).sum())
    dt_p = time.perf_counter() - t0
    _check(phits == n_queries, f"prefix ranges found {phits} of {n_queries}")

    # the headline: bucketized open addressing, built on the host
    t0 = time.perf_counter()
    hidx = DeviceHashIndex.build(host, device=device)
    synchronize(device)
    hbuild_s = time.perf_counter() - t0
    hidx.lookup_eq(qkey, qln)
    synchronize(device)
    t0 = time.perf_counter()
    start, cnt, found = hidx.lookup_eq(qkey, qln)
    hhits = int(found.sum())
    dt_h = time.perf_counter() - t0
    _check(hhits == n_queries, f"hash lookups found {hhits} of {n_queries}")

    # the same rows by hash and by binary search, query by query
    cap = int(cnt.max())
    by_hash = hidx.gather_rows(start, cnt, cap)[0]
    by_range = DeviceIndex(key=sorted_col.key, length=sorted_col.length,
                           row_ids=rid).gather_rows(left, right, cap)[0]
    _check(torch.equal(torch.sort(by_hash, 1).values,
                       torch.sort(by_range, 1).values),
           "hash rows equal the binary-search rows")

    return {
        "metric": "index_eq_lookups_per_s_chip",
        "value": round(n_queries / dt_h, 1),
        "unit": "lookups/s",
        "vs_baseline": round((n_queries / dt_h) / 4.7e3, 1),
        "detail": {
            "n_keys": n_keys,
            "n_queries": n_queries,
            "hash_max_chain": hidx.max_chain,
            "hash_build_s": round(hbuild_s, 6),
            "hash_lookup_s": round(dt_h, 6),
            "binsearch_eq_lookups_per_s": round(n_queries / dt, 1),
            "sort_build_s": round(build_s, 6),
            "binsearch_lookup_s": round(dt, 6),
            "prefix_lookups_per_s": round(n_queries / dt_p, 1),
            "prefix_lookup_s": round(dt_p, 6),
            "prefix_vs_baseline": round((n_queries / dt_p) / 1.03e3, 1),
            "device": device_name(device),
        },
    }


def run_pattern_bench(n_keys: int = 1 << 22, n_queries: int = 1 << 16,
                      seed: int = 0, device: torch.device | str = "cuda"
                      ) -> dict:
    """Pattern (``@>``, qkmer containment) lookup throughput on a
    DeviceIndex over random 21-mers, against the reference's contains
    scan (23.5 ms over 100k rows, kmer-tests.sql:936-944), in three
    regimes:

    * a determinate 12-base prefix + 9 'n's (<= ~1 candidate a query);
    * a determinate 6-base prefix + a 2-base IUPAC tail (~1k candidates);
    * all 'n' (no pruning: the whole column is each query's candidate
      range), 8 queries.

    Each query is made from a stored key, so each must hit; no query may
    be truncated.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    host = _random_21mers(rng, n_keys)
    sorted_col, perm = device_sort_column(KmerColumn.from_packed(host, device))
    dev_idx = DeviceIndex(key=sorted_col.key, length=sorted_col.length,
                          row_ids=perm)

    def masks_from_keys(sel, det_len, iupac_tail):
        """[M, MAX_K] masks: the first det_len positions one-hot from the
        stored key, the rest 'n' or the true base plus one random base."""
        m = sel.size
        codes = np.zeros((m, 21), np.uint8)
        for i in range(21):
            lane = host.hi if i < 16 else host.lo
            codes[:, i] = (lane[sel] >> np.uint32(30 - 2 * (i % 16))) & 3
        masks = np.zeros((m, 32), np.uint32)
        onehot = np.uint32(1) << codes.astype(np.uint32)
        det = np.arange(21)[None, :] < det_len
        if iupac_tail:
            extra = np.uint32(1) << rng.integers(0, 4, (m, 21)).astype(
                np.uint32)
            tail = onehot | extra
        else:
            tail = np.full((m, 21), 15, np.uint32)  # 'n'
        masks[:, :21] = np.where(det, onehot, tail)
        return masks

    def time_batch(det_len, iupac_tail, nq, cap):
        sel = rng.integers(0, n_keys, nq)
        masks = torch.from_numpy(
            masks_from_keys(sel, det_len, iupac_tail).astype(np.int64)
        ).to(device)
        dev_idx.pattern_hits(masks, qlen=21, cap=cap)  # warm
        synchronize(device)
        t0 = time.perf_counter()
        _, ok, trunc = dev_idx.pattern_hits(masks, qlen=21, cap=cap)
        hits = int(ok.sum())
        truncated = int(trunc.sum())
        dt = time.perf_counter() - t0
        _check(hits >= nq, f"det_len {det_len}: {hits} hits for {nq} "
               "queries (each query's source key matches)")
        _check(truncated == 0, f"det_len {det_len}: {truncated} truncated")
        return dt, hits

    dt12, hits12 = time_batch(12, False, n_queries, cap=16)
    n6 = max(1, n_queries >> 4)
    dt6, hits6 = time_batch(6, True, n6, cap=4096)
    dtw, hitsw = time_batch(0, False, 8, cap=n_keys)

    ref_rate = 1.0 / 0.0235  # reference contains scan: 23.5 ms/query
    return {
        "metric": "index_pattern_lookups_per_s_chip",
        "value": round(n_queries / dt12, 1),
        "unit": "lookups/s",
        "vs_baseline": round((n_queries / dt12) / ref_rate, 1),
        "detail": {
            "n_keys": n_keys,
            "prefix12_queries": n_queries,
            "prefix12_s": round(dt12, 6),
            "prefix12_hits": hits12,
            "prefix6_iupac_lookups_per_s": round(n6 / dt6, 1),
            "prefix6_s": round(dt6, 6),
            "prefix6_hits": hits6,
            "worst_all_n_ms_per_query": round(dtw / 8 * 1e3, 4),
            "worst_all_n_hits": hitsw,
            "reference_contains_scan_ms": 23.5,
            "device": device_name(device),
        },
    }
