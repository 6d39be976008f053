"""The trim to host (``kmer_tpu_torch.ops.landing``): the select by slice
or mask, the landing in one host allocation (through the staging ring in
chunks), and the split into ``kmer_tpu``'s lanes, held bit for bit
against the formulas they replace, with the path counters.  No JAX."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from kmer_tpu_torch.ops import landing
from kmer_tpu_torch.ops.count import CountTable, count_windows
from kmer_tpu_torch.ops.wide import (
    WideCounts, count_packed_wide, fold_windows_into_wide)
from kmer_tpu_torch.packed import hi_lo_from_key


def _old_wide_trim(t: WideCounts) -> WideCounts:
    """WideCounts.trim before the landing: a mask, a stack of int64 rows."""
    live = t.counts > 0
    if bool(live.all()):
        return dataclasses.replace(t, n_unique=t.capacity)
    idx = torch.nonzero(live).squeeze(1)
    rows = torch.stack([t.keys[idx], t.length[idx].to(torch.int64),
                        t.counts[idx]])
    return WideCounts(keys=rows[0], length=rows[1].to(torch.int32),
                      counts=rows[2], n_unique=int(rows.shape[1]))


def _old_wide_lanes(t: WideCounts) -> tuple:
    """WideCounts.to_numpy before the split."""
    hi, lo = hi_lo_from_key(t.keys.numpy())
    c = t.counts.numpy().astype(np.int64)
    return (hi, lo, t.length.numpy().astype(np.int32),
            (c >> np.int64(32)).astype(np.int32),
            (c & np.int64(0xFFFFFFFF)).astype(np.uint32))


def _old_table_lanes(t: CountTable) -> tuple:
    """CountTable.trim().to_numpy() before the landing and the split."""
    live = t.counts > 0
    rows = torch.stack([t.keys[live], t.length[live].to(torch.int64),
                        t.counts[live].to(torch.int64)])
    hi, lo = hi_lo_from_key(rows[0].numpy())
    return (hi, lo, rows[1].numpy().astype(np.int32),
            rows[2].numpy().astype(np.int32))


def _same_lanes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert g.flags.c_contiguous
        assert g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def _rows(n, seed):
    """n random rows: keys over all 64 bits, counts past 2^32."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64,
                        endpoint=True)
    length = rng.integers(1, 33, n).astype(np.int32)
    counts = rng.integers(1, 1 << 44, n, dtype=np.int64)
    return torch.from_numpy(keys), torch.from_numpy(length), \
        torch.from_numpy(counts)


def _front(n=3000, capacity=4096, seed=1):
    return count_packed_wide(*_rows(n, seed), capacity)


def _gaps(capacity=4096, seed=2):
    """Live rows between dead ones, as from_numpy of arbitrary lanes."""
    keys, length, counts = _rows(capacity, seed)
    dead = torch.from_numpy(np.random.default_rng(seed).random(capacity)
                            < 0.4)
    dead[0] = True
    counts = torch.where(dead, 0, counts)
    return WideCounts(keys=keys, length=length, counts=counts,
                      n_unique=int((counts > 0).sum()))


def _overflow(seed=3):
    t = count_packed_wide(*_rows(5000, seed), 1024)
    assert t.n_unique > t.capacity
    return t


TABLES = {
    "front": (_front, "slice"),
    "gaps": (_gaps, "mask"),
    "empty": (lambda: WideCounts.empty(256), "slice"),
    "overflow": (_overflow, "host"),
    "trimmed": (lambda: _old_wide_trim(_front()), "host"),
    "front, stale n_unique": (
        lambda: dataclasses.replace(_front(), n_unique=100), "mask"),
}


@pytest.mark.parametrize("name", list(TABLES))
def test_wide_trim_and_lanes_equal_the_old_formulas(name):
    make, path = TABLES[name]
    table = make()
    landing.zero_trims()
    got = table.trim()
    assert landing.trims() == {**dict.fromkeys(
        ("slice", "mask", "host", "ring_bytes"), 0), path: 1}
    want = _old_wide_trim(table)
    assert got.n_unique == want.n_unique == got.capacity
    for g, w in zip((got.keys, got.length, got.counts),
                    (want.keys, want.length, want.counts)):
        assert g.dtype == w.dtype and g.device.type == "cpu"
        assert g.is_contiguous()
        assert torch.equal(g, w)
    if path != "host":  # one new allocation, apart from the table's
        ptrs = {c.untyped_storage().data_ptr()
                for c in (got.keys, got.length, got.counts)}
        assert len(ptrs) == 1
        assert table.keys.untyped_storage().data_ptr() not in ptrs
    _same_lanes(got.to_numpy(), _old_wide_lanes(want))


def test_wide_trim_of_a_fold_takes_the_slice():
    acc = WideCounts.empty(1 << 12)
    rng = np.random.default_rng(4)
    for _ in range(3):
        keys = torch.from_numpy(rng.integers(0, 3000, 5000) << 40)
        acc = fold_windows_into_wide(acc, keys, None, 10)
    landing.zero_trims()
    got = acc.trim()
    assert landing.trims()["slice"] == 1
    assert 0 < got.n_unique == acc.n_unique < acc.capacity
    _same_lanes(got.to_numpy(), _old_wide_lanes(_old_wide_trim(acc)))


def test_count_table_trim_and_lanes_equal_the_old_formulas():
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, 1 << 12, 20000) << 40)
    valid = torch.from_numpy(rng.random(20000) < 0.8)
    table = count_windows(keys, valid, 12)
    landing.zero_trims()
    got = table.trim()
    assert landing.trims()["mask"] == 1
    assert got.n_unique == got.capacity == int(table.n_unique)
    assert (got.keys.dtype, got.length.dtype, got.counts.dtype) == (
        torch.int64, torch.int32, torch.int32)
    lanes = got.to_numpy()
    _same_lanes(lanes, _old_table_lanes(table))
    again = got.trim()
    assert landing.trims()["host"] == 1 and again.keys is got.keys
    _same_lanes(again.to_numpy(), lanes)


@pytest.mark.parametrize("rows, threads", [(0, 4), (1, 4), (7, 4),
                                           (1000, 3), (1000, 1)])
def test_split_in_blocks_on_threads(monkeypatch, rows, threads):
    """Blocks of 7 rows on a few threads, the last block short."""
    monkeypatch.setattr(landing, "SPLIT_ROWS", 7)
    monkeypatch.setattr(landing, "SPLIT_THREADS", threads)
    t = _old_wide_trim(_front(n=rows, capacity=max(rows, 8), seed=rows))
    _same_lanes(t.to_numpy(), _old_wide_lanes(t))


def test_split_high_halves_follow_the_byte_order():
    a = np.array([0x0123456789ABCDEF, -2], np.int64)
    hi, lo = landing.halves(a, np.uint32)
    assert list(hi) == [0x01234567, 0xFFFFFFFF]
    assert list(lo) == [0x89ABCDEF, 0xFFFFFFFE]


@pytest.mark.parametrize("chunk, slots", [(8, 2), (64, 2), (24, 3),
                                          (1 << 20, 2)])
def test_copy_through_a_staging_buffer(chunk, slots):
    """The chunk loop over source tensors and a staging buffer: sources
    that end mid-chunk, an empty one, and more chunks than slots."""
    rng = np.random.default_rng(chunk)
    srcs = [torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8))
            for n in (1000, 0, 13, chunk * slots * 3 + 5)]
    dsts = [torch.empty_like(s) for s in srcs]
    staging = torch.zeros((slots, chunk), dtype=torch.uint8)
    landing.copy_through(list(zip(srcs, dsts)), staging)
    for s, d in zip(srcs, dsts):
        assert torch.equal(s, d)


def _small_ring(monkeypatch, chunk=64):
    monkeypatch.setattr(landing, "CHUNK_BYTES", chunk)
    monkeypatch.setattr(landing, "_ring", None)
    ring = landing.ring()
    assert ring.shape == (landing.SLOTS, chunk)
    assert landing.ring() is ring
    return ring


def test_landing_through_the_ring_spans_many_chunks(monkeypatch):
    """A table of 3000 rows (60,000 B) through a ring of 64-byte chunks:
    the columns land in one allocation, equal to the old trim's, and
    their bytes are counted."""
    _small_ring(monkeypatch)
    table = _front()
    want = _old_wide_trim(table)
    n = want.n_unique
    landing.zero_trims()
    got = landing.land_through_ring(
        (table.keys[:n], table.length[:n], table.counts[:n]))
    assert landing.trims()["ring_bytes"] == 20 * n > 100 * 64
    assert len({c.untyped_storage().data_ptr() for c in got}) == 1
    for g, w in zip(got, (want.keys, want.length, want.counts)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    host = WideCounts(*got, n_unique=n)
    _same_lanes(host.to_numpy(), _old_wide_lanes(want))


def test_a_later_landing_leaves_earlier_lanes_alone(monkeypatch):
    """The ring is reused; nothing handed to a caller is."""
    ring = _small_ring(monkeypatch)
    t = _old_wide_trim(_front(seed=6))
    first = WideCounts(*landing.land_through_ring(
        (t.keys, t.length, t.counts)), n_unique=t.n_unique)
    lanes = first.to_numpy()
    kept = [a.copy() for a in lanes]
    cols = [c.clone() for c in (first.keys, first.length, first.counts)]
    for seed in (7, 8):
        t = _old_wide_trim(_front(seed=seed))
        landing.land_through_ring((t.keys, t.length, t.counts))
        WideCounts(t.keys, t.length, t.counts, t.n_unique).to_numpy()
    assert landing.ring() is ring
    for a, b in zip(lanes, kept):
        assert np.array_equal(a, b)
    for a, b in zip((first.keys, first.length, first.counts), cols):
        assert torch.equal(a, b)


def test_landings_from_many_threads_do_not_mix(monkeypatch):
    """Sixteen threads land their own rows through one ring of 64-byte
    chunks at once; a chunk taken by another thread's landing would land
    in the wrong table."""
    _small_ring(monkeypatch)
    landing.zero_trims()
    tables = [_old_wide_trim(_front(n=500, capacity=512, seed=10 + i))
              for i in range(16)]
    got = [None] * len(tables)
    errors = []

    def work(i):
        try:
            t = tables[i]
            for _ in range(5):
                got[i] = landing.land_through_ring((t.keys, t.length,
                                                    t.counts))
                if not all(torch.equal(g, w) for g, w in zip(
                        got[i], (t.keys, t.length, t.counts))):
                    errors.append(i)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(tables))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors
    assert landing.trims()["ring_bytes"] == 5 * 20 * 500 * len(tables)
