"""The port's sample-partition count engine (``probes/partition.py``)
against ``scripts/probe_r3c.py`` and ``kmer_tpu``'s ``count_windows``, at
r3c's SMALL sizes (N = 130 * 2^10 keys), on the CPU.

r3c runs its device work when imported, so what its engine computes is
written out here in ``jnp``: its lanes (``make_lanes``, :79-102), its
production scalars (``prod_scalars``, :105-113), its offsets and its
stage-2 windows (:128-155).  Every comparison is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu import native as jn
from kmer_tpu.ops import count as jc
from kmer_tpu.ops import extract as jx
from kmer_tpu_torch.packed import SIGN_FLIP, hi_lo_from_key, key_from_hi_lo
from kmer_tpu_torch.probes import partition as pt

CPU = torch.device("cpu")
K = pt.K


@functools.lru_cache(maxsize=None)
def _jax_lanes(coverage):
    """r3c's SMALL make_lanes: (hi uint32, lo uint32) of the first N
    canonical windows."""
    rng = np.random.default_rng(7 if coverage else 0)
    n_reads = 1 << 10
    if coverage:
        genome = rng.integers(0, 4, 5_000, dtype=np.uint8)
        starts = rng.integers(0, genome.size - pt.READ_LEN + 1, n_reads)
        reads = genome[starts[:, None] + np.arange(pt.READ_LEN)[None, :]]
        flip = rng.random(n_reads) < 0.5
        reads[flip] = 3 - reads[flip, ::-1]
    else:
        reads = rng.integers(0, 4, (n_reads, pt.READ_LEN), np.uint8)
    words = jnp.asarray(jn.pack2bit_rows(reads.reshape(1, -1))[0])
    h, l = jx.extract_from_words(words, K)
    h, l = jx.canonicalize(h, l, K)
    return (np.asarray(h.ravel()[: pt.SMALL_N]),
            np.asarray(l.ravel()[: pt.SMALL_N]))


@functools.lru_cache(maxsize=None)
def _jax_count(coverage):
    """kmer_tpu's trimmed table and r3c's prod_scalars on those lanes."""
    hi, lo = _jax_lanes(coverage)
    lo = lo >> np.uint32(16) << np.uint32(16)  # r3c counts (hi, lo16 << 16)
    t = jc.count_windows(jnp.asarray(hi), jnp.asarray(lo), None, K)
    cnt = jnp.asarray(t.counts, jnp.uint32)
    c1 = jnp.sum(jnp.asarray(t.hi, jnp.uint32) * cnt)
    c2 = jnp.sum(((jnp.asarray(t.lo, jnp.uint32) >> jnp.uint32(16))
                  + jnp.uint32(1)) * cnt)
    scalars = {"n_unique": int(t.n_unique), "total": int(jnp.sum(cnt)),
               "c1": int(c1), "c2": int(c2)}
    tt = t.trim()
    return (np.asarray(tt.hi), np.asarray(tt.lo),
            np.asarray(tt.counts)), scalars


@pytest.mark.parametrize("workload", ["uniform", "coverage"])
def test_lanes_equal_r3c_lanes(workload):
    hi, lo = _jax_lanes(workload == "coverage")
    got = pt.make_lanes(workload == "coverage", CPU, small=True)
    want = key_from_hi_lo(hi, lo) ^ np.int64(SIGN_FLIP)
    np.testing.assert_array_equal(got.numpy(), want)
    # canonical 21-mers fill 42 bits: r3c's lo16 lane loses nothing
    assert not (lo & np.uint32(0xFFFF)).any()


@pytest.mark.parametrize("workload", ["uniform", "coverage"])
@pytest.mark.parametrize("config", pt.SMALL_CONFIGS, ids=lambda c: c[0])
def test_engine_equals_count_windows(config, workload):
    name, R, C, P, stage1 = config
    keys = pt.make_lanes(workload == "coverage", CPU, small=True)
    got = pt.partition_count(keys, K, R, C, P, stage1=stage1)
    (w_hi, w_lo, w_counts), want = _jax_count(workload == "coverage")
    hi, lo, length, counts = got.table.trim().to_numpy()
    np.testing.assert_array_equal(hi, w_hi)
    np.testing.assert_array_equal(lo, w_lo)
    np.testing.assert_array_equal(counts, w_counts)
    assert (length == K).all()
    assert pt.scalar_dict(got.scalars) == want
    assert want["total"] == pt.SMALL_N
    assert 0 < got.max_seg <= got.seg <= C
    assert got.seg % pt.SEG_ALIGN == 0 or got.seg == C


def test_config_c_stage1_goes_through_row_sort(monkeypatch):
    calls = []

    def spy(x):
        calls.append(tuple(x.shape))
        return torch.sort(x, dim=1).values

    monkeypatch.setattr(pt, "row_sort", spy)
    _, R, C, P, stage1 = pt.SMALL_CONFIGS[2]
    assert stage1 == "row_sort" and C <= 16384
    pt.partition_count(pt.make_lanes(False, CPU, small=True), K, R, C, P,
                       stage1=stage1)
    assert calls == [(R, C)]
    for name, R, C, P, stage1 in pt.CONFIGS:  # full size: C's rows fit
        assert (stage1 == "row_sort") == name.startswith("C_")
    assert pt.CONFIGS[2][2] == 16384


@pytest.mark.parametrize("k, err", [(32, "all-t 32-mer"), (0, "k must"),
                                    (33, "k must")])
def test_k32_and_bad_k_raise(k, err):
    keys = torch.zeros(64, dtype=torch.int64)
    with pytest.raises(ValueError, match=err):
        pt.partition_count(keys, k, 4, 16, 2, stage1="torch.sort")


@pytest.mark.parametrize("bad", [
    dict(R=4, C=15, P=2), dict(R=4, C=16, P=1), dict(R=4, C=16, P=17),
    dict(R=4, C=16, P=2, stage1="lax.sort")])
def test_bad_shapes_raise(bad):
    kw = {"stage1": "torch.sort", **bad}
    with pytest.raises(ValueError):
        pt.partition_count(torch.zeros(64, dtype=torch.int64), K, **kw)


def _sorted_rows(R, C, seed):
    """Seeded flipped 48-bit keys with repeats, rows sorted."""
    rng = np.random.default_rng(seed)
    keys = (rng.integers(0, 1 << 12, R * C).astype(np.int64) << 36) \
        | (rng.integers(0, 4, R * C).astype(np.int64) << 16)
    keys ^= np.int64(SIGN_FLIP)
    return np.sort(keys.reshape(R, C), axis=1)


def test_splitter_offsets_equal_vmap_searchsorted():
    R, C, P = 33, 512, 16
    rows = _sorted_rows(R, C, 5)
    got = pt.splitter_offsets(torch.from_numpy(rows), P).numpy()
    with jax.enable_x64(True):
        sh = jnp.asarray(rows)
        splitters = sh[0, :: C // P][1:P]
        inner = jax.vmap(lambda r: jnp.searchsorted(r, splitters,
                                                    side="left"))(sh)
        off = jnp.concatenate([jnp.zeros((R, 1), inner.dtype), inner,
                               jnp.full((R, 1), C, inner.dtype)], axis=1)
        want = np.asarray(off)
    np.testing.assert_array_equal(got, want)


def test_stage2_slots_equal_r3c_windows():
    """probe_r3c.py:138-155 on the hi and lo16 lanes of the same sorted
    rows and offsets, with the window's clamp in play."""
    R, C, P = 24, 256, 8
    rows = _sorted_rows(R, C, 9)
    off = pt.splitter_offsets(torch.from_numpy(rows), P)
    seg_len = (off[:, 1:] - off[:, :-1]).numpy()
    seg = -(-int(seg_len.max()) // 16) * 16
    assert (off[:, 1:P].numpy() > C - seg).any()  # some windows clamp
    got = pt.redistribute(torch.from_numpy(rows), off, seg).numpy()
    g_hi, g_lo = hi_lo_from_key(got ^ np.int64(SIGN_FLIP))

    hi, lo = hi_lo_from_key(rows ^ np.int64(SIGN_FLIP))
    sh, sl = jnp.asarray(hi), jnp.asarray((lo >> 16).astype(np.uint16))
    off = jnp.asarray(off.numpy().astype(np.int32))
    seg_len = jnp.asarray(seg_len.astype(np.int32))
    p_idx = jnp.repeat(jnp.arange(P, dtype=jnp.int32), R)
    r_idx = jnp.tile(jnp.arange(R, dtype=jnp.int32), P)
    o = off[r_idx, p_idx]
    L = seg_len[r_idx, p_idx]
    start = jnp.minimum(o, C - seg)
    d = o - start
    flat_start = r_idx * C + start
    fh, fl = sh.reshape(R * C), sl.reshape(R * C)
    gh = jax.vmap(lambda s: jax.lax.dynamic_slice(fh, (s,), (seg,)))(
        flat_start)
    gl = jax.vmap(lambda s: jax.lax.dynamic_slice(fl, (s,), (seg,)))(
        flat_start)
    j = jnp.arange(seg, dtype=jnp.int32)[None, :]
    valid = (j >= d[:, None]) & (j < (d + L)[:, None])
    gh = jnp.where(valid, gh, jnp.uint32(0xFFFFFFFF))
    gl = jnp.where(valid, gl, jnp.uint16(0xFFFF))

    np.testing.assert_array_equal(g_hi, np.asarray(gh))
    np.testing.assert_array_equal((g_lo >> 16).astype(np.uint16),
                                  np.asarray(gl))
    # the rows' lo lanes stay below 2^18, so a pad is the only all-ones lo
    np.testing.assert_array_equal(g_lo == 0xFFFFFFFF, ~np.asarray(valid))


def test_partition_family_runs_on_the_cpu():
    recs = list(pt.run(CPU, small=True))
    assert [r.name for r in recs] == [
        f"{w}/{n}" for w in ("uniform", "coverage")
        for n in ["count_windows_prod"]
        + [f"partition_{c[0]}" for c in pt.SMALL_CONFIGS]]
    assert all(r.correct for r in recs)
    assert all(r.detail["max_seg"] <= r.detail["seg"] for r in recs
               if r.name.endswith(("P16", "P128")))
