"""The port's sharded index and sharded filter (kmer_tpu_torch.parallel.
shindex, query), the shq bench and the multi-device dryrun, against
kmer_tpu's on the virtual CPU mesh and the host index oracle.  Every
rank's answers must equal kmer_tpu's; the case list follows
tests/test_shindex.py."""

import jax
import numpy as np
import pytest

import torch_dist_tasks as tasks
from kmer_tpu.index import KmerIndex
from kmer_tpu.io import generate_test_rows
from kmer_tpu.packed import PackedKmers
from kmer_tpu.parallel.mesh import make_mesh as jax_mesh
from kmer_tpu.parallel.query import filter_sharded as jax_filter
from kmer_tpu.parallel.shindex import ShardedIndex as JaxShardedIndex


@pytest.fixture(scope="module")
def worlds():
    w = tasks.Worlds()
    yield w
    w.close()


@pytest.fixture(scope="module")
def column():
    rows = generate_test_rows(1024, seed=21)
    kmers = [r[1].lower() for r in rows] + ["acga", "acga", "", "t" * 32]
    rng = np.random.default_rng(0)
    eq = [kmers[i] for i in rng.integers(0, len(kmers), 16)] + [
        "acga", "", "t" * 32, "c" * 31]
    prefixes = [kmers[i][: int(rng.integers(1, max(len(kmers[i]), 2)))]
                for i in rng.integers(0, len(kmers), 12) if kmers[i]]
    prefixes += ["", "a", "t" * 32, "ttt"]
    patterns = ["nnnn", "acgn", "", "ngc"]
    return kmers, eq, prefixes, patterns


@pytest.mark.parametrize("shape,cap", [((2, 1), 32), ((2, 2), 4)])
def test_sharded_index_matches_kmer_tpu(worlds, column, shape, cap):
    kmers, eq, prefixes, patterns = column
    col = PackedKmers.from_strings(kmers)
    jidx = JaxShardedIndex.build(
        col, jax_mesh(shape, jax.devices()[: shape[0] * shape[1]]))
    host = KmerIndex.build(col)
    want = {"eq": [r.tolist() for r in jidx.search_eq(eq, cap=cap)],
            "prefix": [r.tolist() for r in jidx.search_prefix(prefixes,
                                                              cap=cap)],
            "pattern": [r.tolist() for r in jidx.search_pattern(patterns,
                                                                cap=cap)]}
    assert want["eq"] == [host.search_eq(q).tolist() for q in eq]
    assert want["prefix"] == [host.search_prefix(q).tolist()
                              for q in prefixes]
    # cap 4 forces the regrowth ladder in both packages
    for got in worlds.run(shape, tasks.index_task, shape, kmers, eq,
                          prefixes, patterns, cap):
        assert got == want


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_filter_sharded_matches_kmer_tpu(worlds, column, shape):
    kmers = column[0][:301]  # 301 rows: padding in every mesh
    queries = [("eq", "acga"), ("prefix", "ac"), ("prefix", ""),
               ("pattern", "angc"), ("pattern", "n" * 5), ("eq", "")]
    col = PackedKmers.from_strings(kmers)
    mesh = jax_mesh(shape, jax.devices()[: shape[0] * shape[1]])
    want = [jax_filter(col, op, q, mesh).tolist() for op, q in queries]
    assert any(want)
    for got in worlds.run(shape, tasks.filter_task, shape, kmers, queries):
        assert got == want


def test_shq_bench_over_two_ranks(worlds):
    results = worlds.run((2, 1), tasks.shq_task, 1 << 12, 256)
    for r in results:
        assert r["metric"] == "sharded_index_eq_lookups_per_s"
        assert r["detail"]["n_devices"] == 2
        assert r["detail"]["hits"] >= 256
    assert results[0]["detail"]["hits"] == results[1]["detail"]["hits"]


def test_dryrun_multichip_on_cpu_ranks():
    from kmer_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(2, "cpu", timeout_s=120)
