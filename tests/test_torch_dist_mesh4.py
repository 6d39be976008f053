"""The port's sharded count against kmer_tpu's on four-rank meshes:
(4,1), (2,2) and (1,4), so the halo crosses one, two and three seq
boundaries.  The cases of tests/test_torch_dist.py, and
KmerCounter.count_sharded."""

import jax
import pytest

import torch_dist_tasks as tasks
from kmer_tpu.config import EngineConfig as JaxConfig
from kmer_tpu.models.pipeline import KmerCounter as JaxCounter
from kmer_tpu.parallel.mesh import make_mesh as jax_mesh
from test_torch_dist import (
    KS, N_READS, READ_LEN, assert_rows_equal, check_count_case, jax_rows)


@pytest.fixture(scope="module")
def worlds():
    w = tasks.Worlds()
    yield w
    w.close()


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("merge", ["gather", "partition"])
@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_sharded_count_matches_kmer_tpu(worlds, shape, merge, k, canonical):
    check_count_case(worlds, shape, merge, k, canonical, seed=1)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_kmer_counter_count_sharded(worlds, shape):
    got = worlds.run(shape, tasks.counter_task, shape, 21, 2, N_READS,
                     READ_LEN)
    codes, lengths = tasks.make_batch(2, N_READS, READ_LEN)
    model = JaxCounter(JaxConfig(k=21, canonical=True))
    want = model.count_sharded(codes, lengths,
                               jax_mesh(shape, jax.devices()[:4]))
    for g in got:
        assert_rows_equal(g, jax_rows(want, 0, 4, False))
