"""The stream phase probes (``kmer_tpu_torch.probes``: fold_step,
stream_loop, distcount_step) at their small sizes on the CPU, each result
table held against ``kmer_tpu`` (JAX on the CPU) on the same seeded
inputs: ``fold_windows_into_wide`` and, for the merge cadence,
``count_packed_wide``; ``make_sharded_stream_step`` on a (1,1) mesh for
the stream steps, the stream loop and the distcount step.  Tables compare
exactly, through ``rows_digest`` of their live rows in key order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu.ops.count import count_windows as jax_count_windows
from kmer_tpu.ops.extract import canonicalize, extract_windows_batch
from kmer_tpu.ops.wide import WideCounts as JaxWide
from kmer_tpu.ops.wide import count_packed_wide as jax_count_packed_wide
from kmer_tpu.ops.wide import fold_windows_into_wide as jax_fold
from kmer_tpu.parallel.mesh import make_mesh as jax_mesh
from kmer_tpu.parallel.streaming import empty_sharded_acc as jax_empty
from kmer_tpu.parallel.streaming import make_sharded_stream_step as jax_step
from kmer_tpu_torch.probes import count_phases, distcount_step, fold_step
from kmer_tpu_torch.probes import stream_loop
from kmer_tpu_torch.probes.common import rows_digest
from phase_probe_helpers import jax_digest, one_thread  # noqa: F401

CPU = torch.device("cpu")
K = 21
BATCH, GENOME, CAP = fold_step.SMALL


@jax.jit
def jax_keys(codes):
    lengths = jnp.full((codes.shape[0],), 150, jnp.int32)
    wins, valid = extract_windows_batch(codes, lengths, K)
    hi, lo = canonicalize(wins.hi, wins.lo, K)
    return hi, lo, valid


def jax_stream(batches, cap, packed_width=None):
    """kmer_tpu's stream step on a (1,1) mesh over ``batches`` of
    (codes or words, lengths); its accumulator."""
    mesh = jax_mesh((1, 1), jax.devices()[:1])
    step = jax_step(mesh, K, True, cap, packed_width=packed_width)
    acc, ovf = jax_empty(mesh, cap), jnp.zeros((), jnp.int32)
    for codes, lengths in batches:
        acc, ovf = step(acc, ovf, jnp.asarray(codes), jnp.asarray(lengths))
    assert int(ovf) == 0
    return acc


def _full(n):
    return np.full(n, 150, np.int32)


# --- the fold step and the merge cadence -------------------------------------


@pytest.fixture(scope="module")
def fold_run():
    recs = list(fold_step.run(CPU, small=True))
    assert all(r.correct for r in recs), [r.name for r in recs
                                          if not r.correct]
    return {k: t for r in recs for k, t in (r.tables or {}).items()}


@pytest.fixture(scope="module")
def sources():
    return fold_step.sources(BATCH, fold_step.R, GENOME)


def test_fold_equals_kmer_tpu_fold(fold_run, sources):
    hi, lo, valid = jax_keys(jnp.asarray(sources[0]))
    fold = jax.jit(lambda a, h, l_, v: jax_fold(a, h, l_, v, K))
    once = fold(JaxWide.empty(CAP), hi, lo, valid)
    assert fold_run["fold empty"] == jax_digest(once)
    assert fold_run["fold warm"] == jax_digest(fold(once, hi, lo, valid))


@pytest.fixture(scope="module")
def jax_step_digest(sources):
    return jax_digest(jax_stream([(sources[0], _full(BATCH))] * 4, CAP))


@pytest.mark.parametrize("fed", ["codes", "wire"])
def test_stream_step_equals_kmer_tpu_step(fold_run, jax_step_digest, fed):
    assert fold_run[f"{fed}, 4 steps"] == jax_step_digest


@pytest.fixture(scope="module")
def jax_cadence_digest(sources):
    """One general weighted GROUP BY of the 12 batch tables in
    kmer_tpu."""
    count = jax.jit(lambda c: jax_count_windows(*jax_keys(c), K))
    tables = [count(jnp.asarray(sources[i % len(sources)]))
              for i in range(fold_step.STEPS)]
    cat = [jnp.concatenate([jnp.asarray(getattr(t, name)) for t in tables])
           for name in ("hi", "lo", "length", "counts")]
    counts = cat[3].astype(jnp.int32)
    group = jax.jit(jax_count_packed_wide, static_argnames="capacity")
    return jax_digest(group(cat[0], cat[1], cat[2], jnp.zeros_like(counts),
                            counts.astype(jnp.uint32), capacity=CAP))


@pytest.mark.parametrize("which", ["shipped", "cadence"])
def test_merge_cadence_equals_kmer_tpu_count_packed_wide(
        fold_run, jax_cadence_digest, which):
    """Both compositions equal kmer_tpu's one GROUP BY of the batches."""
    assert fold_run[which] == jax_cadence_digest


# --- the stream loop ---------------------------------------------------------


@pytest.fixture(scope="module")
def loop_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("loop")
    recs = list(stream_loop.run(CPU, small=True, workdir=str(work)))
    assert all(r.correct for r in recs), [r.name for r in recs
                                          if not r.correct]
    return {r.name: r for r in recs}


@pytest.fixture(scope="module")
def jax_loop_digest():
    srcs = fold_step.sources(BATCH, 8, GENOME)
    steps = stream_loop.SMALL_R4C_STEPS
    return jax_digest(jax_stream(
        [(srcs[i % 8], _full(BATCH)) for i in range(steps)], CAP))


@pytest.mark.parametrize("name", ["r4c A free-run",
                                  "r4c D with checkpoint writes"])
def test_stream_loop_equals_kmer_tpu_stream(loop_run, jax_loop_digest,
                                            name):
    assert loop_run[name].tables["table"] == jax_loop_digest


@pytest.mark.parametrize("batch, steps", stream_loop.SMALL_R4D)
def test_stream_loop_batch_sizes_equal_kmer_tpu_stream(loop_run, batch,
                                                       steps):
    srcs = fold_step.sources(batch, 4, GENOME)
    want = jax_stream([(srcs[i % 4], _full(batch)) for i in range(steps)],
                      CAP)
    rec = loop_run[f"r4d B={batch} with checkpoint writes"]
    assert rec.tables["table"] == jax_digest(want)
    assert rec.detail["steps"] == steps


def test_stream_loop_checkpoints_were_written(loop_run):
    assert loop_run["r4c A free-run"].detail["writes"] == 0
    assert loop_run["r4c D with checkpoint writes"].detail["writes"] >= 1


# --- the distcount step ------------------------------------------------------


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("dist"))
    recs = list(distcount_step.run(CPU, small=True, workdir=work))
    assert all(r.correct for r in recs), [r.name for r in recs
                                          if not r.correct]
    return work, recs


@pytest.fixture(scope="module")
def jax_dist_digest(dist_run):
    work, _ = dist_run
    batch, chunk, cap = distcount_step.SMALL
    host = distcount_step.host_feed(count_phases.ingest_fastq(work, True),
                                    batch, chunk)
    assert len(host) == 16
    return jax_digest(jax_stream(host, cap,
                                 packed_width=distcount_step.WIDTH))


def test_distcount_one_rank_equals_kmer_tpu_step(dist_run, jax_dist_digest):
    _, recs = dist_run
    one = recs[0]
    assert one.name == "(1,1) step, one gloo rank"
    assert one.tables["(1,1)"] == jax_dist_digest
    assert len(one.seconds["8 blocked"]) == 8


@pytest.mark.parametrize("rank", [0, 1])
def test_distcount_two_ranks_add_up_to_kmer_tpu(dist_run, jax_dist_digest,
                                                rank):
    _, recs = dist_run
    rec = recs[1 + rank]
    assert rec.name == f"(2,1) step, gloo rank {rank}"
    assert rec.detail["groups_of_both"] == jax_dist_digest["groups"]
    assert rec.detail["total_of_both"] == jax_dist_digest["total"]
    assert rec.detail["overflow"] == 0
    for leg in ("d2h", "gloo all_to_all", "h2d", "staged call"):
        assert rec.seconds[leg] >= 0
