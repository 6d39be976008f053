"""The port's sharded count (kmer_tpu_torch.parallel.dist, mesh, comm,
multihost) against kmer_tpu's on the 8-device virtual CPU mesh.

The port runs one process per rank in gloo worlds of CPU processes,
started once for the module (``torch_dist_tasks.Worlds``); ``kmer_tpu``
runs the same seeded numpy inputs over ``make_mesh(shape,
jax.devices()[:n])``.  Rank r's trimmed table equals device r's shard
exactly (the whole table for the gather merge), and so do the overflow
counts and the merge-efficiency dicts.  Meshes (1,1) and (2,1) are here;
(4,1), (2,2) and (1,4) are in tests/test_torch_dist_mesh4.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_dist_tasks as tasks
from kmer_tpu.ops.count import count_windows as jax_count_windows
from kmer_tpu.parallel.dist import _extract_with_halo as jax_halo
from kmer_tpu.parallel.dist import _shard_map
from kmer_tpu.parallel.dist import make_sharded_count_step as jax_step
from kmer_tpu.parallel.dist import merge_efficiency as jax_efficiency
from kmer_tpu.parallel.mesh import make_mesh as jax_mesh

N_READS, READ_LEN = 8, 128  # seq blocks of >= 32 bases: a k-1 halo fits
KS = (5, 21, 31, 32)


@pytest.fixture(scope="module")
def worlds():
    w = tasks.Worlds()
    yield w
    w.close()


def jax_rows(table, rank: int, n_parts: int, sharded: bool):
    """(hi, lo, length, counts) of device ``rank``'s live groups (the
    whole table when it is replicated)."""
    lanes = [np.asarray(x) for x in (table.hi, table.lo, table.length,
                                     table.counts)]
    if sharded:
        lanes = [x.reshape(n_parts, -1)[rank] for x in lanes]
    live = lanes[3] > 0
    return tuple(x[live] for x in lanes[:3]) + (
        lanes[3][live].astype(np.int64),)


def assert_rows_equal(got, want):
    for name, g, w in zip(("hi", "lo", "length", "counts"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def jax_local_efficiency(codes, lengths, shape, rank, k, canonical, merge,
                         slack=2.0):
    """kmer_tpu's merge_efficiency of device ``rank``'s local table: one
    slot per window starting in its block, the distinct valid keys
    (dist.py's rule) live, built with numpy."""
    from kmer_tpu.ops.count import CountTable as JaxTable

    dp, sp = shape
    b, l_loc = codes.shape[0] // dp, codes.shape[1] // sp
    d, s = divmod(rank, sp)
    rows = codes[d * b:(d + 1) * b].astype(np.uint64)
    ext = np.pad(rows, ((0, 0), (0, k)))
    start = s * l_loc
    key = np.zeros((b, l_loc), np.uint64)
    for j in range(k):
        key |= ext[:, start + j: start + j + l_loc] << np.uint64(62 - 2 * j)
    if canonical:
        from kmer_tpu.ops.extract import canonicalize

        hi, lo = canonicalize(jnp.asarray((key >> np.uint64(32)
                                           ).astype(np.uint32)),
                              jnp.asarray(key.astype(np.uint32)), k)
        key = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
               | np.asarray(lo).astype(np.uint64))
    pos = start + np.arange(l_loc)[None, :]
    valid = pos <= lengths[d * b:(d + 1) * b, None] - k
    live = np.unique(key[valid]).size
    counts = np.zeros(b * l_loc, np.int32)
    counts[:live] = 1
    zeros = np.zeros(b * l_loc, np.uint32)
    table = JaxTable(hi=zeros, lo=zeros, length=zeros.view(np.int32),
                     counts=counts, n_unique=live)
    return jax_efficiency(table, dp * sp, merge, slack)


def check_count_case(worlds, shape, merge, k, canonical, seed=0):
    n = shape[0] * shape[1]
    codes, lengths = tasks.make_batch(seed, N_READS, READ_LEN)
    got = worlds.run(shape, tasks.count_task, shape, k, canonical, merge,
                     seed, N_READS, READ_LEN)
    mesh = jax_mesh(shape, jax.devices()[:n])
    out = jax_step(mesh, k, canonical, merge)(codes, lengths)
    table, overflow = out if merge == "partition" else (out, 0)
    for r, g in enumerate(got):
        assert_rows_equal(g["rows"], jax_rows(table, r, n,
                                              merge == "partition"))
        assert g["n_unique"] == int(table.n_unique)
        assert g["overflow"] == int(overflow) == 0
        assert g["efficiency"] == jax_local_efficiency(
            codes, lengths, shape, r, k, canonical, merge)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("merge", ["gather", "partition"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 1)])
def test_sharded_count_matches_kmer_tpu(worlds, shape, merge, k, canonical):
    check_count_case(worlds, shape, merge, k, canonical)


@pytest.mark.parametrize("k", [4, 9, 31])
@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2), (1, 4)])
def test_halo_wire_gives_dist_valid_mask(worlds, shape, k):
    """One wire_keys call over a rank's words, the next seq rank's halo
    words and the length column clamp(len - s*l_loc, 0, l_loc + k - 1)
    gives kmer_tpu's halo windows and its valid mask (dist.py:85-86)
    in every slot, as does the codes path (``codes_keys``)."""
    n = shape[0] * shape[1]
    codes, lengths = tasks.make_batch(3, N_READS, READ_LEN)
    got = worlds.run(shape, tasks.halo_task, shape, k, True, 3, N_READS,
                     READ_LEN)
    mesh = jax_mesh(shape, jax.devices()[:n])
    spec = P("data", "seq")
    f = jax.jit(_shard_map(
        lambda c, ln: jax_halo(c, ln, k, shape[1], True), mesh,
        in_specs=(spec, P("data")), out_specs=(spec, spec, spec)))
    hi, lo, valid = (np.asarray(x) for x in f(jnp.asarray(codes),
                                              jnp.asarray(lengths)))
    want_keys = ((hi.astype(np.uint64) << np.uint64(32))
                 | lo.astype(np.uint64)).view(np.int64)
    b, l_loc = N_READS // shape[0], READ_LEN // shape[1]
    for r, (keys, ok, wkeys, wok) in enumerate(got):
        d, s = divmod(r, shape[1])
        at = (slice(d * b, (d + 1) * b), slice(s * l_loc, (s + 1) * l_loc))
        np.testing.assert_array_equal(ok, valid[at])
        np.testing.assert_array_equal(wok, valid[at])
        np.testing.assert_array_equal(keys, want_keys[at])
        np.testing.assert_array_equal(wkeys, want_keys[at])


def test_forced_overflow_retries_exactly(worlds):
    """A bucket cap of 8 (kmer_tpu's at slack 1e-9) must overflow by
    kmer_tpu's count, and count_kmers_sharded must then return the exact
    gathered table."""
    shape = (2, 1)
    got = worlds.run(shape, tasks.retry_task, shape, 8, 5, 8, 128, 8)
    codes, lengths = tasks.make_batch(5, 8, 128)
    mesh = jax_mesh(shape, jax.devices()[:2])
    _, overflow = jax_step(mesh, 8, merge="partition", slack=1e-9)(
        jnp.asarray(codes), jnp.asarray(lengths))
    want = jax_step(mesh, 8, merge="gather")(codes, lengths)
    for g in got:
        assert g["overflow"] == int(overflow) > 0
        assert_rows_equal(g["rows"], jax_rows(want, 0, 2, False))


def test_bad_merge_name():
    from kmer_tpu_torch.parallel.dist import count_kmers_sharded
    from kmer_tpu_torch.parallel.mesh import make_mesh

    codes, lengths = tasks.make_batch(9, 8, 16)
    with pytest.raises(ValueError, match="merge"):
        count_kmers_sharded(codes, lengths, 4, make_mesh((1, 1),
                                                         device="cpu"),
                            merge="reduce")


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_collectives(worlds, shape):
    got = worlds.run(shape, tasks.comm_task, shape)
    n = shape[0] * shape[1]
    for r, g in enumerate(got):
        d, s = divmod(r, shape[1])
        assert g["coords"] == (d, s)
        np.testing.assert_array_equal(
            g["gather"], np.concatenate([np.arange(3) + 10 * q
                                         for q in range(n)]))
        peers = [q * shape[1] + s for q in range(shape[0])]
        np.testing.assert_array_equal(
            g["gather_data"], np.concatenate([np.arange(3) + 10 * q
                                              for q in peers]))
        np.testing.assert_array_equal(
            g["a2a"], np.stack([np.arange(2 * r, 2 * r + 2) + 100 * q
                                for q in range(n)]))
        assert g["sum"] == n * (n + 1) // 2
        assert g["sum_data"] == sum(q + 1 for q in peers)
        nxt = d * shape[1] + (s + 1) % shape[1]
        np.testing.assert_array_equal(g["ring"], np.arange(3) + 10 * nxt)


def test_merge_efficiency_shapes():
    """kmer_tpu's TestMergeEfficiency case, dict for dict."""
    import torch

    from kmer_tpu_torch.ops.count import count_windows
    from kmer_tpu_torch.parallel.dist import merge_efficiency

    hi = np.array([1, 1, 2, 3], np.uint32)
    t = count_windows(torch.from_numpy((hi.astype(np.int64) << 32)), None,
                      4)
    jt = jax_count_windows(jnp.asarray(hi), jnp.zeros(4, jnp.uint32), None,
                           4)
    for merge in ("gather", "partition"):
        assert merge_efficiency(t, 8, merge) == jax_efficiency(jt, 8, merge)
    with pytest.raises(ValueError):
        merge_efficiency(t, 8, merge="bogus")


def test_mesh_shape_for_and_refusals():
    from kmer_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for

    assert mesh_shape_for(8) == (8, 1)
    assert mesh_shape_for(8, seq_parallel=4) == (2, 4)
    with pytest.raises(ValueError):
        mesh_shape_for(8, seq_parallel=3)
    with pytest.raises(ValueError, match="ranks"):
        make_mesh((2, 1), device="cpu")  # no process group: one rank


def test_pod_mesh_and_host_batch_of_one_process():
    from kmer_tpu_torch.parallel.multihost import (
        host_local_batch, make_pod_mesh)

    mesh = make_pod_mesh(device="cpu")
    assert mesh.shape == (1, 1) and mesh.coords == (0, 0)
    assert mesh.group("all") is None
    assert host_local_batch(4096) == 4096


class TestMultihost:
    """initialize_multihost's strict and best-effort failures, as
    kmer_tpu's TestMultihost: the group's init is monkeypatched to
    raise."""

    def _boom(self, monkeypatch):
        import torch.distributed as dist

        def fail(*a, **kw):
            raise ConnectionError("no coordinator")

        monkeypatch.setattr(dist, "init_process_group", fail)

    def test_strict_failure_raises(self, monkeypatch):
        from kmer_tpu_torch.parallel.multihost import initialize_multihost

        self._boom(monkeypatch)
        with pytest.raises(RuntimeError,
                           match="multi-host initialization failed for the "
                           "requested topology"):
            initialize_multihost("127.0.0.1:1", 2, 0, backend="gloo",
                                 device="cpu")

    def test_best_effort_degrades_with_warning(self, monkeypatch, caplog):
        import logging

        from kmer_tpu_torch.parallel.multihost import initialize_multihost
        from kmer_tpu_torch.utils.logging import get_logger

        self._boom(monkeypatch)
        monkeypatch.setattr(get_logger(), "propagate", True)
        with caplog.at_level(logging.WARNING, logger="kmer_tpu_torch"):
            assert initialize_multihost(strict=False, backend="gloo",
                                        device="cpu") is False
        assert any("single-process" in r.getMessage()
                   for r in caplog.records)

    def test_nccl_refusals_name_gloo(self):
        from kmer_tpu_torch.parallel.multihost import initialize_multihost

        with pytest.raises(ValueError, match="gloo"):
            initialize_multihost("127.0.0.1:1", 2, 0, backend="nccl",
                                 device="cpu")
        with pytest.raises(ValueError, match="gloo"):
            initialize_multihost("127.0.0.1:1", 4, 0, backend="nccl",
                                 device="cuda")
        with pytest.raises(ValueError, match="backend"):
            initialize_multihost("127.0.0.1:1", 2, 0, backend="mpi",
                                 device="cpu")

    def test_nccl_counts_the_ranks_of_this_host(self, monkeypatch):
        """Two hosts of one card each: the global rank count is not held
        against this host's cards.  LOCAL_WORLD_SIZE, where set, is."""
        import torch

        from kmer_tpu_torch.parallel.multihost import initialize_multihost

        self._boom(monkeypatch)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
        with pytest.raises(RuntimeError, match="no coordinator"):
            initialize_multihost("10.0.0.2:1", 2, 1, backend="nccl",
                                 device="cuda")
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="2 rank.s. on this host.*gloo"):
            initialize_multihost("10.0.0.2:1", 2, 1, backend="nccl",
                                 device="cuda")


def test_world_failure_kills_every_rank():
    """A rank that raises ends the world at once: no peer is left in a
    collective, and the next task starts a new world."""
    from kmer_tpu_torch.parallel.launch import World, WorldError

    with World(2, timeout_s=60, threads=1) as world:
        with pytest.raises(WorldError, match="rank"):
            world.run(tasks.comm_task, (3, 1))  # a 3-rank mesh of 2 ranks
        assert world.run(tasks.comm_task, (2, 1))[1]["sum"] == 3


def test_host_staging_keeps_in_place_inputs():
    """A collective staged through host buffers sees its inputs' values,
    also where it works in place (all_reduce), and its outputs come back
    into the given tensors."""
    import torch

    from kmer_tpu_torch.parallel import comm

    x = torch.arange(4, dtype=torch.int64)

    def double(outs, ins):
        outs[0].mul_(2)

    comm._host_staged("in place", double, [x], [x])
    assert x.tolist() == [0, 2, 4, 6]
    out = torch.zeros(4, dtype=torch.int64)

    def copy(outs, ins):
        outs[0].copy_(ins[0] + 1)

    comm._host_staged("out of place", copy, [out], [x])
    assert out.tolist() == [1, 3, 5, 7] and x.tolist() == [0, 2, 4, 6]
    assert {"in place", "out of place"} <= comm.STAGED
