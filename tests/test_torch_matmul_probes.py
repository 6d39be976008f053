"""The matrix-unit rates (``kmer_tpu_torch.probes.matmul``) on the CPU:
probe_pallas.py (d), the int8 one-hot permute, exact against numpy's
int32 ``einsum`` and JAX's ``dot_general`` into int32; probe_pallas2.py
(h), the bf16 batched product into float32, within a relative 1e-2 of
the float32 product and of JAX's ``dot_general`` on the same inputs."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu_torch.probes import matmul
from phase_probe_helpers import one_thread  # noqa: F401

CPU = torch.device("cpu")
DIMS = (((2,), (1,)), ((0,), (0,)))  # the scripts' batched contraction


@pytest.mark.parametrize("groups", [1, 16])
def test_int8_permute_equals_jax_dot_general(groups):
    p, v = matmul.int8_inputs(groups)
    run, out = matmul.int8_route(torch.from_numpy(p), torch.from_numpy(v))
    assert run() is out
    want = jax.lax.dot_general(jnp.asarray(p), jnp.asarray(v), DIMS,
                               preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        out.numpy(), np.einsum("gij,gjk->gik", p.astype(np.int32),
                               v.astype(np.int32)))


def test_int8_inputs_are_the_scripts_shapes():
    p, v = matmul.int8_inputs(256)
    assert p.shape == (256, 128, 128) and v.shape == (256, 128, 8)
    assert p.dtype == v.dtype == np.int8
    assert p.min() < 0 < p.max()


@pytest.mark.parametrize("groups", [1, 4])
def test_bf16_product_within_tolerance_of_jax_dot_general(groups):
    a, b = matmul.bf16_inputs(groups, CPU)
    got = matmul.bf16_product(a, b)
    assert got.dtype == torch.float32
    assert "plain version" in matmul.bf16_route(CPU)
    assert matmul.bf16_route(torch.device("cuda")) == (
        "torch.bmm(a, b, out_dtype=torch.float32)")
    want = jax.lax.dot_general(
        jnp.asarray(a.float().numpy(), jnp.bfloat16),
        jnp.asarray(b.float().numpy(), jnp.bfloat16), DIMS,
        preferred_element_type=jnp.float32)
    assert matmul.rel_err(got, torch.from_numpy(np.array(want))
                          ) <= matmul.REL_TOL
    assert matmul.rel_err(got, torch.bmm(a.float(), b.float())
                          ) <= matmul.REL_TOL


def test_records_at_the_small_size():
    d, h = matmul.run(CPU, small=True)
    assert d.correct and d.max_abs_err == 0 and d.kernel == "library"
    assert d.site == "scripts/probe_pallas.py:124-133"
    assert "torch.bmm" in d.detail["batched_int8"]
    assert h.correct and float(h.detail["rel_err"]) <= matmul.REL_TOL
    assert h.site == "scripts/probe_pallas2.py:188-197"
    for rec in (d, h):  # no card: no device time, no bound
        assert rec.graph_ms is None and rec.bound_ms is None


def test_bound_is_the_larger_of_bytes_and_operations(monkeypatch):
    monkeypatch.setattr(matmul, "hbm_bytes_per_s", lambda device: 1e12)
    monkeypatch.setattr(matmul, "dense_peak", lambda device, kind: 1e15)
    assert matmul.mma_bound_ms(10 ** 9, 10 ** 12, "int8", CPU) == (
        1.0, "bytes")
    assert matmul.mma_bound_ms(10 ** 6, 10 ** 13, "bf16", CPU) == (
        10.0, "operations")


def test_cli_runs_the_matmul_family_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "kmer_tpu_torch.probes", "--only", "matmul",
         "--device", "cpu", "--small"], capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("correct: True") == 2
