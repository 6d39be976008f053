"""The two matrix-unit rates of the Pallas probes, on the card's tensor
cores: ``scripts/probe_pallas.py`` (d) and ``scripts/probe_pallas2.py``
(h).  Both are a ``dot_general`` outside any Pallas kernel, so a library
product is their port.

* (d) the int8 one-hot permute: P [256, 128, 128] x V [256, 128, 8]
  int8, accumulated in int32, exact against numpy's int32 ``einsum``.
  Torch has no batched int8 product into int32 (``torch.bmm`` keeps int8,
  and on a card refuses it; the record says which).  Its int8 tensor-core
  product, ``torch._int_mm``, takes 2-D operands, so the port loops over
  the 256 groups: one ``_int_mm`` of [128, 128] x [128, 8] a group, both
  operands row-major (the layout the H100 takes: PERF.md §6, PR 13).  The
  plain version broadcasts the int32 products and sums them.
* (h) the bf16 reference rate: ``torch.bmm(out_dtype=torch.float32)`` of
  [64, 128, 128] x [64, 128, 128] bf16, in TFLOP/s, within a relative
  1e-2 (the largest difference over the largest value) of the float32
  product of the same inputs.  The CPU has no ``bmm`` with ``out_dtype``,
  so there, as the port's kernels do, the plain version runs: the float32
  product of the bf16 values.

A card that refuses either call raises: no other product stands in.

``jax.random`` inputs become seeded numpy draws.  On a card each rate
carries its own time in a CUDA graph and the bound at the card's
published dense peak for its type (``DENSE_PEAK``) or its HBM rate,
whichever is larger.  ``small`` takes 16 groups for (d), 4 for (h).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bench import hbm_bytes_per_s
from .common import Record, graph_ms, time_ms

L = 128
SITES = {"d": "scripts/probe_pallas.py:124-133",
         "h": "scripts/probe_pallas2.py:188-197"}
# published dense tensor-core peaks (NVIDIA's data sheet, no sparsity), by
# a fragment of torch.cuda.get_device_name
DENSE_PEAK = [("H100 80GB HBM3", {"int8": 1979e12, "bf16": 989e12})]
REL_TOL = 1e-2


def dense_peak(device: torch.device, kind: str) -> float:
    """The card's published dense peak for ``kind`` (ops/s); a card with
    no entry raises."""
    name = torch.cuda.get_device_name(device)
    for frag, peaks in DENSE_PEAK:
        if frag in name:
            return peaks[kind]
    raise ValueError(f"no published dense peak for {name!r}; add it to "
                     "kmer_tpu_torch/probes/matmul.py:DENSE_PEAK")


def mma_bound_ms(nbytes: int, ops: int, kind: str, device: torch.device
                 ) -> tuple[float, str]:
    """The least ms: ``nbytes`` at the HBM rate or ``ops`` at the dense
    peak for ``kind``, the larger, and which one it is."""
    by_bytes = 1e3 * nbytes / hbm_bytes_per_s(device)
    by_ops = 1e3 * ops / dense_peak(device, kind)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _own(rec: Record, run, device, nbytes: int, ops: int, kind: str
         ) -> Record:
    if device.type == "cuda":
        rec.bound_ms, rec.bound_by = mma_bound_ms(nbytes, ops, kind, device)
        rec.graph_ms = graph_ms(run, device)
        rec.library_ms = rec.graph_ms
    return rec


def _bmm_int8(p: torch.Tensor, v: torch.Tensor) -> str:
    """What ``torch.bmm`` does with int8 operands here."""
    try:
        out = torch.bmm(p[:1], v[:1])
    except (RuntimeError, NotImplementedError) as e:
        return f"torch.bmm refuses int8 here ({str(e).splitlines()[0]})"
    return (f"torch.bmm returns {out.dtype} (no int32 accumulation, so "
            "not this product)")


def int8_inputs(groups: int) -> tuple[np.ndarray, np.ndarray]:
    """(d)'s P [groups, 128, 128] and V [groups, 128, 8], int8 from
    seeded 32-bit draws."""
    rng = np.random.default_rng(2)
    p = rng.integers(0, 1 << 32, (groups, L, L), dtype=np.uint64)
    v = rng.integers(0, 1 << 32, (groups, L, 8), dtype=np.uint64)
    return (p.astype(np.uint32).astype(np.int8),
            v.astype(np.uint32).astype(np.int8))


def int8_route(pt: torch.Tensor, vt: torch.Tensor):
    """(d)'s route on the device: (a call that writes P @ V, int32, into
    one buffer by one row-major ``torch._int_mm`` a group, its output)."""
    out = torch.empty((pt.shape[0], L, 8), dtype=torch.int32,
                      device=pt.device)

    def run():
        for g in range(pt.shape[0]):
            torch._int_mm(pt[g], vt[g], out=out[g])
        return out

    return run, out


def bf16_inputs(groups: int, device: torch.device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(h)'s A and B [groups, 128, 128] bf16, from seeded normal draws."""
    rng = np.random.default_rng(3)
    return tuple(torch.from_numpy(rng.standard_normal(
        (groups, L, L), np.float32)).to(device).to(torch.bfloat16)
        for _ in range(2))


def bf16_route(device: torch.device) -> str:
    """The call that computes (h) on ``device``."""
    return ("torch.bmm(a.float(), b.float()) (the plain version: the CPU "
            "has no bmm with out_dtype)" if device.type == "cpu"
            else "torch.bmm(a, b, out_dtype=torch.float32)")


def bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(h): A @ B of bf16 operands, accumulated into float32 (on a CPU
    tensor, the float32 product of the same values)."""
    if a.device.type == "cpu":
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=torch.float32)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference over the largest value of ``want``."""
    return (got - want).abs().max().item() / want.abs().max().item()


def int8_permute(device: torch.device, groups: int) -> Record:
    """(d)."""
    p, v = int8_inputs(groups)
    want = np.einsum("gij,gjk->gik", p.astype(np.int32), v.astype(np.int32))
    pt, vt = torch.from_numpy(p).to(device), torch.from_numpy(v).to(device)
    run, out = int8_route(pt, vt)

    def plain():
        return (pt.to(torch.int32)[..., None]
                * vt.to(torch.int32)[:, None]).sum(2)

    err = int(np.abs(run().cpu().numpy().astype(np.int64) - want).max())
    err_plain = int(np.abs(plain().cpu().numpy().astype(np.int64)
                           - want).max())
    macs = groups * L * L * 8
    rec = Record(
        "mxu_bmm_i8 [G,128,128]x[G,128,8]", "matmul", "library",
        SITES["d"], str(device), correct=err == 0 and err_plain == 0,
        max_abs_err=err, ms=time_ms(run, device, 3),
        plain_ms=time_ms(plain, device, 3), ops=macs, ops_label="MAC",
        library=f"torch._int_mm, {groups} calls of [128,128] x [128,8] "
        "(row-major)",
        detail={"groups": groups, "elements_permuted": groups * L,
                "batched_int8": _bmm_int8(pt, vt)})
    return _own(rec, run, device, p.nbytes + v.nbytes + out.nbytes,
                2 * macs, "int8")


def bf16_rate(device: torch.device, groups: int) -> Record:
    """(h)."""
    a, b = bf16_inputs(groups, device)

    def run():
        return bf16_product(a, b)

    def plain():
        return torch.bmm(a.float(), b.float())

    want = plain()
    got = run()
    rel = rel_err(got, want)
    flops = 2 * groups * L ** 3
    rec = Record(
        "mxu_bmm_bf16 [G,128,128]x[G,128,128]", "matmul", "library",
        SITES["h"], str(device), correct=rel <= REL_TOL,
        max_abs_err=(got - want).abs().max().item(),
        ms=time_ms(run, device, 10), plain_ms=time_ms(plain, device, 3),
        ops=flops, ops_label="FLOP", library=bf16_route(device),
        detail={"groups": groups, "rel_err": f"{rel:.3e}",
                "tolerance": REL_TOL})
    return _own(rec, run, device, a.nbytes + b.nbytes + 4 * want.numel(),
                flops, "bf16")


def run(device: torch.device, small: bool = False, workdir=None):
    """Yields (d)'s record, then (h)'s."""
    yield int8_permute(device, 16 if small else 256)
    yield bf16_rate(device, 4 if small else 64)
