"""The collectives of the multi-device port: the one module that calls
torch.distributed's communication ops.

Each is the counterpart of a JAX collective inside ``shard_map``:

* ``all_gather_tiled``: ``jax.lax.all_gather(x, axes, tiled=True)``;
* ``all_to_all_slabs``: ``jax.lax.all_to_all(x, axes, 0, 0)`` of fixed
  ``[n_parts, cap, ...]`` slabs;
* ``all_reduce_sum``: ``jax.lax.psum`` of int64 values;
* ``ring_shift``: the seq-axis ``ppermute`` of ``dist.py``'s halo, rank
  s receiving rank s+1's tensor.

Without a process group (one rank, none initialized) each is the
identity; a group of one rank runs the collective all the same.  The
gloo backend takes CUDA tensors only for some collectives; for the
others, the tensors go through pinned host buffers in ``_host_staged``
and the names of those collectives are recorded in ``STAGED``.  That is transport only: what is
sent and received stays on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh

# gloo collectives that take CUDA tensors (torch 2.11 on an H100, each
# probed in a fresh 2-rank world): all_gather_into_tensor and all_reduce
# give the right values; all_to_all_single returns wrong values and
# send/recv writes from the device pointer as if it were host memory
# ("writev: Bad address"), so those two are staged through the host
GLOO_CUDA = frozenset({"all_gather_into_tensor", "all_reduce"})

STAGED: set[str] = set()  # collectives this process staged through the host


def _staging(name: str, group, x: torch.Tensor) -> bool:
    return (x.is_cuda and dist.get_backend(group) == "gloo"
            and name not in GLOO_CUDA)


def _host_staged(name: str, run, outs: list[torch.Tensor],
                 ins: list[torch.Tensor]) -> None:
    """``run(host_outs, host_ins)`` on pinned host copies of ``ins``, then
    the host outputs copied into ``outs`` (CUDA tensors).  An output that
    is also an input (an in-place collective) shares its host copy."""
    STAGED.add(name)
    pin = torch.cuda.is_available()
    h_ins = [torch.empty(x.shape, dtype=x.dtype, pin_memory=pin).copy_(x)
             for x in ins]
    h_outs = [next((h for x, h in zip(ins, h_ins) if x is o), None)
              for o in outs]
    h_outs = [torch.empty(o.shape, dtype=o.dtype, pin_memory=pin)
              if h is None else h for o, h in zip(outs, h_outs)]
    run(h_outs, h_ins)
    for o, h in zip(outs, h_outs):
        o.copy_(h)


def _collective(name: str, group, run, outs, ins) -> None:
    if _staging(name, group, ins[0]):
        _host_staged(name, run, outs, ins)
    else:
        run(outs, ins)


def all_gather_tiled(x: torch.Tensor, mesh: Mesh, axis: str = "all"
                     ) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated on dim 0 in rank
    order."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _collective("all_gather_into_tensor", group,
                lambda o, i: dist.all_gather_into_tensor(o[0], i[0],
                                                         group=group),
                [out], [x])
    return out


def all_to_all_slabs(send: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Slab b of ``send`` ([n_parts, ...]) goes to rank b; slab r of the
    result came from rank r."""
    group = mesh.group("all")
    if group is None:
        return send
    send = send.contiguous()
    recv = torch.empty_like(send)
    _collective("all_to_all_single", group,
                lambda o, i: dist.all_to_all_single(o[0], i[0], group=group),
                [recv], [send])
    return recv


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str = "all"
                   ) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axis``, as a new tensor."""
    group = mesh.group(axis)
    out = x.clone()
    if group is None:
        return out
    _collective("all_reduce", group,
                lambda o, i: dist.all_reduce(o[0], group=group), [out], [out])
    return out


def ring_shift(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ``x`` of the next rank on the seq ring (s + 1 mod sp, same d):
    rank s sends to s - 1 and receives from s + 1."""
    dp, sp = mesh.shape
    if sp == 1:
        return x
    d, s = mesh.coords
    nxt, prv = d * sp + (s + 1) % sp, d * sp + (s - 1) % sp
    x = x.contiguous()
    out = torch.empty_like(x)

    def run(o, i):
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, i[0], prv),
                                         dist.P2POp(dist.irecv, o[0], nxt)]):
            w.wait()

    _collective("batch_isend_irecv", mesh.group("all"), run, [out], [x])
    return out
