"""Process-group initialization over torch.distributed.

The counterpart of ``kmer_tpu/parallel/multihost.py``.  Where JAX's
single controller drives every device of a host, the port runs one
process per mesh rank: each calls ``initialize_multihost`` with the same
coordinator (``host:port``; rank 0 listens there), the world size and its
own rank, then builds its mesh with ``make_pod_mesh``.

Two explicit backends: ``nccl``, one rank per card; and ``gloo``, for the
CPU or for several ranks that share one card (collectives on CUDA tensors
that gloo does not take go through host buffers, ``comm._host_staged``).
Nothing picks a backend or a device silently.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, mesh_shape_for

BACKENDS = ("nccl", "gloo")


def rank_device(device: str | torch.device, local_rank: int
                ) -> torch.device:
    """A rank's device: ``cpu``, or ``cuda:<local_rank % cards>`` for a
    bare ``cuda`` (an explicit ``cuda:i`` is kept)."""
    device = torch.device(device)
    if device.type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                f"device {device} was asked for, but no CUDA card is "
                "visible")
        if device.index is None:
            device = torch.device("cuda", local_rank % n)
    return device


def check_backend(backend: str, device: str | torch.device,
                  host_processes: int | None) -> None:
    """Refuse a backend that cannot serve this layout: nccl needs CUDA and
    one card for each of the ``host_processes`` ranks on this host (not
    counted where that number is unknown)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(
                f"backend 'nccl' runs on CUDA devices, not {device}; use "
                "backend 'gloo' on the CPU")
        cards = torch.cuda.device_count()
        if cards == 0 or (host_processes is not None
                          and host_processes > cards):
            raise ValueError(
                f"backend 'nccl' needs one card per rank: "
                f"{host_processes} rank(s) on this host, {cards} card(s); "
                "use backend 'gloo' for ranks that share a card")


LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1", "[::1]")


def host_processes(coordinator_address: str | None, world: int
                   ) -> int | None:
    """The number of ranks on this host: ``LOCAL_WORLD_SIZE`` where it is
    set, the whole world when the coordinator is this host, else unknown
    (None)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if coordinator_address is not None:
        host = coordinator_address.rsplit(":", 1)[0]
    else:
        host = os.environ.get("MASTER_ADDR")
    return world if host in LOCAL_HOSTS else None


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    strict: bool | None = None,
    timeout_s: int = 300,
    *,
    backend: str,
    device: str | torch.device,
) -> bool:
    """Join the process group; True when it has more than one rank.

    With no coordinator, world size or rank, the group comes from the
    environment (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``)
    and a failure degrades to one process with a logged warning.  When
    any of the three is given (the caller asked for this topology), a
    failure raises instead of shrinking the job to one process: strict
    defaults to True then; strict=False opts back into best effort.
    Every collective of the group times out after ``timeout_s``.
    """
    explicit = any(x is not None for x in
                   (coordinator_address, num_processes, process_id))
    if strict is None:
        strict = explicit
    world = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE", 1))
    check_backend(backend, device,
                  host_processes(coordinator_address, world))
    try:
        kwargs = {}
        if coordinator_address is not None:
            kwargs = dict(init_method=f"tcp://{coordinator_address}",
                          world_size=num_processes, rank=process_id)
        else:
            kwargs = dict(init_method="env://")
            if num_processes is not None:
                kwargs["world_size"] = num_processes
            if process_id is not None:
                kwargs["rank"] = process_id
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
        return dist.get_world_size() > 1
    except Exception as e:
        if strict:
            raise RuntimeError(
                "multi-host initialization failed for the requested topology "
                f"(coordinator={coordinator_address!r}, "
                f"num_processes={num_processes}, process_id={process_id}): {e}"
            ) from e
        from ..utils.logging import get_logger

        get_logger().warning(
            "torch.distributed.init_process_group failed (%s); continuing "
            "single-process", e)
        return False


def local_rank() -> int:
    """This process's rank among those of its host (``LOCAL_RANK``, else
    the global rank)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def make_pod_mesh(seq_parallel: int | None = None, *,
                  device: str | torch.device) -> Mesh:
    """Mesh over every rank of the process group, each on its own device
    (``rank_device``)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(mesh_shape_for(n, seq_parallel),
                     device=rank_device(device, local_rank()))


def host_local_batch(global_batch: int) -> int:
    """Per-rank read-batch size for an evenly sharded global batch."""
    pc = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % pc:
        raise ValueError(
            f"global batch {global_batch} not divisible by {pc} hosts")
    return global_batch // pc
