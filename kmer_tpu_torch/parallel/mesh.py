"""The ("data", "seq") mesh over a torch.distributed process group.

The counterpart of ``kmer_tpu/parallel/mesh.py``.  JAX's mesh is one
controller's grid of devices; here every mesh position is one process
(rank), and a rank ``r`` sits at ``(d, s) = divmod(r, sp)``: the order in
which ``P((AXIS_DATA, AXIS_SEQ))`` flattens, so rank r owns the hash range
that ``kmer_tpu``'s device r owns.

"data" shards read batches; "seq" shards the base axis of each read, with
a k-1 halo from the next seq neighbour (``comm.ring_shift``).  A mesh of
one rank needs no process group: without one its collectives are
identities.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_SEQ = "seq"


def mesh_shape_for(n_devices: int, seq_parallel: int | None = None
                   ) -> tuple[int, int]:
    """A (data, seq) factorization of n_devices: all "data" by default,
    or an explicit seq extent."""
    if seq_parallel is None:
        return (n_devices, 1)
    if n_devices % seq_parallel:
        raise ValueError(
            f"{n_devices} devices not divisible by seq={seq_parallel}")
    return (n_devices // seq_parallel, seq_parallel)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data, seq) mesh.

    shape: (dp, sp); rank: this process's rank (= d * sp + s); device:
    the rank's torch device; groups: the process group of each axis that
    holds this rank, and ``"all"`` for both axes together (None where no
    process group is initialized, or where an axis of a larger world has
    one rank: no collective is needed there).
    """

    shape: tuple[int, int]
    rank: int
    device: torch.device
    groups: dict

    @property
    def n_parts(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def coords(self) -> tuple[int, int]:
        """(d, s): this rank's data and seq index."""
        return divmod(self.rank, self.shape[1])

    def group(self, axis: str):
        """The process group of ``axis`` ("data", "seq" or "all")."""
        return self.groups.get(axis)


_MESHES: dict = {}


def make_mesh(shape: tuple[int, int] | None = None, *,
              device: str | torch.device) -> Mesh:
    """The mesh of ``shape`` over every rank of the default process group
    (one rank and no group when torch.distributed is not initialized).

    Every rank must call this with the same shape: creating the axis
    groups is collective.  Meshes are cached by (shape, device, process
    group).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = mesh_shape_for(world)
    shape = (int(shape[0]), int(shape[1]))
    if shape[0] * shape[1] != world:
        raise ValueError(
            f"mesh {shape} needs {shape[0] * shape[1]} ranks; the process "
            f"group has {world}")
    device = torch.device(device)
    on = dist.is_initialized()
    key = (shape, str(device), dist.group.WORLD if on else None)
    if key in _MESHES:
        return _MESHES[key]
    dp, sp = shape
    groups: dict = {"all": dist.group.WORLD if on else None}
    for axis, members in (
            (AXIS_DATA, [[d * sp + s for d in range(dp)] for s in range(sp)]),
            (AXIS_SEQ, [[d * sp + s for s in range(sp)] for d in range(dp)])):
        size = len(members[0])
        groups[axis] = None
        if on and size == world:
            groups[axis] = dist.group.WORLD
            continue
        if size == 1:
            continue
        for ranks in members:  # every rank creates every group, in order
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    mesh = Mesh(shape=shape, rank=rank, device=device, groups=groups)
    _MESHES[key] = mesh
    return mesh
