"""The (dp, mp) mesh of ranks and the SceneBatch sharding rule (port of
``or4d_tpu/parallel/mesh.py``).

JAX runs one program over a device mesh and XLA inserts the collectives;
here every rank is its own process on ``torch.distributed``, so everything
the JAX step computes over the global batch is made global explicitly with
the collectives below: the masked BN moments and their backward sums
(``models/layers.py``), the loss denominators (``models/sgpn.py``), the
gradients (``train/loop.py``) and the eval outputs.

Rank ``r`` sits at dp index ``r // mp`` and mp index ``r % mp``, the JAX
mesh's ``devices.reshape(dp, mp)`` order. Scenes shard over dp; the object
and edge slot axes over mp (images over dp only).

Gathers are written as an ``all_reduce`` of a zero-filled buffer in which
each rank fills its own block: gloo takes CUDA tensors only in
``broadcast`` and ``all_reduce``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

# SceneBatch fields whose axis 1 is the object slots, and the edge slots
_OBJ_FIELDS = ("obj_points", "gt_class", "obj_mask")
_EDGE_FIELDS = ("rel_points", "edge_index", "rel_onehot", "gt_rels", "edge_mask", "rel_hand_points")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp`` x ``mp`` ranks; this process is world rank ``rank``.
    ``world``, ``dp_group`` (the ranks of this rank's mp index, one per dp
    index) and ``mp_group`` (the ranks of this rank's dp index) are process
    groups, None where there is nothing to reduce over: all three without a
    process group, ``mp_group`` at mp = 1 and ``dp_group`` at dp = 1. An
    initialised world of one rank keeps its groups, so its collectives run
    (each the identity)."""

    dp: int = 1
    mp: int = 1
    rank: int = 0
    world: Any = None
    dp_group: Any = None
    mp_group: Any = None

    @property
    def dp_rank(self) -> int:
        return self.rank // self.mp

    @property
    def mp_rank(self) -> int:
        return self.rank % self.mp

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "mp": self.mp}


def make_mesh(dp: int = -1, mp: int = 1) -> Mesh:
    """The (dp, mp) mesh over the initialised process group, every rank in
    it; dp = -1 takes the world size over mp. Without a process group the
    world is this one process."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if dp == -1:
        if n % mp:
            raise ValueError(f"{n} devices not divisible by mp={mp}")
        dp = n // mp
    if dp * mp > n:
        raise ValueError(f"mesh {dp}x{mp} needs {dp*mp} devices, have {n}")
    if dp * mp < n:
        raise ValueError(f"mesh {dp}x{mp} leaves {n - dp * mp} of {n} ranks out; every rank must be in the mesh")
    if not dist.is_initialized():
        return Mesh()
    rank, world = dist.get_rank(), dist.group.WORLD
    if mp == 1:
        return Mesh(dp, mp, rank, world, world, None)
    if dp == 1:
        return Mesh(dp, mp, rank, world, None, world)
    # every rank creates every group, in one order (new_group is collective)
    dp_groups = [dist.new_group([d * mp + m for d in range(dp)]) for m in range(mp)]
    mp_groups = [dist.new_group([d * mp + m for m in range(mp)]) for d in range(dp)]
    return Mesh(dp, mp, rank, world, dp_groups[rank % mp], mp_groups[rank // mp])


def replicated(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """``module`` with rank 0's parameters and buffers on every rank."""
    if mesh.world is not None:
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, src=0, group=mesh.world)
    return module


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in place (no autograd); the identity for
    None."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class _AllReduce(torch.autograd.Function):
    """Sum over a group; its adjoint is the same sum (every rank's loss
    reads the reduced value)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group``; ``x`` itself for None."""
    return x if group is None else _AllReduce.apply(x, group)


class _Gather(torch.autograd.Function):
    """Equal blocks of axis 0 from every rank of a group, in group-rank
    order; its adjoint sums the cotangent over the group and keeps this
    rank's block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        n, r, b = dist.get_world_size(group), dist.get_rank(group), x.shape[0]
        ctx.group, ctx.block = group, (r * b, (r + 1) * b)
        buf = x.new_zeros((n * b,) + tuple(x.shape[1:]))
        buf[r * b:(r + 1) * b] = x
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        lo, hi = ctx.block
        return g[lo:hi], None


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in
    group-rank order, differentiable; ``x`` itself for None. Floating
    tensors only (the buffer is summed)."""
    if group is None:
        return x
    return _Gather.apply(x.movedim(dim, 0).contiguous(), group).movedim(0, dim)


def dp_block(b, mesh: Mesh):
    """This rank's block of the scenes of ``b`` (host arrays or tensors; a
    multiple of dp scenes, ``SceneBatch.pad_scenes``), with their scan
    ids, take indices and slot names (padded scenes have none)."""
    if mesh.dp == 1:
        return b
    if b.num_scenes % mesh.dp:
        raise ValueError(f"{b.num_scenes} scenes do not divide dp={mesh.dp}: pad them first")
    per = b.num_scenes // mesh.dp
    lo, hi = mesh.dp_rank * per, (mesh.dp_rank + 1) * per
    arrays = {f: getattr(b, f)[lo:hi] for f in (*_OBJ_FIELDS, *_EDGE_FIELDS)}
    return dataclasses.replace(b, **arrays, images=None if b.images is None else b.images[lo:hi],
                               scan_ids=b.scan_ids[lo:hi], take_idxs=b.take_idxs[lo:hi],
                               slot_names=b.slot_names[lo:hi])


def slot_block(x, mesh: Mesh):
    """This rank's mp block of the slot axis (axis 1) of a batch field; the
    axis must divide mp."""
    n = x.shape[1]
    if n % mesh.mp:
        raise ValueError(f"a slot axis of {n} does not divide mp={mesh.mp}")
    per = n // mesh.mp
    return x[:, mesh.mp_rank * per:(mesh.mp_rank + 1) * per]


def shard_batch(batch, mesh: Mesh):
    """This rank's block of ``batch`` under the JAX package's
    ``batch_sharding`` rule (or4d_tpu/parallel/mesh.py:33-43): scenes
    padded to a multiple of dp, then the scene axis over dp and the object
    and edge slot axes over mp; images over dp only."""
    b = dp_block(batch.pad_scenes(mesh.dp), mesh)
    if mesh.mp == 1:
        return b
    return dataclasses.replace(b, **{f: slot_block(np.asarray(getattr(b, f)), mesh)
                                     for f in (*_OBJ_FIELDS, *_EDGE_FIELDS)})
