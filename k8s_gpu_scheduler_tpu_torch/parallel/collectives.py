"""The training collectives, each an autograd function (the counterpart
of what GSPMD and ``shard_map`` insert in the JAX package's train step).

JAX states where each array lies and lets GSPMD place the collectives;
here every rank runs its own code on its own blocks, so each collective
is written out, and each forward collective carries its conjugate in the
backward:

- ``all_reduce``: sum forward, identity backward (the output is the same
  on every rank, and each rank back-propagates the same gradient into its
  part) — after a row-parallel product, the vocab-parallel lookup and
  the vocab-parallel softmax sums;
- ``copy_to``: identity forward, sum backward — before the
  column-parallel products, whose input gradients are partial sums;
- ``all_gather``: gather forward, reduce-scatter backward — a weight's
  fsdp blocks before use, K/V over ``sp`` for dense attention;
- ``gather_from``: gather forward, this rank's block of the gradient
  backward — an MoE router's logits over ``ep``, whose softmax and top-k
  every rank of the group then runs alike (so each holds the whole
  gradient already);
- ``all_to_all``: re-split forward, the inverse re-split backward
  (Ulysses attention);
- ``ring_shift``: send to the next rank and receive from the previous
  one forward, the reverse backward (ring attention).

- ``shift`` (outside autograd): the pipeline's stage-to-stage exchange,
  activations forward and cotangents backward, each posted explicitly
  by every stage in the same order (``models/pipeline.py``).

A group of ``None`` (an axis of size 1) makes each of them the identity.
On CUDA tensors ``nccl`` moves the data between cards. ``gloo``, the
backend of several ranks on one card or of the CPU, takes CUDA tensors in
its collectives (copying them through host memory itself) but not in its
point-to-point sends: for those this module makes the copy
(``_through_host``). The backend is whatever the caller gave the process
group: nothing here chooses one.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _through_host(x: torch.Tensor, group) -> bool:
    """True where gloo is handed a CUDA tensor for a point-to-point send,
    which it takes on host memory only."""
    return x.is_cuda and "gloo" in str(dist.get_backend(group))


# all_gather_into_tensor, under the name newer torch releases give it.
_gather_flat = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def _n(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_group_rank(group, dist.get_rank())


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """In place, outside autograd (gradients, the loss, a softmax's
    max)."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def all_max_(x: torch.Tensor, group) -> torch.Tensor:
    """In place, outside autograd: the elementwise max of ``x`` over
    ``group`` (``all_reduce_`` with ``ReduceOp.MAX``; exact, as a max
    is)."""
    return all_reduce_(x, group, op=dist.ReduceOp.MAX)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, dim = _n(group), dim % x.dim()
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _gather_flat(out, x, group=group)
    shape = list(x.shape)
    shape[dim] *= n
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


def _reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``g``'s ``dim``, this rank's block of
    it."""
    n, dim = _n(group), dim % g.dim()
    shape = list(g.shape)
    shape[dim:dim + 1] = [n, shape[dim] // n]
    blocks = g.reshape(shape).movedim(dim, 0).contiguous()
    out = torch.empty_like(blocks[0])
    dist.reduce_scatter_tensor(out, blocks.flatten(0, 1), group=group)
    return out


def _all_to_all(x: torch.Tensor, split: int, concat: int, group
                ) -> torch.Tensor:
    n = _n(group)
    blocks = torch.stack(x.chunk(n, dim=split)).contiguous()
    recv = torch.empty_like(blocks)
    dist.all_to_all_single(recv, blocks, group=group)
    return torch.cat(recv.unbind(0), dim=concat)


def _shift(x: torch.Tensor, offset: int, group) -> torch.Tensor:
    """Send ``x`` to the rank ``offset`` after this one in the group and
    receive the tensor of the rank ``offset`` before it; both posted at
    once (``batch_isend_irecv``), so no pair waits on the other."""
    n, r = _n(group), _rank(group)
    x = x.contiguous()
    host = _through_host(x, group)
    # Gloo moves a CUDA tensor through host memory:
    # graftcheck: ignore[host-sync]
    send = x.cpu() if host else x
    recv = torch.empty_like(send)
    to = dist.get_global_rank(group, (r + offset) % n)
    frm = dist.get_global_rank(group, (r - offset) % n)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, to, group),
        dist.P2POp(dist.irecv, recv, frm, group)])
    for req in reqs:
        req.wait()
    return recv.to(x.device) if host else recv


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n, r = _n(ctx.group), _rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[r].contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, group):
        ctx.split, ctx.concat, ctx.group = split, concat, group
        return _all_to_all(x, split, concat, group)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.concat, ctx.split, ctx.group), None,
                None, None)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, group):
        ctx.offset, ctx.group = offset, group
        return _shift(x, offset, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -ctx.offset, ctx.group), None, None


def all_reduce(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the gradient passes unchanged."""
    return x if group is None else _AllReduce.apply(x, group)


def copy_to(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group: Optional[object]
               ) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated on ``dim`` in rank order;
    the gradient is reduce-scattered back to the blocks."""
    return x if group is None else _AllGather.apply(x, dim, group)


def gather_from(x: torch.Tensor, dim: int, group: Optional[object]
                ) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated on ``dim`` in rank order,
    for a consumer every rank of the group computes alike; the gradient,
    whole and equal on every rank, is cut back to this rank's block."""
    return x if group is None else _GatherFrom.apply(x, dim, group)


def shift(x: torch.Tensor, offset: int, group: Optional[object]
          ) -> torch.Tensor:
    """Outside autograd: the ``x`` of the rank ``offset`` places before
    this one in the group, ``x`` itself sent ``offset`` places on; every
    rank of the group calls it at once (the pipeline's exchange)."""
    return x if group is None else _shift(x, offset, group)


def all_to_all(x: torch.Tensor, split: int, concat: int,
               group: Optional[object]) -> torch.Tensor:
    """``x`` cut into the group's size of blocks on ``split``, block j
    sent to rank j, the blocks received concatenated on ``concat`` in
    rank order (``jax.lax.all_to_all(..., tiled=True)``)."""
    return x if group is None else _AllToAll.apply(x, split, concat, group)


def ring_shift(x: torch.Tensor, group: Optional[object],
               offset: int = 1) -> torch.Tensor:
    """The ``x`` of the rank ``offset`` places before this one in the
    group (``jax.lax.ppermute`` over ``i -> i + offset``)."""
    return x if group is None else _RingShift.apply(x, offset, group)
