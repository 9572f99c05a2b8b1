"""One rank's side of a tensor-parallel serving island.

The JAX engine drives every chip of an island from one process through
``shard_map``. Here each rank is a process, and the island is
leader-driven SPMD: rank 0 of the mesh's ``tp`` dim (the leader) runs the
whole host loop, and before every device step it broadcasts a small
command — the step's name and its host operands (block tables, lens,
tokens, page ids) — that every other rank (a follower) replays on its own
slice of the weights and of the page pool. Followers take no decisions,
so no clock, generator or fault rule has to agree across processes.

``Island`` holds the process group and the collectives the serving code
calls: the head/column ``all_gather`` and weight ``gather`` of the
``all_gather`` combine, the f32 ``all_reduce`` of the ``psum`` combine,
and the command channel. Each call is one ``torch.distributed``
collective on the tensors as they lie. On CUDA tensors ``nccl`` moves them
between cards; ``gloo`` (the backend that runs several ranks on one card)
takes CUDA tensors for every collective used here — ``all_gather`` in its
list form, ``all_reduce``, ``broadcast`` — and copies them through host
memory inside the collective.
"""
from __future__ import annotations

from typing import Optional

import torch

TP_AXIS = "tp"


class Island:
    """This rank's view of the ``tp`` dim of ``mesh`` (a named
    ``DeviceMesh``): ``tp`` > 1 ranks (a tp = 1 mesh serves without an
    island), this one at ``rank``; ``wsharded``
    (the weights ride Megatron-sliced) and ``combine`` ("all_gather" or
    "psum") fix how the row-parallel products reassemble. Object
    messages travel on ``device`` when the backend is nccl (which moves
    only CUDA tensors), else through host memory."""

    def __init__(self, mesh, device: torch.device, wsharded: bool,
                 combine: str):
        import torch.distributed as dist

        self._dist = dist
        names = tuple(mesh.mesh_dim_names)
        self.tp = int(mesh.size(names.index(TP_AXIS)))
        self.rank = int(mesh.get_local_rank(TP_AXIS))
        self.group = mesh.get_group(TP_AXIS)
        self.leader = dist.get_global_rank(self.group, 0)
        self.is_leader = self.rank == 0
        self.wsharded = bool(wsharded)
        self.combine = combine
        self._obj_device: Optional[torch.device] = (
            device if "nccl" in str(dist.get_backend(self.group)) else None)

    # -- collectives of the dispatch bodies ---------------------------------
    def heads(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous block of ``x``'s ``dim`` (its head
        family of a full-head projection)."""
        n = x.shape[dim] // self.tp
        return x.narrow(dim, self.rank * n, n).contiguous()

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order —
        movement only, so the result is the unsliced tensor's bytes."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.tp)]
        self._dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` summed (in place on a contiguous copy)."""
        x = x.contiguous()
        self._dist.all_reduce(x, group=self.group)
        return x

    # -- the command channel ------------------------------------------------
    def send(self, op: str, kw: dict) -> None:
        """Leader: broadcast one command to the followers."""
        self._dist.broadcast_object_list([(op, kw)], src=self.leader,
                                         group=self.group,
                                         device=self._obj_device)

    def recv(self):
        """Follower: the next command, ``(op, kwargs)``."""
        box = [None]
        self._dist.broadcast_object_list(box, src=self.leader,
                                         group=self.group,
                                         device=self._obj_device)
        return box[0]

    def broadcast_(self, t: torch.Tensor) -> None:
        """The leader's ``t`` into every rank's ``t`` (same shape and
        dtype), in place."""
        self._dist.broadcast(t, src=self.leader, group=self.group)

    def gather_to_leader(self, obj) -> Optional[list]:
        """Every rank's ``obj`` on the leader, in rank order (None on a
        follower)."""
        out = [None] * self.tp if self.is_leader else None
        self._dist.gather_object(obj, out, dst=self.leader, group=self.group)
        return out
