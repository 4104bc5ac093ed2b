"""Logical parallel axes of one rank, the process groups behind them, and
the device the port runs on.

The reference binds logical axes (``dp``, ``tp``, ``pp``) to a JAX mesh
and runs every step inside ``shard_map``: one program over all devices.
The port runs one process per rank (``launch/mesh.py: spawn``).  A
rank's ``MeshAxes`` carries the axis sizes, its own coordinates and the
``Group``s that its collectives run over.  Rank ``r = d * tp + t``: data
major, model minor, the order of the reference's ``(data, model)`` mesh.

``MeshAxes()`` (dp = tp = 1, no groups) is the one-device case: every
collective is the identity.  Sizes above 1 without groups are allowed
for declarations and parameter counts; a collective over such an axis
raises.  ``pp > 1`` raises: the pipeline is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch

PIPELINE_TODO = ("ROADMAP.md queue 1, item 5 (pipeline: 1F1B over "
                 "isend/irecv)")
SERVE_TP_TODO = ("ROADMAP.md queue 1, item 1 (serving at tp > 1: the "
                 "sequence-sharded decode cache, ring attention and the "
                 "residual layouts)")
RING_TODO = "ROADMAP.md queue 1, item 1 (the phantom ring variant)"


@dataclass(frozen=True)
class Group:
    """One process group of ``size`` ranks, this rank at ``rank``.

    ``via_host`` is fixed when the group is made, from its backend: gloo
    cannot run every collective on CUDA tensors, so with gloo a card
    tensor is copied to the host, reduced there and copied back.  NCCL
    runs on the card.  A group of size 1 never calls torch.distributed.
    """
    size: int = 1
    rank: int = 0
    handle: Any = field(default=None, compare=False, repr=False)
    backend: str = "none"
    via_host: bool = False

    def _run(self, t: torch.Tensor, op):
        src = t.detach().contiguous()
        if self.via_host and src.device.type != "cpu":
            return op(src.cpu()).to(src.device)
        return op(src)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[...] -> [size, ...], stacked by rank."""
        if self.size == 1:
            return t.detach().unsqueeze(0).clone()
        import torch.distributed as dist

        def op(x):
            if self.backend == "nccl":
                out = x.new_empty((self.size,) + tuple(x.shape))
                dist.all_gather_into_tensor(out, x, group=self.handle)
                return out
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.handle)
            return torch.stack(parts)
        return self._run(t, op)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """[size, ...] -> [...]: the sum over ranks of row ``rank``.
        Gloo computes it as an all-reduce and keeps this rank's row (the
        same sum; gloo's own reduce-scatter differs between torch
        versions)."""
        if t.shape[0] != self.size:
            raise ValueError(f"reduce_scatter wants a leading dim of "
                             f"{self.size}, got {tuple(t.shape)}")
        if self.size == 1:
            return t.detach()[0].clone()
        import torch.distributed as dist

        def op(x):
            if self.backend == "nccl":
                out = x.new_empty(tuple(x.shape[1:]))
                dist.reduce_scatter_tensor(out, x, group=self.handle)
                return out
            x = x.clone()
            dist.all_reduce(x, group=self.handle)
            return x[self.rank].contiguous()
        return self._run(t, op)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, as a new tensor."""
        if self.size == 1:
            return t.detach().clone()
        import torch.distributed as dist

        def op(x):
            x = x.clone()
            dist.all_reduce(x, group=self.handle)
            return x
        return self._run(t, op)


@dataclass(frozen=True)
class MeshAxes:
    tp: int = 1                      # size of the model axis
    dp: int = 1                      # data-parallel ways
    pp: int = 1                      # pipeline stages
    tp_rank: int = 0                 # this rank's coordinate on the model axis
    dp_rank: int = 0                 # ... and on the data axis
    tp_group: Optional[Group] = field(default=None, compare=False)
    dp_group: Optional[Group] = field(default=None, compare=False)
    world_group: Optional[Group] = field(default=None, compare=False)

    def __post_init__(self):
        if self.pp != 1:
            raise NotImplementedError(
                f"mesh pp={self.pp}: see {PIPELINE_TODO}")
        if min(self.tp, self.dp) < 1:
            raise ValueError(f"mesh dp={self.dp} tp={self.tp}")

    @property
    def rank(self) -> int:
        return self.dp_rank * self.tp + self.tp_rank

    def _group(self, g: Optional[Group], size: int, name: str) -> Group:
        if g is not None:
            return g
        if size > 1:
            raise RuntimeError(
                f"MeshAxes({name}={size}) carries no process group; build "
                f"it inside a rank (launch/mesh.py: make_local_mesh)")
        return Group()

    @property
    def tp_comm(self) -> Group:
        return self._group(self.tp_group, self.tp, "tp")

    @property
    def dp_comm(self) -> Group:
        return self._group(self.dp_group, self.dp, "dp")

    @property
    def world_comm(self) -> Group:
        return self._group(self.world_group, self.tp * self.dp, "dp*tp")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for the CPU.  Asking for the card on a machine without one is
    an error, never a quiet switch to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain torch path on the CPU")
    return dev
