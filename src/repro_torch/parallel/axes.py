"""Logical parallel axes of one rank, the process groups behind them, and
the device the port runs on.

The reference binds logical axes (``dp``, ``tp``, ``pp``) to a JAX mesh
and runs every step inside ``shard_map``: one program over all devices.
The port runs one process per rank (``launch/mesh.py: spawn``).  A
rank's ``MeshAxes`` carries the axis sizes, its own coordinates and the
``Group``s that its collectives run over.  Rank
``r = (s * dp + d) * tp + t``: pipe outermost, model innermost, the
order of the reference's ``(pipe, data, model)`` mesh.

``MeshAxes()`` (pp = dp = tp = 1, no groups) is the one-device case:
every collective is the identity.  Sizes above 1 without groups are
allowed for declarations and parameter counts; a collective over such
an axis raises.

``record_collectives()`` logs every collective a ``Group`` issues while
it is open: the measured half of the energy ledger's wire bytes
(``telemetry/counted.py``), as the reference reads them from the HLO.
A pipeline stage's send to its neighbour and a ``ppermute`` hop are
logged as the reference's ``collective_permute``, on the sending rank.
``record_collectives(timed=True)`` also sums the host time of each
all-gather, reduce-scatter, all-reduce, all-to-all and ppermute.  A
group made with ``recorded=False`` (``Group.unrecorded``) is left out
of both: the serving engine's agreement of its ranks (the clock, the
sampled tokens, the cache's relayout) is host bookkeeping, not the
model's collectives.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Iterator, List, Optional

import torch

@dataclass(frozen=True)
class IssuedCollective:
    """One collective a ``Group`` sent to torch.distributed."""
    collective: str   # the logical collective the Group method stands for
    m_floats: float   # per-rank message in 4-byte floats (CommEvent's unit)
    group: int        # ranks in the group
    issued_as: str    # the torch.distributed call that ran it


class CollectiveLog:
    """The collectives issued while one ``record_collectives()`` block
    was open, in order (``events``).  A ``timed`` log also sums, over
    the collectives (``calls``; a pipeline's ``send`` and ``recv`` are
    not timed), the host ms spent waiting for the card's queued work
    before each (``device_wait_ms``) and the host ms of the collective
    itself (``collective_ms``: under gloo the copy to the host, the
    exchange and the copy back)."""

    def __init__(self, timed: bool = False):
        self.events: List[IssuedCollective] = []
        self.timed = timed
        self.calls = 0
        self.device_wait_ms = 0.0
        self.collective_ms = 0.0


# the logs of the open record_collectives() blocks; the autograd engine
# runs a card's backward on a thread of its own, so the list is shared
# by the process's threads (one rank per process) and guarded
_RECORDING: List[CollectiveLog] = []
_RECORDING_LOCK = threading.Lock()


@contextlib.contextmanager
def record_collectives(timed: bool = False) -> Iterator[CollectiveLog]:
    """Log every collective any ``Group`` issues inside the block,
    backward passes included.  A group of one rank issues none.
    ``timed``: time them too (``CollectiveLog``); each timed collective
    on a card tensor synchronizes the card before and after it, so that
    its time holds neither the queued work nor a later kernel.  The
    synchronizes take away the overlap of host and card: time a step
    that is measured for where its time goes, not for its speed."""
    log = CollectiveLog(timed)
    with _RECORDING_LOCK:
        _RECORDING.append(log)
    try:
        yield log
    finally:
        with _RECORDING_LOCK:
            _RECORDING[:] = [g for g in _RECORDING if g is not log]


def _issued(collective: str, t: torch.Tensor, size: int, issued_as: str):
    """Record one issued collective; ``t`` holds the per-rank message.
    Free while no ``record_collectives()`` block is open."""
    if not _RECORDING:    # read without the lock: nothing to record
        return
    ev = IssuedCollective(collective, t.numel() * t.element_size() / 4.0,
                          size, issued_as)
    with _RECORDING_LOCK:
        for log in _RECORDING:
            log.events.append(ev)


def _clocks() -> List[CollectiveLog]:
    """The open timed logs; free while no block is open."""
    if not _RECORDING:    # read without the lock: nothing to time
        return []
    with _RECORDING_LOCK:
        return [log for log in _RECORDING if log.timed]


@dataclass(frozen=True)
class Group:
    """One process group of ``size`` ranks, this rank at ``rank``;
    ``ranks`` are the members' global ranks, in group order (empty for
    the one-rank group that needs no process group).

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
    ranks: tuple = ()
    recorded: bool = True

    def unrecorded(self) -> "Group":
        """The same ranks and process group, left out of every
        ``record_collectives()`` log."""
        return replace(self, recorded=False)

    def _issue(self, collective: str, t: torch.Tensor, issued_as: str):
        if self.recorded:
            _issued(collective, t, self.size, issued_as)

    def _run(self, t: torch.Tensor, op):
        clocks = _clocks() if self.recorded else []
        if not clocks:
            return self._exchange(t, op)
        card = t.device.type == "cuda"
        t0 = time.perf_counter()
        if card:
            torch.cuda.synchronize(t.device)
        t1 = time.perf_counter()
        out = self._exchange(t, op)
        if card:
            torch.cuda.synchronize(t.device)
        t2 = time.perf_counter()
        with _RECORDING_LOCK:
            for log in clocks:
                log.calls += 1
                log.device_wait_ms += (t1 - t0) * 1e3
                log.collective_ms += (t2 - t1) * 1e3
        return out

    def _exchange(self, t: torch.Tensor, op):
        src = t.detach().contiguous()
        if self.via_host and src.device.type != "cpu":
            return op(src.cpu()).to(src.device)
        return op(src)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[...] -> [size, ...], stacked by rank."""
        if self.size == 1:
            return t.detach().unsqueeze(0).clone()
        import torch.distributed as dist
        nccl = self.backend == "nccl"
        self._issue("all_gather", t,
                    "all_gather_into_tensor" if nccl else "all_gather")

        def op(x):
            if nccl:
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
        nccl = self.backend == "nccl"
        self._issue("reduce_scatter", t[0],
                    "reduce_scatter_tensor" if nccl else "all_reduce")

        def op(x):
            if nccl:
                out = x.new_empty(tuple(x.shape[1:]))
                dist.reduce_scatter_tensor(out, x, group=self.handle)
                return out
            x = x.clone()
            dist.all_reduce(x, group=self.handle)
            return x[self.rank].contiguous()
        return self._run(t, op)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (``op="max"``: the largest element) over ranks, as a
        new tensor."""
        if self.size == 1:
            return t.detach().clone()
        import torch.distributed as dist
        self._issue("all_reduce", t, "all_reduce")
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

        def run(x):
            x = x.clone()
            dist.all_reduce(x, op=red, group=self.handle)
            return x
        return self._run(t, run)

    def ppermute(self, t: torch.Tensor, perm) -> torch.Tensor:
        """The reference's ``lax.ppermute``: ``perm`` lists ``(src, dst)``
        pairs of group ranks, no rank twice as a source or twice as a
        destination; this rank sends ``t`` to its destination and returns
        what its source sent, zeros where no pair sends to it.  The send
        and the receive are started together and waited on both, so ring
        neighbours cannot deadlock.  Logged as ``collective_permute``
        (one hop) on a sending rank."""
        dst = [d for s, d in perm if s == self.rank]
        src = [s for s, d in perm if d == self.rank]
        if self.size == 1 or dst == src == [self.rank]:
            return (t.detach().clone() if src
                    else torch.zeros_like(t.detach()))
        import torch.distributed as dist
        if dst:
            self._issue("collective_permute", t, "isend")

        def op(x):
            out = torch.zeros_like(x)
            ops = ([dist.P2POp(dist.isend, x, self.ranks[dst[0]],
                               group=self.handle)] if dst else []) + \
                ([dist.P2POp(dist.irecv, out, self.ranks[src[0]],
                             group=self.handle)] if src else [])
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            return out
        return self._run(t, op)

    def all_to_all(self, t: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """The reference's ``lax.all_to_all(..., tiled=True)``: ``t`` cut
        into ``size`` blocks along ``split_dim``, block ``i`` sent to
        group rank ``i``, and the blocks received joined along
        ``concat_dim`` in rank order.  Run as one
        ``all_to_all_single`` over the blocks stacked on a new leading
        dim."""
        split_dim, concat_dim = split_dim % t.dim(), concat_dim % t.dim()
        if t.shape[split_dim] % self.size:
            raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does "
                             f"not split over {self.size} ranks")
        if self.size == 1:
            return t.detach().clone()
        import torch.distributed as dist
        self._issue("all_to_all", t, "all_to_all_single")

        def op(x):
            parts = torch.stack(x.chunk(self.size, dim=split_dim))
            out = torch.empty_like(parts)
            dist.all_to_all_single(out, parts, group=self.handle)
            return torch.cat(out.unbind(0), dim=concat_dim)
        return self._run(t, op)

    def send(self, t: torch.Tensor, dst: int) -> "Sent":
        """Start sending ``t`` to group rank ``dst`` and return at once;
        the returned ``Sent.wait()`` ends the send.  A send never blocks,
        so two neighbours that both send first cannot deadlock.  Logged
        as ``collective_permute`` (one hop) on this, the sending, rank."""
        import torch.distributed as dist
        self._issue("collective_permute", t, "isend")
        buf = t.detach().contiguous()
        if self.via_host:
            buf = buf.cpu()
        return Sent(dist.isend(buf, self.ranks[dst], group=self.handle), buf)

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        """Receive a tensor shaped and typed like ``like`` from group rank
        ``src``, on ``like``'s device; blocks until it has arrived."""
        import torch.distributed as dist
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if self.via_host else like.device)
        dist.recv(buf, self.ranks[src], group=self.handle)
        return buf.to(like.device)


@dataclass(frozen=True)
class DryGroup(Group):
    """A group of ``size`` ranks that exchanges nothing: each collective
    is logged as ``Group`` logs it (the logical collective, this rank's
    message) and returns an uninitialised tensor of the result's shape
    on the input's device.  The dry run's (``launch/dryrun.py``): one
    rank's step on ``torch.device("meta")`` issues the collectives of
    the production mesh without the mesh."""
    backend: str = "dry"

    def all_gather(self, t):
        if self.size > 1:
            self._issue("all_gather", t, "all_gather")
        return t.new_empty((self.size,) + tuple(t.shape))

    def reduce_scatter(self, t):
        if t.shape[0] != self.size:
            raise ValueError(f"reduce_scatter wants a leading dim of "
                             f"{self.size}, got {tuple(t.shape)}")
        if self.size > 1:
            self._issue("reduce_scatter", t[0], "reduce_scatter")
        return t.new_empty(tuple(t.shape[1:]))

    def all_reduce(self, t, op: str = "sum"):
        if self.size > 1:
            self._issue("all_reduce", t, "all_reduce")
        return t.new_empty(t.shape)

    def ppermute(self, t, perm):
        if self.size > 1 and any(s == self.rank for s, _ in perm):
            self._issue("collective_permute", t, "isend")
        return t.new_empty(t.shape)

    def all_to_all(self, t, split_dim: int, concat_dim: int):
        split_dim, concat_dim = split_dim % t.dim(), concat_dim % t.dim()
        if t.shape[split_dim] % self.size:
            raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does "
                             f"not split over {self.size} ranks")
        if self.size > 1:
            self._issue("all_to_all", t, "all_to_all")
        shape = list(t.shape)
        shape[split_dim] //= self.size
        shape[concat_dim] *= self.size
        return t.new_empty(shape)

    def send(self, t, dst: int) -> "Sent":
        self._issue("collective_permute", t, "isend")
        return Sent(None, t)

    def recv(self, like, src: int):
        return like.new_empty(like.shape)


@dataclass
class Sent:
    """A send under way: ``wait()`` ends it.  Holds the buffer being sent
    (a host copy under gloo) until then."""
    work: Any
    buf: torch.Tensor

    def wait(self) -> None:
        if self.work is not None:
            self.work.wait()


@dataclass(frozen=True)
class MeshAxes:
    tp: int = 1                      # size of the model axis
    dp: int = 1                      # data-parallel ways
    pp: int = 1                      # pipeline stages
    tp_rank: int = 0                 # this rank's coordinate on the model axis
    dp_rank: int = 0                 # ... on the data axis
    pp_rank: int = 0                 # ... and its pipeline stage
    tp_group: Optional[Group] = field(default=None, compare=False)
    dp_group: Optional[Group] = field(default=None, compare=False)
    pp_group: Optional[Group] = field(default=None, compare=False)
    world_group: Optional[Group] = field(default=None, compare=False)

    def __post_init__(self):
        if min(self.tp, self.dp, self.pp) < 1:
            raise ValueError(f"mesh pp={self.pp} dp={self.dp} tp={self.tp}")

    @property
    def rank(self) -> int:
        return ((self.pp_rank * self.dp + self.dp_rank) * self.tp
                + self.tp_rank)

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
    def pp_comm(self) -> Group:
        return self._group(self.pp_group, self.pp, "pp")

    @property
    def world_comm(self) -> Group:
        return self._group(self.world_group, self.tp * self.dp * self.pp,
                           "pp*dp*tp")


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
