"""Collectives with their gradients — the paper's Algorithm 1 ("Custom
AllGather Autograd Function"), which the paper itself wrote as a
``torch.autograd.Function``.

The forward pass all-gathers the k-wide ghost activations over the model
axis; the backward pass reduce-scatters the ghost gradients back to the
ranks they came from.  ``psum_scatter_tiled`` is its transpose pair.
Both run over ``axes.tp_comm`` (``parallel/axes.py: Group``); with one
rank on the axis they are the identity.  ``all_gather_dp`` is the tiled
all-gather over the data axis, FSDP's gather on use.

``psum`` is the model axis's all-reduce with the gradient JAX gives
``lax.psum`` inside ``shard_map``: the cotangents are all-reduced too.
The norm moments and the loss's log-sum-exp go through it.  ``pmax``
(the loss's detached shift) has no gradient, as ``lax.pmax`` has none.

``ppermute`` and ``all_to_all`` carry the gradients JAX gives their
``lax`` namesakes: the ppermute by the inverse permutation, the
all-to-all with its split and concat dims swapped.  Ring attention and
the phantom ``ring`` variant run on them.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.axes import Group


class _AllGatherGhosts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, group: Group):
        ctx.group = group
        return group.all_gather(g)

    @staticmethod
    def backward(ctx, grad_out):
        # Algorithm 1, BACKWARD: each source rank receives the sum of the
        # gradients every rank computed for its ghosts
        return ctx.group.reduce_scatter(grad_out), None


def all_gather_ghosts(g: torch.Tensor, axes) -> torch.Tensor:
    """Paper Algorithm 1: local ghosts ``[..., k]`` -> ``[p, ..., k]``
    stacked by source rank; the gradient is reduce-scattered."""
    return _AllGatherGhosts.apply(g, axes.tp_comm)


class _PsumScatterTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: Group, dim: int):
        ctx.group, ctx.dim = group, dim
        p = group.size
        if x.shape[dim] % p:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split over {p} ranks")
        parts = torch.stack(x.chunk(p, dim=dim))     # [p, ..., n/p, ...]
        return group.reduce_scatter(parts)

    @staticmethod
    def backward(ctx, grad_out):
        full = ctx.group.all_gather(grad_out)        # [p, ..., n/p, ...]
        return torch.cat(full.unbind(0), dim=ctx.dim), None, None


def psum_scatter_tiled(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """Reduce-scatter along ``dim`` over the model axis (each rank keeps
    its contiguous ``1/p`` of the summed tensor); the gradient is the
    tiled all-gather."""
    return _PsumScatterTiled.apply(x, axes.tp_comm, dim % x.dim())


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: Group, dim: int):
        ctx.group, ctx.dim = group, dim
        return torch.cat(group.all_gather(x).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad_out):
        parts = torch.stack(grad_out.chunk(ctx.group.size, dim=ctx.dim))
        return ctx.group.reduce_scatter(parts), None, None


def all_gather_tiled(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` over the model axis, rank blocks in rank
    order; the gradient is the tiled reduce-scatter."""
    return _AllGatherTiled.apply(x, axes.tp_comm, dim % x.dim())


def all_gather_dp(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """``all_gather_tiled`` over the data axis (FSDP's gather on use:
    ``lax.all_gather`` over the dp mesh axes, whose gradient is the
    reduce-scatter that sums every dp rank's gradient of the shard).
    The identity at dp = 1."""
    if axes.dp == 1:
        return x
    return _AllGatherTiled.apply(x, axes.dp_comm, dim % x.dim())


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: Group):
        ctx.group = group
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, grad_out):
        # psum's transpose under shard_map is psum: every rank's output
        # depends on every rank's input
        return ctx.group.all_reduce(grad_out), None


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum over the model axis, differentiable: the gradient is the
    all-reduce of the cotangents.  The identity at tp = 1."""
    if axes.tp == 1:
        return x
    return _Psum.apply(x, axes.tp_comm)


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    """The elementwise max over the model axis of a tensor that carries
    no gradient (the reference takes ``lax.pmax`` after
    ``stop_gradient``).  The identity at tp = 1."""
    if x.requires_grad:
        raise ValueError("pmax has no gradient: detach its input")
    if axes.tp == 1:
        return x
    return axes.tp_comm.all_reduce(x, op="max")


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: Group, perm):
        ctx.group, ctx.perm = group, perm
        return group.ppermute(x, perm)

    @staticmethod
    def backward(ctx, grad_out):
        inverse = [(d, s) for s, d in ctx.perm]
        return ctx.group.ppermute(grad_out, inverse), None, None


def ppermute(x: torch.Tensor, axes, perm) -> torch.Tensor:
    """``lax.ppermute`` over the model axis (``Group.ppermute``),
    differentiable: the gradient is the ppermute by the inverse
    permutation.  The identity at tp = 1."""
    if axes.tp == 1:
        return x
    return _Ppermute.apply(x, axes.tp_comm, tuple(perm))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: Group, split_dim: int, concat_dim: int):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return group.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad_out):
        split_dim, concat_dim = ctx.dims
        return (ctx.group.all_to_all(grad_out, concat_dim, split_dim),
                None, None, None)


def all_to_all(x: torch.Tensor, axes, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)`` over the model axis
    (``Group.all_to_all``), differentiable: the gradient is the
    all-to-all with ``split_dim`` and ``concat_dim`` swapped.  The
    identity at tp = 1."""
    if axes.tp == 1:
        return x
    return _AllToAll.apply(x, axes.tp_comm, split_dim % x.dim(),
                           concat_dim % x.dim())
