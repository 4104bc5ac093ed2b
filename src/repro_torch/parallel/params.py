"""Parameter declaration trees.

A model is a nested dict of ``ParamDecl`` (global shape + logical
sharding spec + init recipe), with the same keys and shapes as the JAX
package's decl tree, layers stacked on axis 0.  From one decl tree:

  * ``materialize(decls, generator, device)`` -> tensors, drawn from an
    explicit ``torch.Generator`` (torch cannot reproduce ``jax.random``
    streams, so parity tests build parameters with the reference and
    hand them over through ``from_jax_params``);
  * ``materialize_shards(decls, axes, seed, device)`` -> one rank's
    shards of the global tree ``materialize`` draws from a generator
    seeded ``seed``, on the host by default: the same numbers whatever
    the device, since torch's CUDA generator draws others than its CPU
    one for the same seed.  ``draw_on=device`` draws on the rank's
    device instead: the same numbers on every rank of one card type,
    for a model too large to draw on the host
    (``materialize_shards_in_turn``: ranks sharing a card take turns);
  * ``param_count(decls)``;
  * ``stack(decls, n)`` -> per-layer decls with a leading layer axis;
  * ``shard_params(tree, decls, axes)`` -> one rank's local views, cut as
    ``shard_map``'s ``in_specs`` cut them; ``gather_params`` is its
    inverse over all ranks' local trees.

``spec`` keeps the reference's sharded-dim names as plain strings
(``"tp"``, ``"dp"``, ``"pp"`` or ``None`` per dim).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import numpy as np
import torch


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor not yet allocated (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


@dataclass(frozen=True)
class ParamDecl:
    shape: tuple
    spec: tuple = ()
    init: str = "normal"            # normal | zeros | ones | embed
    scale: Optional[float] = None   # normal stddev; default 1/sqrt(fan_in)
    dtype: torch.dtype = torch.float32

    def fan_in_scale(self) -> float:
        if self.scale is not None:
            return self.scale
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return fan_in ** -0.5


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def stack(decls, n: int):
    """Add a leading layer axis."""
    return tree_map(lambda d: replace(d, shape=(n,) + tuple(d.shape),
                                      spec=(None,) + tuple(d.spec)), decls)


def materialize(decls, generator: torch.Generator, device=None):
    """Real parameter tensors (global shapes) on ``device``, drawn from
    ``generator`` leaf by leaf in sorted path order.  ``generator`` must
    live on ``device`` (``torch.Generator(device=...)``)."""
    device = torch.device(device) if device is not None else \
        generator.device
    flat = {}
    for path, d in tree_leaves(decls):
        if d.init == "zeros":
            t = torch.zeros(d.shape, dtype=d.dtype, device=device)
        elif d.init == "ones":
            t = torch.ones(d.shape, dtype=d.dtype, device=device)
        else:
            std = 0.02 if d.init == "embed" else d.fan_in_scale()
            t = torch.randn(d.shape, generator=generator, dtype=d.dtype,
                            device=device).mul_(std)
        flat[path] = t
    return tree_unflatten(decls, flat)


def materialize_shards(decls, axes, seed: int, device, draw_on="cpu"):
    """This rank's shards of the global parameters that
    ``materialize(decls, torch.Generator(draw_on).manual_seed(seed))``
    draws: each leaf drawn on ``draw_on`` in the same sorted path order,
    cut to the rank's shard (``shard_params``), and only the shard kept,
    on ``device``.  ``draw_on`` holds one global leaf at a time beside
    the shards, so the same seed gives the same global parameters at
    any tp."""
    gen = torch.Generator(device=draw_on).manual_seed(seed)
    flat = {}
    for path, d in tree_leaves(decls):
        leaf = materialize(d, gen, draw_on)
        flat[path] = shard_params(leaf, d, axes).to(device)
        del leaf
    return tree_unflatten(decls, flat)


def materialize_shards_in_turn(decls, axes, seed: int, device, cast=None):
    """``materialize_shards`` drawn on ``device`` (``cast``, if given,
    applied to the rank's tree at once).  Ranks that share a card (gloo
    through the host) draw in turn, each returning the global leaf's
    memory to the card before the next starts: otherwise each would hold
    a global leaf at once.  Every rank calls it (a turn ends with an
    all-reduce over the world)."""
    world = axes.world_comm
    shared = (device.type == "cuda" and world.size > 1 and world.via_host)
    params = None
    for turn in range(world.size if shared else 1):
        if not shared or turn == axes.rank:
            params = materialize_shards(decls, axes, seed, device,
                                        draw_on=device)
            if cast is not None:
                params = cast(params)
        if shared:
            torch.cuda.empty_cache()
            world.all_reduce(torch.zeros(1))       # the turn ends
    return params


def meta_shards(decls, axes):
    """This rank's shards of a decl tree (``ParamDecl`` leaves, cut as
    ``shard_params`` cuts them; ``TensorSpec`` leaves, already a rank's,
    as they are) as tensors on ``torch.device("meta")``: shapes and
    dtypes, no memory.  Raises where a dim does not split over its
    axis."""
    coords = _coords(axes.pp_rank, axes.dp_rank, axes.tp_rank, axes.pp,
                     axes.dp, axes.tp)

    def one(d):
        shape = tuple(d.shape)
        if isinstance(d, ParamDecl):
            shape = tuple(s.stop - s.start
                          for s in _block(d.spec, coords, shape))
        return torch.empty(shape, dtype=d.dtype, device="meta")
    return tree_map(one, decls)


def tree_unflatten(tree, flat, prefix: str = ""):
    """Nested dict shaped like ``tree`` with leaves taken from ``flat``
    (path -> leaf, paths as ``tree_leaves`` names them)."""
    if isinstance(tree, dict):
        return {k: tree_unflatten(v, flat, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return flat[prefix]


def param_count(decls) -> int:
    return sum(int(np.prod(d.shape)) for _, d in tree_leaves(decls))


def from_jax_params(numpy_tree, device=None):
    """The reference's parameter tree, as numpy arrays (layer-stacked on
    axis 0, same keys), -> the port's parameter tree of tensors.  The
    values are copied unchanged (the tensors own their memory); bf16
    arrays (``ml_dtypes``) pass through float32, which holds every bf16
    value exactly."""
    def conv(a):
        a = np.array(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(a).to(device)
    return tree_map(conv, numpy_tree)


def _block(spec, coords: dict, shape):
    """Index of a rank's block of a tensor of global ``shape``;
    ``coords`` maps each axis name to (its size, the rank's coordinate
    on it)."""
    idx = []
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        ways, at = coords.get(entry, (1, 0))
        if size % ways:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {ways} ({entry})")
        n = size // ways
        idx.append(slice(at * n, (at + 1) * n))
    return tuple(idx)


def _coords(s: int, d: int, t: int, pp: int, dp: int, tp: int) -> dict:
    return {"tp": (tp, t), "dp": (dp, d), "pp": (pp, s)}


def shard_params(global_tree, decls, axes):
    """This rank's local copies of a GLOBAL parameter tree: each leaf cut
    along the dims its decl's spec names (``"tp"`` by the rank's model
    coordinate, ``"dp"`` by its data coordinate, ``"pp"`` by its pipeline
    stage), replicated elsewhere."""
    coords = _coords(axes.pp_rank, axes.dp_rank, axes.tp_rank, axes.pp,
                     axes.dp, axes.tp)
    flat = {}
    dflat = dict(tree_leaves(decls))
    for path, t in tree_leaves(global_tree):
        flat[path] = t[_block(dflat[path].spec, coords, t.shape)].clone()
    return tree_unflatten(global_tree, flat)


def gather_params(local_trees, decls, dp: int, tp: int, pp: int = 1):
    """The GLOBAL tree from every rank's local tree (``local_trees[r]``
    for rank ``r = (s * dp + d) * tp + t``, numpy or torch leaves): the
    inverse of ``shard_params``.  Replicated dims take the block of the
    last rank that holds them."""
    dflat = dict(tree_leaves(decls))
    flat = {}
    for path, _ in tree_leaves(local_trees[0]):
        d = dflat[path]
        leaves = [dict(tree_leaves(tr))[path] for tr in local_trees]
        local = np.asarray(leaves[0])
        shape = tuple(
            n * {"tp": tp, "dp": dp, "pp": pp}.get(
                d.spec[i] if i < len(d.spec) else None, 1)
            for i, n in enumerate(local.shape))
        out = np.empty(shape, local.dtype)
        for r, leaf in enumerate(leaves):
            s, rest = divmod(r, dp * tp)
            coords = _coords(s, *divmod(rest, tp), pp, dp, tp)
            out[_block(d.spec, coords, shape)] = np.asarray(leaf)
        flat[path] = out
    return tree_unflatten(local_trees[0], flat)
