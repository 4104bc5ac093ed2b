"""Spec-aware gradient reduction: the port's copy of the reference's
``parallel/grads.py``.

A rank's backward pass gives the gradients of its own shards and of its
own rows of the batch.  A parameter's gradient is summed over every mesh
axis that does NOT shard it:

  * not sharded over dp (every parameter but FSDP's)  -> all-reduce over
    the dp group (classic data parallelism);
  * not sharded over tp, at tp > 1 (the norm scales of the ``sp``
    layout, replicated KV projections, ring attention's biases, which
    each rank applies to its own sequence chunk)      -> over tp too;
  * at pp > 1, not sharded over pp (embedding, head, final norm)
    -> over the pipe axis too: only one stage computes a gradient for
    them (the others hold zeros), and the sum gives it to every stage.
    The pipe-sharded layer stacks keep their stage's gradients.

The sums run over the rank's ``Group``s (``parallel/axes.py``), so
``record_collectives`` logs them.  Every rank issues them in the same
leaf order.
"""
from __future__ import annotations

from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import tree_leaves, tree_unflatten


def _spec_axes(spec) -> set:
    """The mesh axis names a decl's spec shards over."""
    out = set()
    for e in spec:
        if e is None:
            continue
        out.update(e if isinstance(e, tuple) else (e,))
    return out


def reduce_grads(grads, decls, axes: MeshAxes):
    """The gradient tree summed over the axes each leaf is replicated
    on.  A leaf that needs no sum is returned as it is."""
    dflat = dict(tree_leaves(decls))
    out = {}
    for path, g in tree_leaves(grads):
        ax = _spec_axes(dflat[path].spec)
        if axes.pp > 1 and "pp" not in ax:
            g = axes.pp_comm.all_reduce(g)
        if axes.dp > 1 and "dp" not in ax:
            g = axes.dp_comm.all_reduce(g)
        if axes.tp > 1 and "tp" not in ax:
            g = axes.tp_comm.all_reduce(g)
        out[path] = g
    return tree_unflatten(grads, out)
