"""Gradient compression for the data-parallel reduction: the port of the
reference's ``optim/compress.py``, the phantom idea applied to gradients.

The paper compresses activations crossing the model axis into k ghost
neurons.  The same structure applies to gradients crossing the data
axis: PowerSGD's rank-k factorisation

    G [n, m]  ~=  P Q^T,   P [n, k], Q [m, k]

with a warm-started Q and one subspace iteration a step.  The dp
all-reduces then carry k(n+m) floats instead of n*m.  Error feedback
keeps the scheme convergent: the residual G - P Q^T is added to the next
step's gradient.

The reference's trainers do not call it, and neither do the port's.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.axes import Group
from repro_torch.parallel.params import tree_leaves, tree_unflatten


def _orthonormalize(q):
    """Orthonormal columns spanning ``q``'s (k is tiny).  ``torch.linalg.qr``
    and ``jnp.linalg.qr`` may differ in the sign of a column; the
    compressed gradient ``P Q_new^T`` does not depend on those signs."""
    return torch.linalg.qr(q).Q


@torch.no_grad()
def compress_grad(g2d, q, group: Group):
    """One PowerSGD round on a 2-D gradient shard.

    ``g2d`` [n, m], ``q`` [m, k] the warm start; ``group`` the dp group.
    Returns (approx [n, m], new_q [m, k]).  The two all-reduces are the
    only communication over dp: k*(n+m) floats."""
    p_ = group.all_reduce(g2d @ q)                 # k*n floats on the wire
    p_ = _orthonormalize(p_)
    q_new = group.all_reduce(g2d.T @ p_)           # k*m floats
    return p_ @ q_new.T / group.size, q_new


def _compressed(g, rank: int) -> bool:
    return g.dim() == 2 and min(g.shape) >= 2 * rank


@torch.no_grad()
def compressed_dp_psum(grads, q_state, err_state, axes, rank: int = 4):
    """Tree-wide compressed gradient reduction over dp with error
    feedback.  2-D leaves at least ``2 * rank`` in both dims go through
    PowerSGD; small and 1-D leaves are averaged over dp exactly.  Returns
    (reduced_grads, new_q_state, new_err_state)."""
    group = axes.dp_comm
    qs, es = dict(tree_leaves(q_state)), dict(tree_leaves(err_state))
    red, new_q, new_e = {}, {}, {}
    for path, g in tree_leaves(grads):
        q, err = qs[path], es[path]
        if not _compressed(g, rank):
            red[path], new_q[path], new_e[path] = (
                group.all_reduce(g) / group.size, q, err)
            continue
        g_fb = g + err
        approx, new_q[path] = compress_grad(g_fb, q, group)
        red[path], new_e[path] = approx, g_fb - approx
    return (tree_unflatten(grads, red), tree_unflatten(grads, new_q),
            tree_unflatten(grads, new_e))


def init_compress_state(params, rank: int = 4, generator=None):
    """(q_state, err_state) shaped like the params tree: for a compressed
    leaf ``[n, m]`` a standard normal ``q`` [m, rank] drawn from
    ``generator`` (a CPU ``torch.Generator``, seeded 0 if None) in
    sorted path order and a zero error ``[n, m]``; for any other leaf
    zeros ``(1,)``.  Float32, on each leaf's device.  ``jax.random``
    streams cannot be reproduced, so parity tests hand the reference's
    ``q`` over."""
    gen = generator or torch.Generator().manual_seed(0)
    qs, es = {}, {}
    for path, p in tree_leaves(params):
        if not _compressed(p, rank):
            qs[path] = es[path] = torch.zeros((1,), device=p.device)
            continue
        qs[path] = torch.randn((p.shape[1], rank), generator=gen).to(
            p.device)
        es[path] = torch.zeros(p.shape, device=p.device)
    return tree_unflatten(params, qs), tree_unflatten(params, es)
