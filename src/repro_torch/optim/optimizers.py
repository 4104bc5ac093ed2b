"""Optimizers on nested dicts of tensors: the port's copy of the
reference's ``optim/optimizers.py`` (SGD, AdamW and Adafactor).

``update(grads, state, params, step)`` returns the parameter and state
trees, as the reference's does, but updates their tensors in place, leaf
by leaf and, for SGD and AdamW, in chunks of ``CHUNK`` elements: the
reference donates both to XLA, which updates them in place too.
Adafactor's row and column means and its RMS clip need the whole leaf,
so it updates a leaf at a time, and a leaf of more than ``SLICE``
elements in slices along its leading dims, in two passes
(``_sliced_update``).  At phi3-mini's 3.83 B parameters new trees of
the parameters and both moments would add 46 GB beside the 61 GB of
parameters, gradients and moments, more than the card holds; the chunks
keep the temporaries at a few hundred MB.  The arithmetic is the
out-of-place formula's, operation for operation, so the numbers are the
same bits (but for the sum of squares under a sliced leaf's RMS).  The
gradients are read, never written.  States are float32 whatever the
parameter dtype; ``state_decls`` gives their declarations (the
parameters' specs, zero-initialised).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, Union

import torch

from repro_torch.parallel.params import ParamDecl, tree_leaves, tree_map

LR = Union[Callable[[int], float], float]
CHUNK = 1 << 25        # elements of a leaf updated at once
SLICE = 1 << 28        # Adafactor: larger factored leaves go in slices


def _chunks(*trees):
    """Aligned flat chunks of the leaves of trees shaped like the first:
    views of the first tree's leaves (updated in place through them),
    reshaped views of the others.  Every leaf of the first tree must be
    contiguous."""
    flats = [dict(tree_leaves(t)) for t in trees]
    for path, leaf in flats[0].items():
        parts = [leaf.view(-1)] + [f[path].reshape(-1) for f in flats[1:]]
        yield from zip(*(t.split(CHUNK) for t in parts))


def _decay_step(p, u, lr, weight_decay):
    """p <- p - lr * (u + weight_decay * p), in float32, into p; ``u``
    (float32) is overwritten."""
    pf = p.float()
    t = torch.mul(pf, weight_decay)
    u.add_(t)
    u.mul_(lr)
    if pf is p:
        p.sub_(u)
    else:
        p.copy_(pf.sub_(u))


def _zeros_decl(d: ParamDecl) -> ParamDecl:
    return replace(d, init="zeros", dtype=torch.float32)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


class Optimizer:
    # state trees whose leaves a checkpoint saves whole on every rank
    # (``train/checkpoint.py``): their layout depends on the mesh
    per_rank_state: tuple = ()

    def __init__(self, lr: LR):
        self.lr = lr if callable(lr) else (lambda _s, v=lr: v)

    def state_decls(self, param_decls):
        raise NotImplementedError

    def init(self, params):
        raise NotImplementedError

    def update(self, grads, state, params, step: int):
        """Returns (new_params, new_state)."""
        raise NotImplementedError


class SGD(Optimizer):
    def __init__(self, lr: LR, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(lr)
        self.momentum = momentum
        self.weight_decay = weight_decay

    def state_decls(self, param_decls):
        if not self.momentum:
            return {}
        return {"m": tree_map(_zeros_decl, param_decls)}

    def init(self, params):
        if not self.momentum:
            return {}
        return {"m": tree_map(_zeros_f32, params)}

    @torch.no_grad()
    def update(self, grads, state, params, step: int):
        lr = self.lr(step)
        if self.momentum:
            for p, g, m in _chunks(params, grads, state["m"]):
                m.mul_(self.momentum)
                m.add_(g.float())
                _decay_step(p, m.clone(), lr, self.weight_decay)
        else:
            for p, g in _chunks(params, grads):
                _decay_step(p, g.float().clone(), lr, self.weight_decay)
        return params, state


class AdamW(Optimizer):
    def __init__(self, lr: LR, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1):
        super().__init__(lr)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def state_decls(self, param_decls):
        z = tree_map(_zeros_decl, param_decls)
        return {"m": z, "v": z}

    def init(self, params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    @torch.no_grad()
    def update(self, grads, state, params, step: int):
        t = step + 1
        lr = self.lr(step)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        for p, g, m, v in _chunks(params, grads, state["m"], state["v"]):
            g = g.float()
            m.mul_(b1)
            m.add_(torch.mul(g, 1 - b1))
            v.mul_(b2)
            v.add_(g.square().mul_(1 - b2))
            d = torch.div(v, bc2).sqrt_().add_(self.eps)
            u = torch.div(m, bc1).div_(d)
            del d
            _decay_step(p, u, lr, self.weight_decay)
        return params, state


def _drop_axis(d: ParamDecl, axis: int) -> ParamDecl:
    """The float32 zero decl of ``d`` without dim ``axis`` (shape and
    spec; no trailing ``None`` left in the spec)."""
    axis %= len(d.shape)
    spec = list(d.spec) + [None] * (len(d.shape) - len(d.spec))
    del spec[axis]
    while spec and spec[-1] is None:
        spec.pop()
    return ParamDecl(d.shape[:axis] + d.shape[axis + 1:], tuple(spec),
                     init="zeros", dtype=torch.float32)


class Adafactor(Optimizer):
    """Factored second moments (Shazeer & Stern 2018), no momentum.

    A leaf whose last two dims both exceed 1 keeps its second moment as
    a row vector ``vr`` (the mean over the last axis) and a column vector
    ``vc`` (the mean over the second-to-last); any other leaf keeps a
    full ``vr`` and a ``(1,)`` ``vc``.  Every mean, and the RMS of the
    update that the clip reads, is over the rank's local leaf, as the
    reference's ``shard_map`` computes them: no collective.

    A factored leaf of more than ``SLICE`` elements whose leading dims
    (all but the last two) hold more than one matrix (jamba's experts,
    ``[1, E/tp, d, d_ff]`` a rank) is updated a few matrices at a time,
    so that its float32 temporaries stay a fraction of the leaf's
    (``_sliced_update``).

    ``vr`` of a column-sharded leaf and ``vc`` of a row-sharded one are
    means over the rank's local columns or rows, though their decls
    (``_drop_axis``) call them replicated: a checkpoint saves both
    moments per rank (``per_rank_state``)."""

    per_rank_state = ("vr", "vc")

    def __init__(self, lr: LR, decay: float = 0.8, eps: float = 1e-30,
                 clip_rms: float = 1.0, weight_decay: float = 0.0):
        super().__init__(lr)
        self.decay, self.eps = decay, eps
        self.clip_rms, self.weight_decay = clip_rms, weight_decay

    @staticmethod
    def _factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1

    def state_decls(self, param_decls):
        def vr(d):
            return (_drop_axis(d, -1) if self._factored(d.shape)
                    else _zeros_decl(d))

        def vc(d):
            return (_drop_axis(d, -2) if self._factored(d.shape)
                    else ParamDecl((1,), (), init="zeros",
                                   dtype=torch.float32))
        return {"vr": tree_map(vr, param_decls),
                "vc": tree_map(vc, param_decls)}

    def init(self, params):
        def vr(p):
            return (p.new_zeros(p.shape[:-1], dtype=torch.float32)
                    if self._factored(p.shape) else _zeros_f32(p))

        def vc(p):
            return (p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                dtype=torch.float32)
                    if self._factored(p.shape)
                    else p.new_zeros((1,), dtype=torch.float32))
        return {"vr": tree_map(vr, params), "vc": tree_map(vc, params)}

    @torch.no_grad()
    def update(self, grads, state, params, step: int):
        # beta2 in float32, as the reference computes it from its int32 step
        t = torch.tensor(step + 1.0, dtype=torch.float32)
        beta2 = float(1.0 - t ** -self.decay)
        lr = self.lr(step)
        gflat = dict(tree_leaves(grads))
        vrs, vcs = dict(tree_leaves(state["vr"])), dict(tree_leaves(
            state["vc"]))
        for path, p in tree_leaves(params):
            if (self._factored(p.shape) and p.numel() > SLICE
                    and p.numel() > p.shape[-2] * p.shape[-1]):
                self._sliced_update(p, gflat[path], vrs[path], vcs[path],
                                    beta2, lr)
                continue
            g = gflat[path].float()
            g2 = g.square().add_(self.eps)
            vr = vrs[path]
            if self._factored(p.shape):
                vc = vcs[path]
                vr.mul_(beta2).add_(g2.mean(-1).mul_(1 - beta2))
                vc.mul_(beta2).add_(g2.mean(-2).mul_(1 - beta2))
                del g2
                r = vr / vr.mean(-1, keepdim=True)
                denom = r[..., None] * vc[..., None, :]
                del r
            else:
                vr.mul_(beta2).add_(g2.mul_(1 - beta2))
                denom = vr.clone()
            u = denom.add_(self.eps).rsqrt_().mul_(g)
            del denom
            rms = torch.sqrt(u.square().mean() + 1e-12)
            u.div_(torch.clamp(rms / self.clip_rms, min=1.0))
            _decay_step(p, u, lr, self.weight_decay)
        return params, state

    def _sliced_update(self, p, g, vr, vc, beta2, lr):
        """The factored update of one leaf, its leading dims flattened to
        ``[n_mat, n, m]`` and taken ``SLICE // (n m)`` matrices at a
        time.  Pass 1 updates each slice's moments and sums the squares
        of its update; pass 2 recomputes each slice's update from the new
        moments, clips it by the RMS over the whole leaf and applies it.
        Every element's moments and update are the unsliced formula's;
        only the sum of squares under the RMS adds the slices' partial
        sums in turn where the unsliced ``mean`` reduces in one go."""
        n, m = p.shape[-2:]
        P, G = p.view(-1, n, m), g.reshape(-1, n, m)
        VR, VC = vr.view(-1, n), vc.view(-1, m)
        per = max(1, SLICE // (n * m))
        cuts = [slice(i, i + per) for i in range(0, P.shape[0], per)]

        def update_of(sl):
            r = VR[sl] / VR[sl].mean(-1, keepdim=True)
            denom = r[..., None] * VC[sl][..., None, :]
            del r
            return denom.add_(self.eps).rsqrt_().mul_(G[sl].float())

        sq = torch.zeros((), dtype=torch.float32, device=p.device)
        for sl in cuts:
            g2 = G[sl].float().square().add_(self.eps)
            VR[sl].mul_(beta2).add_(g2.mean(-1).mul_(1 - beta2))
            VC[sl].mul_(beta2).add_(g2.mean(-2).mul_(1 - beta2))
            del g2
            sq += update_of(sl).square_().sum()
        rms = torch.sqrt(sq / p.numel() + 1e-12)
        scale = torch.clamp(rms / self.clip_rms, min=1.0)
        for sl in cuts:
            _decay_step(P[sl], update_of(sl).div_(scale), lr,
                        self.weight_decay)


def make_optimizer(name: str, lr: LR, weight_decay: float = 0.0,
                   **kw) -> Optimizer:
    """The optimizer a config names (``cfg.optimizer``)."""
    if name == "adamw":
        return AdamW(lr, weight_decay=weight_decay, **kw)
    if name == "adafactor":
        return Adafactor(lr, weight_decay=weight_decay, **kw)
    if name == "sgd":
        return SGD(lr, weight_decay=weight_decay, **kw)
    raise KeyError(name)

