"""Optimizers on nested dicts of tensors: the port's copy of the
reference's ``optim/optimizers.py`` (SGD and AdamW; Adafactor is still
to port).

``update(grads, state, params, step)`` returns the parameter and state
trees, as the reference's does, but updates their tensors in place, leaf
by leaf and in chunks of ``CHUNK`` elements: the reference donates both
to XLA, which updates them in place too.  At phi3-mini's 3.83 B
parameters new trees of the parameters and both moments would add 46 GB
beside the 61 GB of parameters, gradients and moments, more than the
card holds; the chunks keep the temporaries at a few hundred MB.  The
arithmetic is the out-of-place formula's, operation for operation, so
the numbers are the same bits.  The gradients are read, never written.
States are float32 whatever the parameter dtype; ``state_decls`` gives
their declarations (the parameters' specs, zero-initialised).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, Union

import torch

from repro_torch.parallel.params import ParamDecl, tree_leaves, tree_map

LR = Union[Callable[[int], float], float]
CHUNK = 1 << 25        # elements of a leaf updated at once


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


def make_optimizer(name: str, lr: LR, weight_decay: float = 0.0,
                   **kw) -> Optimizer:
    """The optimizer a config names (``cfg.optimizer``)."""
    if name == "adamw":
        return AdamW(lr, weight_decay=weight_decay, **kw)
    if name == "sgd":
        return SGD(lr, weight_decay=weight_decay, **kw)
    if name == "adafactor":
        raise NotImplementedError(
            "Adafactor is not ported yet (ROADMAP.md queue 1, item 6.4)")
    raise KeyError(name)

