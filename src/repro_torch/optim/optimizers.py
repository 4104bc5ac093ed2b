"""Optimizers on nested dicts of tensors: the port's copy of the
reference's ``optim/optimizers.py`` (SGD and AdamW; Adafactor is still
to port).

Each optimizer is functional like the reference's: ``update`` returns new
parameter and state trees and leaves its inputs unchanged.  States are
float32 whatever the parameter dtype; ``state_decls`` gives their
declarations (the parameters' specs, zero-initialised).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, Union

import torch

from repro_torch.parallel.params import (ParamDecl, tree_leaves, tree_map,
                                         tree_unflatten)

LR = Union[Callable[[int], float], float]


def _map(fn, *trees):
    """``fn`` over the aligned leaves of trees shaped like the first."""
    flats = [dict(tree_leaves(t)) for t in trees]
    return tree_unflatten(trees[0], {path: fn(*(f[path] for f in flats))
                                     for path in flats[0]})


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
            m = _map(lambda mi, g: self.momentum * mi + g.float(),
                     state["m"], grads)
            upd, state = m, {"m": m}
        else:
            upd = tree_map(lambda g: g.float(), grads)
        new_params = _map(
            lambda p, u: (p.float() - lr * (u + self.weight_decay * p.float())
                          ).to(p.dtype), params, upd)
        return new_params, state


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
        m = _map(lambda mi, g: b1 * mi + (1 - b1) * g.float(),
                 state["m"], grads)
        v = _map(lambda vi, g: b2 * vi + (1 - b2) * g.float().square(),
                 state["v"], grads)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        def upd(p, mi, vi):
            u = (mi / bc1) / ((vi / bc2).sqrt() + self.eps)
            pf = p.float()
            return (pf - lr * (u + self.weight_decay * pf)).to(p.dtype)

        return _map(upd, params, m, v), {"m": m, "v": v}

