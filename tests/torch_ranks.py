"""Rank bodies of the port's multi-rank tests.

``repro_torch.launch.mesh.spawn`` starts each rank as a fresh process that
imports this module (never the test files, which import jax).  Each body
takes its inputs as numpy arrays, runs every case of one test module on
this rank, and returns numpy arrays: the test compares them with the JAX
package's results on the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import PhantomConfig
from repro_torch.core.autograd import all_gather_ghosts
from repro_torch.core.phantom import phantom_apply, phantom_decls
from repro_torch.core.tp import gather_features, scatter_features
from repro_torch.parallel.params import shard_params, tree_map


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _rows(a: np.ndarray, axes) -> np.ndarray:
    b = a.shape[0] // axes.dp
    return a[axes.dp_rank * b:(axes.dp_rank + 1) * b]


def _cols(a: np.ndarray, axes) -> np.ndarray:
    f = a.shape[-1] // axes.tp
    return a[..., axes.tp_rank * f:(axes.tp_rank + 1) * f]


def _leaf(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)


def collectives_body(axes, device, inputs):
    """Algorithm 1's all-gather, the feature gather/scatter and every
    phantom variant on this rank's shards: outputs and gradients."""
    out = {}
    t = axes.tp_rank

    # all_gather_ghosts: [32, k/p] local -> [p, 32, k/p]; the loss weights
    # source rank i by i, as tests/test_phantom.py does
    g = _leaf(_cols(inputs["ghosts"], axes))
    g_all = all_gather_ghosts(g, axes)
    w = torch.arange(axes.tp, dtype=torch.float32).view(-1, 1, 1)
    (g_all * g_all * w).sum().backward()
    out["ghosts_fwd"] = _np(g_all)
    out["ghosts_grad"] = _np(g.grad)

    # gather_features: [B/dp, n/tp] -> [B/dp, n]; loss scaled by 1 + t
    x = _leaf(_cols(_rows(inputs["features"], axes), axes))
    full = gather_features(x, axes)
    (full * full * (1.0 + t)).sum().backward()
    out["gather_fwd"] = _np(full)
    out["gather_grad"] = _np(x.grad)

    # scatter_features: partial [B/dp, n] per rank -> reduced [B/dp, n/tp]
    zp = _leaf(_cols(_rows(inputs["partials"], axes), axes))
    z = scatter_features(zp, axes)
    (z * z * (1.0 + t)).sum().backward()
    out["scatter_fwd"] = _np(z)
    out["scatter_grad"] = _np(zp.grad)

    # phantom_apply: local output and dp-summed parameter gradients
    x_g, y_g = inputs["phantom_x"], inputs["phantom_y"]
    n_in, n_out = x_g.shape[1], y_g.shape[1]
    for name, (variant, self_term, backend) in inputs["variants"].items():
        k = inputs["phantom_params"]["C"].shape[1]
        decls = phantom_decls(n_in, n_out, k, axes.tp)
        glob = {key: torch.from_numpy(v)
                for key, v in inputs["phantom_params"].items()}
        params = {key: v.requires_grad_(True) for key, v in
                  shard_params(glob, decls, axes).items()}
        pp = PhantomConfig(k=k, variant=variant,
                           include_self_term=self_term,
                           kernel_backend=backend)
        xl = torch.from_numpy(_cols(_rows(x_g, axes), axes).copy())
        yl = torch.from_numpy(_cols(_rows(y_g, axes), axes).copy())
        o = phantom_apply(pp, params, xl, axes)
        ((o - yl) ** 2).sum().backward()
        out[f"{name}_out"] = _np(o)
        out[f"{name}_grads"] = {
            key: _np(axes.dp_comm.all_reduce(p.grad))
            for key, p in params.items()}
    return out


def ffn_body(axes, device, inputs):
    """Three AdamW steps of the port's FFN train step per case, from the
    reference's initial parameters and the given batches; returns each
    step's loss and the final local parameters."""
    from repro_torch.core.ffn import local_batch, make_ffn_train_step
    from repro_torch.optim import AdamW
    from repro_torch.parallel.params import from_jax_params

    out = {}
    for name, case in inputs.items():
        opt = AdamW(case["lr"], weight_decay=case["weight_decay"])
        step_fn, decls, _ = make_ffn_train_step(case["cfg"], axes, opt,
                                                case["batch"])
        params = shard_params(from_jax_params(case["params"]), decls, axes)
        state = opt.init(params)
        losses = []
        for s, (x, y) in enumerate(case["batches"]):
            x, y = (local_batch(torch.from_numpy(a), axes) for a in (x, y))
            params, state, loss = step_fn(params, state, s, x, y)
            losses.append(float(loss))
        out[name] = {"losses": losses, "params": tree_map(_np, params)}
    return out


def mismatch_body(axes, device):
    """Rank 0 enters an all-reduce that no other rank joins."""
    if axes.rank == 0:
        axes.world_comm.all_reduce(torch.ones(4))
    return axes.rank


def failing_body(axes, device):
    if axes.rank == 1:
        raise ValueError("rank 1 raises on purpose")
    return axes.rank


def telemetry_body(axes, device, steps):
    """The train_smoke probe (tensor_col, and phantom through the kernel
    backend) and the same phantom step through plain torch ops: each
    strategy's (measured, predicted) pair from ``measure_ffn_step``."""
    from repro_torch.benchmarks.train_smoke import (BATCH, K, probe_rank,
                                                    smoke_config)
    from repro_torch.configs.base import phantom_projection_map
    from repro_torch.telemetry import measure_ffn_step

    out = probe_rank(axes, device, steps)
    plain = smoke_config("phantom").replace(
        projections=phantom_projection_map(K, ffn_layer=True,
                                           kernel_backend="xla"))
    out["phantom_plain"] = measure_ffn_step(plain, axes, BATCH, steps=0,
                                            device=device)
    return out
