"""The paper's experimental subject: width-n, depth-L fully-connected
networks trained with MSE on the Gaussian-teacher dataset (§VI), in both
parallelization styles:

  * TP  — conventional tensor parallelism (baseline, paper Fig. 1a)
  * PP  — phantom parallelism (paper Fig. 1b/3/4)

Each rank runs the same step on its shards, with explicit collectives,
so the communication is exactly the paper's Table II schedule:

  TP per layer:  All-Gather(n/p * batch) fwd, Reduce-Scatter bwd
  PP per layer:  All-Gather(k * batch)   fwd, Reduce-Scatter bwd

Everything here runs inside one rank (``launch/mesh.py: spawn``) on its
``MeshAxes``; activations are the local ``[B/dp, n/tp]`` feature shard.
Pipelined configs (``cfg.pipeline.stages > 1``) are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.axes import PIPELINE_TODO, MeshAxes
from repro_torch.parallel.params import (materialize, shard_params, stack,
                                         tree_leaves, tree_map,
                                         tree_unflatten)
from repro_torch.parallel.strategies import site_strategy


def _single_stage(cfg: ModelConfig):
    if cfg.pipeline.stages > 1:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.pipeline.stages} pipeline stages; see "
            f"{PIPELINE_TODO}")


def ffn_strategy(cfg: ModelConfig, tp: int):
    """The one square n x n projection strategy each paper-FFN layer uses."""
    n = cfg.ffn_width
    return site_strategy(cfg, "ffn_layer", n, n, tp, bias=True)


def ffn_decls(cfg: ModelConfig, axes: MeshAxes):
    _single_stage(cfg)
    return {"layers": stack(ffn_strategy(cfg, axes.tp).decls(),
                            cfg.num_layers)}


def ffn_model_params(cfg: ModelConfig, p: int) -> int:
    """Model size (paper Table I): TP size is p-independent; phantom
    shrinks."""
    _single_stage(cfg)
    return cfg.num_layers * ffn_strategy(cfg, p).param_count()


_ACTS = {"relu": torch.relu, "gelu": lambda z: torch.nn.functional.gelu(
    z, approximate="tanh")}


def ffn_apply(cfg: ModelConfig, axes: MeshAxes, params, x):
    """x: the local feature shard [B_loc, n/tp] -> [B_loc, n/tp]; a Python
    loop over the stacked layers where the reference scans."""
    _single_stage(cfg)
    act = _ACTS.get(cfg.mlp, torch.relu)
    st = ffn_strategy(cfg, axes.tp)
    for i in range(cfg.num_layers):
        layer = tree_map(lambda t: t[i], params["layers"])
        x = act(st.apply_shard(layer, x, axes))
    return x


def ffn_loss_and_grads(cfg: ModelConfig, axes: MeshAxes, params, x, y,
                       global_batch: int):
    """(loss, grads) of one rank: ``loss`` is the global MSE (summed over
    all ranks, equal on every rank), ``grads`` the rank's local parameter
    gradients, summed over the data axis."""
    flat = tree_leaves(params)
    leaves = [t.detach().requires_grad_(True) for _, t in flat]
    p = tree_unflatten(params, {path: t for (path, _), t in
                                zip(flat, leaves)})
    out = ffn_apply(cfg, axes, p, x)
    # local share only — outputs are fully sharded (batch over dp,
    # features over tp), so the local sse IS this rank's unique
    # contribution; the cross-rank sums follow explicitly
    sse_local = torch.sum(torch.square(out - y)) / (global_batch
                                                    * cfg.ffn_width)
    grads = torch.autograd.grad(sse_local, leaves, allow_unused=True)
    loss = axes.world_comm.all_reduce(sse_local)
    grads = [axes.dp_comm.all_reduce(torch.zeros_like(t) if g is None
                                     else g)
             for t, g in zip(leaves, grads)]
    return loss, tree_unflatten(params, {path: g for (path, _), g in
                                         zip(flat, grads)})


def make_ffn_train_step(cfg: ModelConfig, axes: MeshAxes, optimizer,
                        global_batch: int):
    """Returns (step_fn, decls, opt_decls), called inside a rank.

    step_fn(params, opt_state, step, x, y) -> (params, opt_state, loss)
    on this rank's local shards: params/opt per decls, x and y the local
    [global_batch/dp, n/tp] block.  ``loss`` is the global loss (a float
    tensor), equal on every rank.  The step is the reference's: local
    SSE over ``global_batch * n``, loss summed over all ranks, gradients
    summed over dp, then the optimizer."""
    decls = ffn_decls(cfg, axes)
    opt_decls = optimizer.state_decls(decls)

    def step_fn(params, opt_state, step, x, y):
        loss, grads = ffn_loss_and_grads(cfg, axes, params, x, y,
                                         global_batch)
        params, opt_state = optimizer.update(grads, opt_state, params,
                                             int(step))
        return params, opt_state, loss

    return step_fn, decls, opt_decls


def make_ffn_forward(cfg: ModelConfig, axes: MeshAxes):
    """Forward pass for inference, called inside a rank: (fn, decls),
    fn(params, x) -> the local output shard."""
    decls = ffn_decls(cfg, axes)

    @torch.no_grad()
    def fwd(params, x):
        return ffn_apply(cfg, axes, params, x)
    return fwd, decls


def init_ffn(cfg: ModelConfig, axes: MeshAxes, optimizer, seed: int = 0,
             device=None):
    """This rank's params and optimizer state: the global parameters
    drawn from a ``torch.Generator`` seeded ``seed`` on ``device`` (the
    same on every rank), then cut to the rank's shards."""
    decls = ffn_decls(cfg, axes)
    dev = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = shard_params(materialize(decls, gen, dev), decls, axes)
    return params, optimizer.init(params)


def local_batch(x: torch.Tensor, axes: MeshAxes) -> torch.Tensor:
    """A global [B, n] batch -> this rank's [B/dp, n/tp] block (the
    reference's ``P("dp", "tp")`` batch spec)."""
    B, n = x.shape
    b, f = B // axes.dp, n // axes.tp
    return x[axes.dp_rank * b:(axes.dp_rank + 1) * b,
             axes.tp_rank * f:(axes.tp_rank + 1) * f].contiguous()
