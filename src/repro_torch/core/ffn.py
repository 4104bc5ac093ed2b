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

Pipeline parallelism (``cfg.pipeline.stages > 1``): the layer stack is
cut into contiguous stages, each running its OWN per-stage
``ProjectionStrategy`` (tensor or phantom — ``PipelineConfig.
stage_specs``), and the train step executes the 1F1B schedule of
``train/pipeline.py`` over the pipe axis, sending the feature-sharded
``[B_mb, n/tp]`` activation across stage boundaries.  On a pp = 1 mesh
the same config runs the stages one after another: the equivalence
reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import PHANTOM_KINDS, ModelConfig
from repro_torch.parallel.axes import MeshAxes, resolve_device
from repro_torch.parallel.params import (materialize_shards, stack,
                                         tree_leaves, tree_map,
                                         tree_unflatten)
from repro_torch.parallel.strategies import make_strategy, site_strategy
from repro_torch.train.pipeline import pipeline_run, split_microbatches


def ffn_strategy(cfg: ModelConfig, tp: int):
    """The one square n x n projection strategy each paper-FFN layer uses."""
    n = cfg.ffn_width
    return site_strategy(cfg, "ffn_layer", n, n, tp, bias=True)


def ffn_stage_strategies(cfg: ModelConfig, tp: int):
    """One strategy per pipeline stage (len == pipeline.stages; a single
    entry for non-pipelined configs).  Per-stage phantom specs fall back
    to the dense site default under the same divisibility guard as
    ``site_strategy``."""
    S = cfg.pipeline.stages
    if S == 1:
        return [ffn_strategy(cfg, tp)]
    n = cfg.ffn_width
    out = []
    for s in range(S):
        spec = cfg.stage_projection_spec(s)
        if spec.kind in PHANTOM_KINDS and n % tp:
            spec = dataclasses.replace(spec, kind="tensor_col")
        out.append(make_strategy(spec, n, n, tp, bias=True))
    return out


def _stack_stages(layer_decls, L_loc: int, S: int):
    """[S, L_loc, ...] stage-stacked decls, stage axis sharded over pp."""
    return tree_map(lambda d: dataclasses.replace(
        d, spec=("pp",) + tuple(d.spec)[1:]),
        stack(stack(layer_decls, L_loc), S))


def ffn_decls(cfg: ModelConfig, axes: MeshAxes):
    L, S = cfg.num_layers, cfg.pipeline.stages
    if S == 1:
        return {"layers": stack(ffn_strategy(cfg, axes.tp).decls(), L)}
    if L % S:
        raise ValueError(f"{L} layers do not divide into {S} stages")
    sts = ffn_stage_strategies(cfg, axes.tp)
    L_loc = L // S
    if not cfg.pipeline.mixed:
        # homogeneous stages: ONE [S, L_loc, ...] stack, stage axis
        # sharded over the pipe axis — each pipe rank holds exactly its
        # own stage's layers
        return {"stages": _stack_stages(sts[0].decls(), L_loc, S)}
    # mixed per-stage strategies have different param structures, so each
    # stage keeps its own subtree, replicated over the pipe axis (only
    # rank s computes with / gets gradients for stage s; the pipe sum in
    # the step restores the full gradient everywhere)
    return {f"stage{s}": stack(sts[s].decls(), L_loc) for s in range(S)}


def ffn_model_params(cfg: ModelConfig, p: int) -> int:
    """Model size (paper Table I): TP size is p-independent; phantom
    shrinks.  Pipelined configs sum their per-stage strategies."""
    S = cfg.pipeline.stages
    if S == 1:
        return cfg.num_layers * ffn_strategy(cfg, p).param_count()
    L_loc = cfg.num_layers // S
    return sum(L_loc * st.param_count()
               for st in ffn_stage_strategies(cfg, p))


_ACTS = {"relu": torch.relu, "gelu": lambda z: torch.nn.functional.gelu(
    z, approximate="tanh")}


def _apply_layers(cfg: ModelConfig, axes: MeshAxes, st, stack_params, x):
    """Apply a ``[L, ...]`` layer stack of strategy ``st`` to a feature
    shard; a Python loop where the reference scans."""
    act = _ACTS.get(cfg.mlp, torch.relu)
    for i in range(tree_leaves(stack_params)[0][1].shape[0]):
        layer = tree_map(lambda t: t[i], stack_params)
        x = act(st.apply_shard(layer, x, axes))
    return x


def ffn_apply(cfg: ModelConfig, axes: MeshAxes, params, x):
    """x: the local feature shard [B_loc, n/tp] -> [B_loc, n/tp]."""
    if cfg.pipeline.stages > 1:
        raise ValueError("pipelined FFN configs run through "
                         "make_ffn_train_step / "
                         "make_ffn_pipeline_probe_step; ffn_apply is the "
                         "single-stage path")
    return _apply_layers(cfg, axes, ffn_strategy(cfg, axes.tp),
                         params["layers"], x)


def make_ffn_stage_fn(cfg: ModelConfig, axes: MeshAxes, params):
    """The rank's ``stage_fn`` for ``pipeline_run``.  On a pp > 1 mesh
    each rank applies its own stage — its slice of the pipe-sharded
    stack, or its stage's subtree when stages mix strategies.  On pp = 1
    all stages run one after another (the equivalence reference)."""
    S = cfg.pipeline.stages
    sts = ffn_stage_strategies(cfg, axes.tp)
    mixed = cfg.pipeline.mixed

    def stage_params(s, at):
        return (params[f"stage{s}"] if mixed
                else tree_map(lambda a: a[at], params["stages"]))

    if axes.pp == 1:
        def stage_fn(x):
            for s in range(S):
                x = _apply_layers(cfg, axes, sts[s], stage_params(s, s), x)
            return x
        return stage_fn
    if axes.pp != S:
        raise ValueError(f"mesh pipe axis {axes.pp} != pipeline stages {S}")
    s = axes.pp_rank
    local = stage_params(s, 0)
    return lambda x: _apply_layers(cfg, axes, sts[s], local, x)


def _pipelined(cfg: ModelConfig, axes: MeshAxes) -> bool:
    """Whether the step runs the 1F1B pipeline; a pp > 1 mesh takes a
    config of as many stages."""
    S = cfg.pipeline.stages
    if axes.pp > 1 and S != axes.pp:
        raise ValueError(f"mesh pipe axis {axes.pp} != pipeline "
                         f"stages {S}")
    return S > 1 or axes.pp > 1


def ffn_loss_and_grads(cfg: ModelConfig, axes: MeshAxes, params, x, y,
                       global_batch: int):
    """(loss, grads, x_grad) of one rank: ``loss`` is the global MSE
    (summed over all ranks, equal on every rank), ``grads`` the rank's
    local parameter gradients, summed over the data axis (and over the
    pipe axis for mixed stages, whose subtrees every stage holds).
    ``x_grad`` is the gradient w.r.t. the input when ``x.requires_grad``
    (the energy probe's step, ``telemetry/probe.py``), else None; on a
    pipeline only stage 0 reads the input, and other stages return
    zeros.

    The step is ``train/pipeline.py: pipeline_run``: over
    ``cfg.microbatches`` microbatches for a pipelined config (only the
    last stage has a loss), one stage and one microbatch otherwise.
    """
    flat = tree_leaves(params)
    leaves = [t.detach().requires_grad_(True) for _, t in flat]
    p = tree_unflatten(params, {path: t for (path, _), t in
                                zip(flat, leaves)})
    pipelined = _pipelined(cfg, axes)
    # a single-stage config runs as a pipeline of one stage and one
    # microbatch
    M = max(cfg.microbatches, 1) if pipelined else 1
    stage_fn = (make_ffn_stage_fn(cfg, axes, p) if pipelined
                else lambda z: ffn_apply(cfg, axes, p, z))
    y_mb = split_microbatches(y, M)
    denom = global_batch * cfg.ffn_width
    # local share only — outputs are fully sharded (batch over dp,
    # features over tp), so the local sse IS this rank's unique
    # contribution; the cross-rank sums follow explicitly
    sse_local, x_grad = pipeline_run(
        stage_fn, split_microbatches(x, M), axes,
        lambda z, i: torch.sum(torch.square(z - y_mb[i])) / denom,
        input_grad=x.requires_grad)
    grads = [t.grad for t in leaves]
    if x.requires_grad:
        x_grad = (torch.zeros_like(x) if x_grad is None
                  else x_grad.reshape(x.shape))
    loss = axes.world_comm.all_reduce(sse_local)
    reduce = [axes.dp_comm] + ([axes.pp_comm] if cfg.pipeline.mixed
                               else [])
    out = []
    for t, g in zip(leaves, grads):
        g = torch.zeros_like(t) if g is None else g
        for comm in reduce:
            g = comm.all_reduce(g)
        out.append(g)
    return loss, tree_unflatten(params, {path: g for (path, _), g in
                                         zip(flat, out)}), x_grad


def make_ffn_train_step(cfg: ModelConfig, axes: MeshAxes, optimizer,
                        global_batch: int):
    """Returns (step_fn, decls, opt_decls), called inside a rank.

    step_fn(params, opt_state, step, x, y) -> (params, opt_state, loss)
    on this rank's local shards: params/opt per decls, x and y the local
    [global_batch/dp, n/tp] block.  ``loss`` is the global loss (a float
    tensor), equal on every rank.  The step is the reference's: local
    SSE over ``global_batch * n``, loss summed over all ranks, gradients
    summed over dp (and over pipe for mixed stages), then the optimizer.

    Pipelined configs (``cfg.pipeline.stages > 1``) run the 1F1B
    schedule over ``cfg.microbatches`` microbatches, as the reference's
    ``_make_ffn_pipeline_train_step`` does; a pp > 1 mesh with a config
    of another stage count is an error."""
    _pipelined(cfg, axes)
    decls = ffn_decls(cfg, axes)
    opt_decls = optimizer.state_decls(decls)

    def step_fn(params, opt_state, step, x, y):
        loss, grads, _ = ffn_loss_and_grads(cfg, axes, params, x, y,
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
    """This rank's params and optimizer state on ``device`` (the card
    unless the caller asks for the CPU): its shards of the global
    parameters drawn on the host from a generator seeded ``seed``, the
    same numbers on every rank and every device
    (``parallel/params.py: materialize_shards``)."""
    params = materialize_shards(ffn_decls(cfg, axes), axes, seed,
                                resolve_device(device))
    return params, optimizer.init(params)


def local_batch(x: torch.Tensor, axes: MeshAxes) -> torch.Tensor:
    """A global [B, n] batch -> this rank's [B/dp, n/tp] block (the
    reference's ``P("dp", "tp")`` batch spec)."""
    B, n = x.shape
    b, f = B // axes.dp, n // axes.tp
    return x[axes.dp_rank * b:(axes.dp_rank + 1) * b,
             axes.tp_rank * f:(axes.tp_rank + 1) * f].contiguous()
