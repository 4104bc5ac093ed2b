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
from repro_torch.parallel.axes import record_collectives
from repro_torch.parallel.params import shard_params, tree_leaves, tree_map


def load_chip_smoke():
    """The repo root's ``chip_smoke.py`` as a module, without putting the
    root on ``sys.path`` (it imports nothing at the top but the standard
    library)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


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

    # the feature gather and scatter below, logged twice: untimed and timed
    with record_collectives() as log, record_collectives(timed=True) as clock:
        # gather_features: [B/dp, n/tp] -> [B/dp, n]; loss scaled by 1 + t
        x = _leaf(_cols(_rows(inputs["features"], axes), axes))
        full = gather_features(x, axes)
        (full * full * (1.0 + t)).sum().backward()
        out["gather_fwd"] = _np(full)
        out["gather_grad"] = _np(x.grad)

        # scatter_features: partial [B/dp, n] per rank -> [B/dp, n/tp]
        zp = _leaf(_cols(_rows(inputs["partials"], axes), axes))
        z = scatter_features(zp, axes)
        (z * z * (1.0 + t)).sum().backward()
        out["scatter_fwd"] = _np(z)
        out["scatter_grad"] = _np(zp.grad)
    out["timed"] = {
        name: {"collectives": [e.collective for e in lg.events],
               "calls": lg.calls, "collective_ms": lg.collective_ms,
               "device_wait_ms": lg.device_wait_ms}
        for name, lg in (("untimed", log), ("timed", clock))}

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


def port_pipeline_cfg(kind: str, k: int, M: int, stages: int, n: int = 32,
                      layers=None, backend: str = "xla"):
    """The port's twin of the reference's ``tests/helpers.py:
    pipeline_cfg``: a paper-FFN config cut into ``stages`` pipeline
    stages, homogeneous tensor/phantom or mixed (alternating per-stage
    specs), its phantom sites on ``backend``."""
    from repro_torch.configs.base import (ModelConfig, PipelineConfig,
                                          ProjectionSpec)
    if kind == "mixed":
        pipe = PipelineConfig(stages=stages, stage_specs=tuple(
            ProjectionSpec(kind="phantom", k=k, kernel_backend=backend)
            if s % 2 else ProjectionSpec(kind="tensor")
            for s in range(stages)))
    else:
        pipe = PipelineConfig(stages=stages)
    L = layers or stages
    return ModelConfig(
        name=f"pipe-{kind}-k{k}-m{M}-s{stages}-n{n}-L{L}", family="ffn",
        num_layers=L, d_model=n, ffn_width=n, ffn_depth=L,
        ffn_impl="phantom" if kind == "phantom" else "dense", mlp="relu",
        phantom=PhantomConfig(k=k, kernel_backend=backend), pipeline=pipe,
        microbatches=M)


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


def pipeline_body(axes, device, inputs):
    """The pipelined paper-FFN step on this rank of a pp x dp x tp mesh:
    the mesh's coordinates and groups, the probe (loss, local parameter
    gradients, local input gradient) per case from the reference's
    global parameters and batch, three AdamW steps per train case
    (``ffn_body``), and the ledger join of the pipelined probe."""
    from repro_torch.core.ffn import local_batch
    from repro_torch.parallel.params import from_jax_params
    from repro_torch.telemetry import (make_ffn_pipeline_probe_step,
                                       measure_ffn_pipeline_step)

    out = {"coords": (axes.pp_rank, axes.dp_rank, axes.tp_rank, axes.rank),
           "groups": {name: g.ranks for name, g in (
               ("pp", axes.pp_comm), ("dp", axes.dp_comm),
               ("tp", axes.tp_comm))},
           "probe": {}}
    for name, case in inputs["probe"].items():
        fn, decls = make_ffn_pipeline_probe_step(case["cfg"], axes,
                                                 case["batch"])
        params = shard_params(from_jax_params(case["params"]), decls, axes)
        x, y = (local_batch(torch.from_numpy(a), axes)
                for a in (case["x"], case["y"]))
        loss, (grads, x_grad) = fn(params, x, y)
        out["probe"][name] = {"loss": float(loss),
                              "grads": tree_map(_np, grads),
                              "x_grad": _np(x_grad)}
    out["train"] = ffn_body(axes, device, inputs["train"])
    out["ledger"] = {
        name: measure_ffn_pipeline_step(cfg, axes, inputs["ledger_batch"],
                                        device=device)
        for name, cfg in inputs["ledger"].items()}
    return out


def trainer_body(axes, device, inputs):
    """Three AdamW steps of the port's LM train step per case, from the
    reference's initial parameters (each rank's shards) and its token
    batches (each rank on its rows); returns each step's loss, gradient
    norm and clipped local gradients (as the optimizer got them) and the
    final local parameters."""
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel.params import from_jax_params
    from repro_torch.train.trainer import local_rows, make_train_step

    out = {}
    for name, case in inputs.items():
        opt = make_optimizer("adamw", case["lr"],
                             weight_decay=case["weight_decay"])
        step_fn, decls, _ = make_train_step(
            case["cfg"], axes, opt, microbatches=case["microbatches"],
            device=device)
        grads = []
        update = opt.update

        def recording(g, state, params, step, update=update, grads=grads):
            grads.append(tree_map(_np, g))
            return update(g, state, params, step)
        opt.update = recording
        params = shard_params(from_jax_params(case["params"]), decls, axes)
        state = opt.init(params)
        losses, gnorms = [], []
        for s, batch in enumerate(case["batches"]):
            batch = local_rows(tree_map(torch.from_numpy, batch), axes)
            params, state, m = step_fn(params, state, s, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[name] = {"losses": losses, "grad_norms": gnorms,
                     "grads": grads, "params": tree_map(_np, params)}
    return out


def _shard(a: np.ndarray, axes, dim: int) -> np.ndarray:
    """This model rank's block of ``a`` along ``dim``."""
    n = a.shape[dim] // axes.tp
    idx = [slice(None)] * a.ndim
    idx[dim] = slice(axes.tp_rank * n, (axes.tp_rank + 1) * n)
    return a[tuple(idx)]


def _in_layout(a: np.ndarray, layout: str, axes) -> np.ndarray:
    """A [B, S, d] array cut to the residual layout's local shard (all
    of it in ``rep``)."""
    if layout == "rep":
        return a
    return _shard(a, axes, {"sp": 1, "fp": 2}[layout])


def _tp_summed(grads, decls, axes):
    """Local gradients summed over the model axis where the decl does
    not shard them (``reduce_grads``' tp branch, without its dp sum)."""
    from repro_torch.parallel.grads import _spec_axes
    from repro_torch.parallel.params import tree_leaves, tree_unflatten
    dflat = dict(tree_leaves(decls))
    return tree_unflatten(grads, {
        path: (g if "tp" in _spec_axes(dflat[path].spec)
               else axes.tp_comm.all_reduce(g))
        for path, g in tree_leaves(grads)})


def layers_tp_body(axes, device, cases):
    """The layers at this rank's tp on the reference's global inputs,
    each cut to the rank's shard: ``xent_loss`` (sequence-sharded h,
    vocab-sharded head; the objective divided by tp as the trainer's),
    ``norm_apply``, ``embed_apply``, ``mlp_apply``, head-mode
    ``attention`` and cross-attention (kind ``"cross"``: K/V of the full
    ``memory``, whose gradient is returned too) (the objective
    sum(out * r)).  Returns local outputs and gradients, parameter
    gradients summed over tp where replicated."""
    from repro_torch.models import attention, layers
    from repro_torch.parallel.params import from_jax_params

    out = {}
    for name, case in cases.items():
        cfg, kind = case["cfg"], case["kind"]
        lay = case.get("layout")
        if kind == "xent":
            h = _leaf(_shard(case["h"], axes, 1))
            w = _leaf(_shard(case["w"], axes, 1))
            loss, n = layers.xent_loss(cfg, "sp", {"w": w}, h,
                                       torch.from_numpy(case["labels"]),
                                       axes)
            (loss / axes.tp).backward()
            out[name] = {"loss": float(loss), "n": int(n),
                         "h": _np(h.grad), "w": _np(w.grad)}
            continue
        r = torch.from_numpy(_in_layout(case["r"], lay, axes).copy())
        if kind == "norm":
            x = _leaf(_in_layout(case["x"], lay, axes))
            params = {k: _leaf(_shard(v, axes, 0) if lay == "fp" else v)
                      for k, v in case["params"].items()}
            y = layers.norm_apply(cfg, lay, params, x, axes)
            decls = layers.norm_decls(cfg, lay, case["x"].shape[-1])
        elif kind == "mlp":
            x = _leaf(_in_layout(case["x"], lay, axes))
            d, ff = case["x"].shape[-1], cfg.d_ff
            decls = layers.mlp_decls(cfg, axes, d, ff)
            params = tree_map(lambda t: t.requires_grad_(True), shard_params(
                from_jax_params(case["params"]), decls, axes))
            y = layers.mlp_apply(cfg, lay, params, x, axes)
        elif kind == "embed":
            x = None
            params = {"table": _leaf(_shard(case["table"], axes, 0))}
            y = layers.embed_apply(cfg, lay, params,
                                   torch.from_numpy(case["tokens"]), axes)
            decls = layers.embed_decls(cfg)
        else:
            cross = kind == "cross"
            x = _leaf(_in_layout(case["x"], lay, axes))
            decls = attention.attn_decls(cfg, axes, cross=cross)
            params = tree_map(lambda t: t.requires_grad_(True), shard_params(
                from_jax_params(case["params"]), decls, axes))
            B, S = case["x"].shape[:2]
            pos = torch.arange(S).expand(B, S)
            memory = _leaf(case["memory"]) if cross else None
            y, _ = attention.attention(cfg, lay, params, x, pos, axes,
                                       kind="train", memory=memory,
                                       cross=cross)
        (y * r).sum().backward()
        grads = _tp_summed(tree_map(lambda t: t.grad, params), decls, axes)
        out[name] = {"y": _np(y), "params": tree_map(_np, grads),
                     "x": None if x is None else _np(x.grad)}
        if kind == "cross":
            out[name]["memory"] = _np(memory.grad)
    return out


def trainer_tp_body(axes, device, inputs):
    """One mesh of ``tests/test_torch_trainer_tp.py``: the trainer cases
    (``trainer_body``), the layer cases (``layers_tp_body``) and this
    rank's shards of ``Trainer.init_state(seed)``."""
    from repro_torch.optim import AdamW
    from repro_torch.train.trainer import Trainer
    trainer = Trainer(inputs["draw_cfg"], axes, AdamW(1e-3), None,
                      device=device)
    return {"train": trainer_body(axes, device, inputs["train"]),
            "layers": layers_tp_body(axes, device, inputs["layers"]),
            "draw": tree_map(_np, trainer.init_state(
                inputs["seed"]).params)}


def lm_pipeline_body(axes, device, inputs):
    """One mesh of ``tests/test_torch_lm_pipeline.py``.  Per trainer case,
    each of the reference's steps from the reference's parameters (this
    rank's shards) and this rank's optimizer state before it, on its
    batch (the rank's rows): each step's loss, gradient norm, clipped
    local gradients (as the optimizer got them) and updated local
    parameters.
    Given a ``draw_cfg``, also this rank's shards of
    ``Trainer.init_state(seed)``."""
    from repro_torch.optim import AdamW, make_optimizer
    from repro_torch.parallel.params import from_jax_params
    from repro_torch.train.trainer import (Trainer, local_rows,
                                           make_train_step)
    out = {"train": {}}
    for name, case in inputs["train"].items():
        opt = make_optimizer(case["optimizer"], case["lr"],
                             weight_decay=case["weight_decay"])
        step_fn, decls, _ = make_train_step(
            case["cfg"], axes, opt, microbatches=case["microbatches"],
            device=device)
        res = {"losses": [], "grad_norms": [], "grads": [], "params": []}
        update = opt.update

        def recording(g, state, params, step, update=update, res=res):
            res["grads"].append(tree_map(_np, g))
            return update(g, state, params, step)
        opt.update = recording
        for s, (start, batch) in enumerate(zip(case["starts"],
                                               case["batches"])):
            params = shard_params(from_jax_params(start["params"]), decls,
                                  axes)
            state = (opt.init(params) if start["local_state"] is None
                     else from_jax_params(start["local_state"][axes.rank]))
            batch = local_rows(tree_map(torch.from_numpy, batch), axes)
            params, state, m = step_fn(params, state, s, batch)
            res["losses"].append(float(m["loss"]))
            res["grad_norms"].append(float(m["grad_norm"]))
            res["params"].append(tree_map(_np, params))
        out["train"][name] = res
    if inputs["draw_cfg"] is not None:
        trainer = Trainer(inputs["draw_cfg"], axes, AdamW(1e-3), None,
                          device=device)
        out["draw"] = tree_map(_np, trainer.init_state(
            inputs["seed"]).params)
    return out


def card_tp_step_body(axes, device, microbatches=1, arch="phi3-mini-3.8b",
                      overrides=None):
    """One float32 AdamW step of ``arch``'s smoke config (phi3-smoke:
    phantom MLP sites; olmoe-smoke: phantom attention sites and the
    experts' all-to-alls; mamba2-smoke: phantom in and out sites;
    qwen2-vl-smoke and seamless-smoke on batches with their stubs), with
    the config ``overrides`` (``{"fsdp": True}``), on this rank of a
    pp x dp x tp mesh, on its rows of the batch, over ``microbatches``
    microbatches, through the kernels (``"auto"``) and through plain
    torch (``"xla"``) from one host draw: each run's loss, gradient norm,
    clipped local gradients, updated local parameters and kernel
    launches."""
    from repro_torch.configs.base import get_config, with_kernel_backend
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.kernels import phantom_fused as pf
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import model_decls
    from repro_torch.optim import AdamW
    from repro_torch.parallel.params import materialize_shards
    from repro_torch.train.trainer import local_rows, make_train_step

    base = get_config(arch, smoke=True, dtype="float32",
                      **(overrides or {}))
    params = materialize_shards(model_decls(base, axes), axes, 0, device)
    data = (load_chip_smoke().StubbedLM(base, 4, 128, device)
            if base.family in ("vlm", "encdec") else
            LMDataset(base.vocab_size, 4, 129, device=device))
    batch = local_rows(data(0), axes)
    kernels = (flash_attention, pf.phantom_fused_matmul, pf.matmul_nt,
               pf.matmul_tn)
    out = {}
    for name, backend in (("kernel", "auto"), ("plain", "xla")):
        opt = AdamW(1e-3, weight_decay=0.1)
        seen, update = [], opt.update
        opt.update = lambda g, s, p, t, seen=seen, update=update: (
            seen.append(tree_map(_np, g)), update(g, s, p, t))[1]
        step_fn, _, _ = make_train_step(with_kernel_backend(base, backend),
                                        axes, opt, device=device,
                                        microbatches=microbatches)
        p = tree_map(torch.clone, params)
        for k in kernels:
            k.launches = 0
        p, _, m = step_fn(p, opt.init(p), 0, batch)
        torch.cuda.synchronize()
        out[name] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "grads": seen[0],
                     "params": tree_map(_np, p),
                     "launches": {k.__name__: k.launches for k in kernels}}
    out["eps"] = opt.eps
    return out


def ring_collectives_body(axes, cases):
    """``ppermute``, ``seq_to_feature`` and ``feature_to_seq`` over the
    model axis on this rank's block ``x[t]`` of each case, the objective
    sum(y * r[t]): outputs, input gradients and each case's collective
    log (collective, message floats, the call that ran it)."""
    from repro_torch.core.autograd import ppermute
    from repro_torch.models.layers import feature_to_seq, seq_to_feature
    out = {}
    t = axes.tp_rank
    for name, case in cases.items():
        x = _leaf(case["x"][t])
        with record_collectives() as log:
            if case["kind"] == "ppermute":
                y = ppermute(x, axes, case["perm"])
            elif case["kind"] == "seq_to_feature":
                y = seq_to_feature(x, axes)
            else:
                y = feature_to_seq(x, axes)
            (y * torch.from_numpy(case["r"][t])).sum().backward()
        out[name] = {"y": _np(y), "x": _np(x.grad),
                     "log": [(e.collective, e.m_floats, e.issued_as)
                             for e in log.events]}
    return out


def ring_body(axes, device, inputs):
    """One mesh of ``tests/test_torch_ring.py``: the collective cases
    (``ring_collectives_body``), the attention layer cases
    (``layers_tp_body``) and the trainer cases (``trainer_body``)."""
    return {"collectives": ring_collectives_body(axes,
                                                 inputs["collectives"]),
            "layers": layers_tp_body(axes, device, inputs["layers"]),
            "train": trainer_body(axes, device, inputs["train"])}


def moe_layers_body(axes, device, cases):
    """``models/moe.py: moe_apply`` on this rank's shard of each case's
    global input and parameters, the objective sum(y * r) + aux: the
    local output, the aux loss, the input gradient and the parameter
    gradients (summed over tp where the decl replicates them)."""
    from repro_torch.models import moe
    from repro_torch.parallel.params import from_jax_params
    out = {}
    for name, case in cases.items():
        cfg, lay = case["cfg"], case["layout"]
        decls = moe.moe_decls(cfg, axes)
        params = tree_map(lambda t: t.requires_grad_(True), shard_params(
            from_jax_params(case["params"]), decls, axes))
        x = _leaf(_in_layout(case["x"], lay, axes))
        r = torch.from_numpy(_in_layout(case["r"], lay, axes).copy())
        y, aux = moe.moe_apply(cfg, lay, params, x, axes)
        ((y * r).sum() + aux).backward()
        grads = _tp_summed(tree_map(lambda t: t.grad, params), decls, axes)
        out[name] = {"y": _np(y), "aux": float(aux), "x": _np(x.grad),
                     "params": tree_map(_np, grads)}
    return out


def moe_body(axes, device, inputs):
    """One mesh of ``tests/test_torch_moe.py``: the MoE layer cases
    (``moe_layers_body``) and the trainer cases (``trainer_body``)."""
    return {"layers": moe_layers_body(axes, device, inputs["layers"]),
            "train": trainer_body(axes, device, inputs["train"])}


def ssm_layers_body(axes, device, cases):
    """``models/ssm.py: ssm_apply`` on this rank's shard of each case's
    global input, parameters and (decode) cache.  train: the objective
    sum(y * r), the local output, input gradient and parameter gradients
    (summed over tp where the decl replicates them); prefill: the output
    and the new cache; decode: the same, from the case's cache."""
    from repro_torch.models import ssm
    from repro_torch.parallel.params import from_jax_params
    out = {}
    for name, case in cases.items():
        cfg, lay, kind = case["cfg"], case["layout"], case["kind"]
        decls = ssm.ssm_decls(cfg, axes)
        params = tree_map(lambda t: t.requires_grad_(True), shard_params(
            from_jax_params(case["params"]), decls, axes))
        x = _leaf(_in_layout(case["x"], lay, axes))
        if kind == "train":
            y, _ = ssm.ssm_apply(cfg, lay, params, x, axes, kind="train")
            r = torch.from_numpy(_in_layout(case["r"], lay, axes).copy())
            (y * r).sum().backward()
            # at tp = 1 a phantom site never reads C or D: their gradient
            # is zero, as the reference's
            grads = _tp_summed(tree_map(
                lambda t: torch.zeros_like(t) if t.grad is None else t.grad,
                params), decls, axes)
            out[name] = {"y": _np(y), "x": _np(x.grad),
                         "params": tree_map(_np, grads)}
            continue
        cache = None
        if kind == "decode":
            cache = {"conv": torch.from_numpy(
                _shard(case["cache"]["conv"], axes, 2).copy()),
                "ssm": torch.from_numpy(
                    _shard(case["cache"]["ssm"], axes, 1).copy())}
        with torch.no_grad():
            y, new = ssm.ssm_apply(cfg, lay, params, x, axes, kind=kind,
                                   cache=cache)
        out[name] = {"y": _np(y), "cache": tree_map(_np, new)}
    return out


def wire_bytes_body(axes, device, cases):
    """One training step of each case's config on this rank (the weights
    from one seed, one ``LMDataset`` batch, with the family's stubs
    from ``chip_smoke.py: StubbedLM`` where it needs them) with its
    collectives logged: the rank's wire bytes, priced as
    ``telemetry/counted.py: collective_costs`` prices them, and their
    split by collective."""
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.models.model import model_decls
    from repro_torch.optim import AdamW
    from repro_torch.parallel.params import materialize_shards
    from repro_torch.telemetry.counted import collective_costs
    from repro_torch.train.trainer import local_rows, make_train_step
    out = {}
    for name, case in cases.items():
        cfg = case["cfg"]
        params = materialize_shards(model_decls(cfg, axes), axes, 0, device)
        data = (load_chip_smoke().StubbedLM(cfg, case["batch"], case["seq"],
                                            device)
                if cfg.family in ("vlm", "encdec") else
                LMDataset(cfg.vocab_size, case["batch"], case["seq"] + 1,
                          device=device))
        batch = local_rows(data(0), axes)
        opt = AdamW(1e-3)
        step_fn, _, _ = make_train_step(cfg, axes, opt, device=device)
        with record_collectives() as log:
            step_fn(params, opt.init(params), 0, batch)
        per_op = collective_costs(log.events)
        out[name] = {"wire_bytes": sum(r["wire_bytes"]
                                       for r in per_op.values()),
                     "by_collective": {k: r["wire_bytes"]
                                       for k, r in per_op.items()}}
    return out


def ssm_body(axes, device, inputs):
    """One mesh of ``tests/test_torch_ssm.py``: the SSM layer cases
    (``ssm_layers_body``), the trainer cases (``lm_pipeline_body``: each
    step from the reference's state before it) and the wire-byte cases
    (``wire_bytes_body``)."""
    return {"layers": ssm_layers_body(axes, device, inputs["layers"]),
            "train": lm_pipeline_body(axes, device, {
                "train": inputs["train"], "draw_cfg": None})["train"],
            "wire": wire_bytes_body(axes, device, inputs["wire"])}


def fsdp_gather_body(axes, device, cases):
    """``models/layers.py: gather_fsdp`` on this rank's shard of each
    case's global weight (plain or int8): the gathered weight (float32)
    and the gradient of sum(gathered * r) at the local shard."""
    from repro_torch.models.layers import gather_fsdp
    from repro_torch.parallel.params import ParamDecl
    out = {}
    for name, case in cases.items():
        decl = ParamDecl(case["w"].shape, case["spec"])
        w = _leaf(shard_params(torch.from_numpy(case["w"]), decl,
                               axes).numpy())
        full = gather_fsdp(w, case["spec"], axes, quant=case["quant"])
        r = torch.from_numpy(_shard(case["r"], axes, case["tp_dim"]).copy()
                             if case["tp_dim"] is not None else case["r"])
        (full.float() * r).sum().backward()
        out[name] = {"w": _np(full), "dtype": str(full.dtype),
                     "grad": _np(w.grad)}
    return out


def fsdp_body(axes, device, inputs):
    """The mesh of ``tests/test_torch_fsdp.py``: the gather cases
    (``fsdp_gather_body``), the AdamW trainer cases (``trainer_body``),
    the one-step Adafactor cases (``lm_pipeline_body``) and the wire-byte
    cases (``wire_bytes_body``)."""
    return {"gather": fsdp_gather_body(axes, device, inputs["gather"]),
            "train": trainer_body(axes, device, inputs["train"]),
            "adafactor": lm_pipeline_body(
                axes, device, {"train": inputs["adafactor"],
                               "draw_cfg": None})["train"],
            "wire": wire_bytes_body(axes, device, inputs["wire"])}


def compress_body(axes, device, inputs):
    """One mesh of ``tests/test_torch_compress.py`` (dp 2 x tp 4):
    ``compress_grad`` and ``compressed_dp_psum`` on the given gradients
    (the same on every rank, or this dp rank's block of a global one),
    their collectives logged, and three compressed SGD steps of the paper
    FFN from the reference's parameters and compression state."""
    from repro_torch.core.ffn import ffn_apply, ffn_decls, local_batch
    from repro_torch.optim.compress import compress_grad, compressed_dp_psum
    from repro_torch.parallel.params import (from_jax_params, tree_leaves,
                                             tree_unflatten)
    out = {}
    group = axes.dp_comm

    c = inputs["lowrank"]
    g = torch.from_numpy(c["g"])
    q = torch.from_numpy(c["q0"])
    for _ in range(c["rounds"]):
        q = compress_grad(g, q, group)[1]
    approx, q_last = compress_grad(g, q, group)
    out["lowrank"] = {"approx": _np(approx), "q": _np(q_last)}

    for name in ("feedback", "per_rank"):
        c = inputs[name]
        grads = {k: torch.from_numpy(_rows(a, axes) if c["per_rank"]
                                     else a) for k, a in c["g"].items()}
        q, err = from_jax_params(c["q0"]), from_jax_params(c["err0"])
        steps = []
        with record_collectives() as log:
            for _ in range(c["steps"]):
                red, q, err = compressed_dp_psum(grads, q, err, axes,
                                                 rank=c["rank"])
                steps.append(tree_map(_np, red))
        out[name] = {"reduced": steps, "q": tree_map(_np, q),
                     "err": tree_map(_np, err),
                     "m_floats": [(ev.collective, ev.m_floats, ev.group)
                                  for ev in log.events]}

    c = inputs["ffn"]
    cfg = c["cfg"]
    decls = ffn_decls(cfg, axes)
    params = shard_params(from_jax_params(c["params"]), decls, axes)
    q, err = from_jax_params(c["q0"]), from_jax_params(c["err0"])
    losses, trail = [], []
    for x, y in c["batches"]:
        x, y = (local_batch(torch.from_numpy(a), axes) for a in (x, y))
        flat = tree_leaves(params)
        leaves = [t.detach().requires_grad_(True) for _, t in flat]
        p = tree_unflatten(params, {k: t for (k, _), t in zip(flat, leaves)})
        out_ = ffn_apply(cfg, axes, p, x)
        loss = torch.sum(torch.square(out_ - y)) / (y.shape[0] * axes.dp
                                                    * cfg.ffn_width)
        loss.backward()
        grads = tree_unflatten(params, {k: t.grad for (k, _), t in
                                        zip(flat, leaves)})
        grads, q, err = compressed_dp_psum(grads, q, err, axes, rank=2)
        params = tree_unflatten(params, {
            k: (t - c["lr"] * g).detach() for (k, t), (_, g) in
            zip(tree_leaves(params), tree_leaves(grads))})
        losses.append(float(axes.world_comm.all_reduce(loss.detach())))
        trail.append(tree_map(_np, params))
    out["ffn"] = {"losses": losses, "params": trail}
    return out


def hybrid_body(axes, device, inputs):
    """One mesh of ``tests/test_torch_hybrid.py``: the trainer cases
    (``lm_pipeline_body``: each step from the reference's state before
    it) and the wire-byte cases (``wire_bytes_body``)."""
    return {"train": lm_pipeline_body(axes, device, {
                "train": inputs["train"], "draw_cfg": None})["train"],
            "wire": wire_bytes_body(axes, device, inputs["wire"])}


def splice_body(axes, device, cases):
    """``models/model.py: _embed`` (the vision splice) on this rank's
    shard of each case's embedding table, in the case's layout: the
    rank's local stream."""
    from repro_torch.models.model import _embed
    out = {}
    for name, case in cases.items():
        params = {"embed": {"table": torch.from_numpy(
            _shard(case["table"], axes, 0).copy())}}
        batch = {"tokens": torch.from_numpy(case["tokens"]),
                 "vision_embeds": torch.from_numpy(case["vision"])}
        out[name] = _np(_embed(case["cfg"], case["layout"], params, batch,
                               axes))
    return out


def family_body(axes, device, inputs):
    """One mesh of ``tests/test_torch_vlm.py`` or
    ``tests/test_torch_encdec.py``: the trainer cases
    (``lm_pipeline_body``: each step from the reference's state before
    it), the layer cases (``layers_tp_body``), the splice cases
    (``splice_body``) and the wire-byte cases (``wire_bytes_body``)."""
    return {"train": lm_pipeline_body(axes, device, {
                "train": inputs["train"], "draw_cfg": None})["train"],
            "layers": layers_tp_body(axes, device, inputs.get("layers", {})),
            "splice": splice_body(axes, device, inputs.get("splice", {})),
            "wire": wire_bytes_body(axes, device, inputs.get("wire", {}))}


def serve_mesh_body(axes, device, cases):
    """``tests/test_torch_serve_mesh.py`` (and the family files that
    ``tests/serve_families.py`` drives) on this rank, for each case
    (``{"cfg", "params"`` (the reference's global numpy tree), ``"toks"``
    [slots, S + 1], ``"S"``, ``"group"`` (prompts), ``"stream"``
    (prompts, arrivals, new tokens), ``"slots"``, ``"max_len"``}), the
    frontends' stubs drawn from each row's tokens
    (``serve/engine.py: drawn_stubs``):

      * one prefill of ``toks[:, :S]`` and, after the engine's splice,
        one decode step of ``toks[:, S]`` at position S: this rank's
        rows of both logits, and each step's counted wire bytes;
      * the engine's cache after submitting ``group`` (its prefill
        groups spliced in);
      * the greedy streams of ``stream`` (where given) through a
        ``replay``."""
    from repro_torch.models.model import model_decls
    from repro_torch.parallel.params import from_jax_params, tree_leaves
    from repro_torch.serve.engine import Request, ServeEngine, drawn_stubs
    from repro_torch.serve.traffic import replay
    from repro_torch.telemetry.counted import count_step
    out = {}
    for name, case in cases.items():
        cfg, S = case["cfg"], case["S"]
        params = shard_params(from_jax_params(case["params"]),
                              model_decls(cfg, axes), axes)

        def engine():
            return ServeEngine(cfg, params, slots=case["slots"],
                               max_len=case["max_len"], axes=axes,
                               device=device, stubs=drawn_stubs)
        eng = engine()
        toks = torch.from_numpy(_rows(case["toks"], axes)).long()
        pre, (logits, fresh) = count_step(eng.prefill_fn, toks[:, :S],
                                          device=device)
        eng._splice(fresh, list(range(case["slots"])), S)
        pos = torch.full((toks.shape[0],), S, dtype=torch.long)
        dec, (dlogits, _) = count_step(eng.decode_fn, eng.cache,
                                       toks[:, S:S + 1], pos, device=device)
        res = {"prefill_logits": _np(logits), "decode_logits": _np(dlogits),
               "wire": {"prefill": pre.collective_wire_bytes,
                        "decode": dec.collective_wire_bytes}}

        eng = engine()
        eng.submit([Request(prompt=p.copy(),
                            max_new_tokens=case.get("new", 5))
                    for p in case["group"]])
        res["cache"] = {path: _np(t) for path, t in tree_leaves(eng.cache)}

        st = case["stream"]
        if st is None:
            out[name] = res
            continue
        eng = engine()
        reqs = [Request(prompt=p.copy(), max_new_tokens=st["new"],
                        arrival_s=a)
                for p, a in zip(st["prompts"], st["arrivals"])]
        replay(eng, reqs)
        res["streams"] = [list(r.out_tokens) for r in reqs]
        res["done"] = all(r.done for r in reqs)
        res["agreement"] = eng.telemetry()["agreement"]
        out[name] = res
    return out


def adopt_states(cfg, params, axes, device, prompts, S, slots, max_len,
                 new=4):
    """This rank's engine state after ``submit`` prefilled ``prompts``
    (one group, padded to ``S``) and after the fleet's prefill pool
    made their bundles (``PrefillPool._execute_group``) and a second
    engine adopted them in turn: ``{"group": state, "adopt": state,
    "wire": [each bundle's wire bytes]}``, a state being the cache
    leaves, ``pos``, ``last_tok``, the page table's stats, the active
    slots' request ids and every request's tokens so far."""
    from repro_torch.parallel.params import tree_leaves
    from repro_torch.planner.calibration import Calibration
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.fleet import PoolAccount, PrefillPool
    from repro_torch.serve.router import ServeConfig

    def requests():
        return [Request(prompt=p.copy(), max_new_tokens=new, req_id=i)
                for i, p in enumerate(prompts)]

    def engine():
        return ServeEngine(cfg, params, slots=slots, max_len=max_len,
                           axes=axes, device=device)

    def state(eng, reqs):
        return {"cache": {p: _np(t) for p, t in tree_leaves(eng.cache)},
                "dtypes": {p: str(t.dtype) for p, t in tree_leaves(eng.cache)},
                "pos": eng.pos.tolist(), "last_tok": eng.last_tok.tolist(),
                "pages": eng.pages.stats(),
                "active": [r.req_id if r is not None else None
                           for r in eng.active],
                "tokens": [list(r.out_tokens) for r in reqs]}
    a, ra = engine(), requests()
    a.submit(ra)
    sc = ServeConfig("chatglm3-6b", "tensor", axes.dp, axes.tp, slots,
                     max_len=max_len)
    pool = PrefillPool(sc, PoolAccount(sc, Calibration(), cfg=cfg),
                       executed=True, params=params, axes=axes,
                       device=device)
    b, rb = engine(), requests()
    wire = []
    for req, bundle, _ in pool._execute_group(S, rb):
        wire.append(bundle.wire_bytes)
        b.adopt(req, bundle.cache_rows, prefill_len=bundle.prefill_len,
                pos=bundle.pos, last_tok=bundle.last_tok)
    return {"group": state(a, ra), "adopt": state(b, rb), "wire": wire}


def fleet_body(axes, device, cases):
    """``tests/test_torch_fleet_executed.py`` on this rank, for each case
    (``{"cfg", "params"`` (the global numpy tree), ``"sc"`` (the pools'
    ``ServeConfig``), ``"trace"``, ``"adopt"`` (prompts and their
    bucket) or None``}``): ``adopt_states`` on the rank's shards; the
    executed fleet's greedy streams, measured wire bytes and the decode
    engine's agreement; a plain ``replay`` of the same trace through one
    engine on the mesh."""
    from repro_torch.models.model import model_decls
    from repro_torch.parallel.params import from_jax_params
    from repro_torch.planner.calibration import Calibration
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.fleet import (AutoscalePolicy, FleetConfig,
                                         FleetRouter)
    from repro_torch.serve.traffic import replay, trace_requests
    out = {}
    for name, case in cases.items():
        cfg, sc = case["cfg"], case["sc"]
        params = shard_params(from_jax_params(case["params"]),
                              model_decls(cfg, axes), axes)
        res = {}
        if case["adopt"]:
            prompts, S = case["adopt"]
            res["adopt"] = adopt_states(cfg, params, axes, device, prompts,
                                        S, sc.slots, sc.max_len)
        pol = AutoscalePolicy(min_replicas=1, max_replicas=1)
        fc = FleetConfig(prefill=sc, decode=sc, slo_ms=200.0, executed=True,
                         prefill_policy=pol, decode_policy=pol)
        router = FleetRouter(fc, calib=Calibration(), seed=0, axes=axes,
                             device=device, cfg=cfg, params=params)
        rep = router.run(case["trace"])
        res["fleet"] = {r.req_id: list(r.out_tokens) for r in router.finished}
        res["finished"] = rep["requests"]["finished"]
        res["wire"] = rep["transfer"]["measured"]["transfer_wire_bytes"]
        res["wire_ratio"] = rep["transfer"]["ratio_wire_bytes"]
        res["agreement"] = router.dec.replicas[0].engine.agreement
        eng = ServeEngine(cfg, params, slots=sc.slots, max_len=sc.max_len,
                          page_size=sc.page_size, axes=axes, device=device)
        reqs = trace_requests(case["trace"], cfg.vocab_size, seed=0)
        replay(eng, reqs)
        res["replay"] = {r.req_id: list(r.out_tokens) for r in reqs}
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# checkpoints, fault tolerance and elastic recovery
# ---------------------------------------------------------------------------

CKPT_ARCH = "stablelm-3b"
CKPT_BATCH, CKPT_SEQ = 8, 64


def _ckpt_trainer(axes, device, arch=CKPT_ARCH, opt_name="adamw"):
    """The smoke config of ``arch``, its optimizer, the port's train step
    on ``axes`` and this rank's shards of the seed-0 parameters."""
    from repro_torch.configs.base import get_config
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel.params import materialize_shards
    from repro_torch.train.trainer import make_train_step
    cfg = get_config(arch, smoke=True)
    opt = make_optimizer(opt_name, 1e-3)
    step_fn, decls, opt_decls = make_train_step(cfg, axes, opt,
                                                device=device)
    params = materialize_shards(decls, axes, 0, device)
    return cfg, opt, step_fn, decls, opt_decls, params


def _ckpt_run(cfg, axes, step_fn, params, state, start, stop):
    """Steps ``[start, stop)`` on the rank's rows of the seeded token
    batches; returns the state and the losses."""
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.train.trainer import local_rows
    ds = LMDataset(cfg.vocab_size, CKPT_BATCH, CKPT_SEQ + 1, device="cpu")
    losses = []
    for s in range(start, stop):
        params, state, m = step_fn(params, state, s,
                                   local_rows(ds(s), axes))
        losses.append(float(m["loss"]))
    return params, state, losses


def _barrier(axes):
    axes.world_comm.unrecorded().all_reduce(torch.zeros(1))


def checkpoint_body(axes, device, root):
    """``tests/test_torch_checkpoint.py`` on a dp 2 x tp 4 mesh: the
    reference's roundtrip, resume and corrupt-fallback cases, the saves
    that the dp 1 x tp 4 ranks restore (``checkpoint_other_mesh_body``)
    and Adafactor's per-rank moments restored on this mesh."""
    from repro_torch.train.checkpoint import CheckpointManager
    out = {}
    cfg, opt, step_fn, decls, opt_decls, params = _ckpt_trainer(axes,
                                                                device)
    layout = dict(decls=decls, opt_decls=opt_decls)

    # roundtrip of a state one step in (moments not zero), bitwise
    p, o, _ = _ckpt_run(cfg, axes, step_fn, params, opt.init(params), 0, 1)
    mgr = CheckpointManager(f"{root}/roundtrip", keep=2, axes=axes)
    mgr.save(7, p, o, **layout)
    st = mgr.restore(7, decls, opt_decls, axes, device)
    out["roundtrip"] = {
        "step": st.step, "io": mgr.io_stats(),
        "equal": all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_leaves({"p": p, "o": o}),
            tree_leaves({"p": st.params, "o": st.opt_state}))),
        "local": {"params": tree_map(_np, p), "opt": tree_map(_np, o)}}

    # 4 steps straight == 2, checkpoint, restore, 2
    params = _ckpt_trainer(axes, device)[5]
    _, _, straight = _ckpt_run(cfg, axes, step_fn, params,
                               opt.init(params), 0, 4)
    params = _ckpt_trainer(axes, device)[5]
    p, o, first = _ckpt_run(cfg, axes, step_fn, params, opt.init(params),
                            0, 2)
    mgr = CheckpointManager(f"{root}/resume", axes=axes)
    mgr.save(2, p, o, **layout)
    st = mgr.restore(2, decls, opt_decls, axes, device)
    _, _, rest = _ckpt_run(cfg, axes, step_fn, st.params, st.opt_state, 2,
                           4)
    out["resume"] = {"straight": straight, "resumed": first + rest}

    # corrupt the newer of two checkpoints: restore_latest falls back
    mgr = CheckpointManager(f"{root}/corrupt", keep=5, axes=axes)
    mgr.save(1, params, opt.init(params), **layout)
    mgr.save(2, params, opt.init(params), **layout)
    _barrier(axes)
    if axes.rank == 0:
        with open(f"{root}/corrupt/step_0000000002/leaf_00000.npy",
                  "wb") as f:
            f.write(b"garbage")
    _barrier(axes)
    st = mgr.restore_latest(decls, opt_decls, axes, device)
    out["corrupt_fallback_step"] = None if st is None else st.step

    # three steps, saved at 3 for the dp 1 x tp 4 ranks, then step 3 here
    params = _ckpt_trainer(axes, device)[5]
    p, o, _ = _ckpt_run(cfg, axes, step_fn, params, opt.init(params), 0, 3)
    CheckpointManager(f"{root}/other", axes=axes).save(3, p, o, **layout)
    out["other_mesh_step3"] = _ckpt_run(cfg, axes, step_fn, p, o, 3, 4)[2]

    # Adafactor's moments saved per rank: this mesh restores them exactly
    acfg, aopt, astep, adecls, aodecls, ap = _ckpt_trainer(
        axes, device, opt_name="adafactor")
    p, o, _ = _ckpt_run(acfg, axes, astep, ap, aopt.init(ap), 0, 1)
    mgr = CheckpointManager(f"{root}/adafactor", axes=axes)
    mgr.save(1, p, o, decls=adecls, opt_decls=aodecls,
             per_rank=aopt.per_rank_state)
    st = mgr.restore(1, adecls, aodecls, axes, device)
    out["adafactor_same_mesh"] = all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_leaves(o), tree_leaves(st.opt_state)))
    return out


def checkpoint_other_mesh_body(axes, device, root):
    """The dp 1 x tp 4 side: restore dp 2 x tp 4's step-3 checkpoint and
    run step 3; restoring Adafactor's per-rank moments raises."""
    from repro_torch.train.checkpoint import CheckpointManager
    cfg, opt, step_fn, decls, opt_decls, _ = _ckpt_trainer(axes, device)
    st = CheckpointManager(f"{root}/other", axes=axes).restore(
        3, decls, opt_decls, axes, device)
    out = {"step3": _ckpt_run(cfg, axes, step_fn, st.params, st.opt_state,
                              3, 4)[2]}
    _, _, _, adecls, aodecls, _ = _ckpt_trainer(axes, device,
                                                opt_name="adafactor")
    try:
        CheckpointManager(f"{root}/adafactor", axes=axes).restore(
            1, adecls, aodecls, axes, device)
        out["adafactor_error"] = None
    except ValueError as e:
        out["adafactor_error"] = str(e)
    return out


def kill_restore_body(axes, device, job):
    """``tests/test_torch_fault.py``'s end-to-end case on phi3-mini-smoke:
    ``job["part"] == 1`` runs 4 steps straight and, from the same draw,
    2 steps saved at step 2; part 2 (a new world, after the fault)
    restores the latest checkpoint and runs steps 2 and 3."""
    from repro_torch.train.checkpoint import CheckpointManager
    cfg, opt, step_fn, decls, opt_decls, params = _ckpt_trainer(
        axes, device, arch="phi3-mini-3.8b")
    mgr = CheckpointManager(job["dir"], axes=axes)
    if job["part"] == 1:
        _, _, straight = _ckpt_run(cfg, axes, step_fn, params,
                                   opt.init(params), 0, 4)
        params = _ckpt_trainer(axes, device, arch="phi3-mini-3.8b")[5]
        p, o, _ = _ckpt_run(cfg, axes, step_fn, params, opt.init(params),
                            0, 2)
        mgr.save(2, p, o, decls=decls, opt_decls=opt_decls)
        return {"straight": straight}
    st = mgr.restore_latest(decls, opt_decls, axes, device)
    return {"step": st.step,
            "resumed": _ckpt_run(cfg, axes, step_fn, st.params,
                                 st.opt_state, st.step, 4)[2]}


def _ffn_plan_step(case, axes):
    from repro_torch.core.ffn import make_ffn_train_step
    from repro_torch.optim import AdamW
    from repro_torch.planner.space import PlanCandidate
    plan = PlanCandidate(**case["plan"])
    opt = AdamW(3e-3, weight_decay=0.0)
    return (plan, opt) + make_ffn_train_step(plan.model_config(), axes, opt,
                                             plan.batch)


def _ffn_run(step_fn, params, state, ds, axes, start, stop):
    from repro_torch.core.ffn import local_batch
    losses = []
    for s in range(start, stop):
        x, y = ds(s)
        params, state, loss = step_fn(params, state, s, local_batch(x, axes),
                                      local_batch(y, axes))
        losses.append(float(loss))
    return params, state, losses


def recovery_body(axes, device, cases):
    """The recovery-equivalence oracle of
    ``tests/test_elastic_hypothesis.py`` on this world: each case's mesh
    built on it (``launch/mesh.py: make_local_mesh``).  Side ``"A"``:
    the run straight to ``total`` and, from the same draw, to ``kill``,
    saved there; side ``"B"``: the converted host tree placed on the
    case's mesh and run from ``kill`` to ``total``.  ``"mixed"``: mixed
    per-stage strategies killed and restored on the same mesh."""
    from repro_torch.core.ffn import init_ffn
    from repro_torch.data.synthetic import TeacherDataset
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.elastic import place_host_tree
    out = {}
    for name, case in cases.items():
        mesh = make_local_mesh(case["dp"], case["tp"], case["pp"])
        ds = TeacherDataset(case["width"], case["batch"], seed=case["seed"])
        if case["side"] == "mixed":
            from repro_torch.optim import AdamW
            from repro_torch.core.ffn import make_ffn_train_step
            cfg = port_pipeline_cfg("mixed", k=2, M=2, stages=2,
                                    n=case["width"])
            opt = AdamW(3e-3, weight_decay=0.0)
            step_fn, decls, odecls = make_ffn_train_step(cfg, mesh, opt,
                                                         case["batch"])
            p, o = init_ffn(cfg, mesh, opt, seed=3, device=device)
            _, _, ref = _ffn_run(step_fn, p, o, ds, mesh, 0, 6)
            p, o = init_ffn(cfg, mesh, opt, seed=3, device=device)
            p, o, _ = _ffn_run(step_fn, p, o, ds, mesh, 0, 3)
            mgr = CheckpointManager(case["dir"], axes=mesh)
            mgr.save(3, p, o, decls=decls, opt_decls=odecls)
            st = mgr.restore(3, decls, odecls, mesh, device)
            _, _, post = _ffn_run(step_fn, st.params, st.opt_state, ds,
                                  mesh, 3, 6)
            out[name] = {"ref": ref, "post": post}
            continue
        plan, opt, step_fn, decls, odecls = _ffn_plan_step(case, mesh)
        if case["side"] == "A":
            p, o = init_ffn(plan.model_config(), mesh, opt,
                            seed=case["seed"], device=device)
            _, _, ref = _ffn_run(step_fn, p, o, ds, mesh, 0, case["total"])
            p, o = init_ffn(plan.model_config(), mesh, opt,
                            seed=case["seed"], device=device)
            p, o, pre = _ffn_run(step_fn, p, o, ds, mesh, 0, case["kill"])
            CheckpointManager(case["dir"], axes=mesh).save(
                case["kill"], p, o, meta={"plan": plan.as_dict()},
                decls=decls, opt_decls=odecls)
            out[name] = {"ref": ref, "pre": pre}
        else:
            p = place_host_tree(case["params"], decls, mesh, device)
            o = place_host_tree(case["opt"], odecls, mesh, device)
            out[name] = {"post": _ffn_run(step_fn, p, o, ds, mesh,
                                          case["kill"], case["total"])[2]}
    return out


def slow_write_elastic_rank(axes, device, job):
    """``train/elastic.py: _elastic_rank`` with every checkpoint write
    slowed by 0.25 s: a save is still in flight when the phase ends."""
    import time as _time
    from repro_torch.train import elastic
    from repro_torch.train.checkpoint import CheckpointManager
    orig = CheckpointManager._write

    def slow_write(self, step, host, meta):
        _time.sleep(0.25)
        orig(self, step, host, meta)

    CheckpointManager._write = slow_write
    return elastic._elastic_rank(axes, device, job)


def install_pilot_draws(axes, device, draws):
    """Make this rank's later pilots (``train/trainer.py:
    pilot_ffn_run``, jobs of the same ``RankPool``) start from the
    reference's draws: ``core/ffn.py: init_ffn`` places
    ``draws["params"][cfg.name]`` (global numpy trees) cut for the
    rank's mesh, and ``data/synthetic.py: TeacherDataset`` serves
    ``draws["batches"][step]`` (global numpy ``(x, y)``).  The patch
    lasts as long as the rank's process."""
    from repro_torch.core import ffn
    from repro_torch.data import synthetic
    from repro_torch.train.elastic import place_host_tree

    def init_ffn(cfg, axes, optimizer, seed=0, device=None):
        params = place_host_tree(draws["params"][cfg.name],
                                 ffn.ffn_decls(cfg, axes), axes, device)
        return params, optimizer.init(params)

    class TeacherDataset:
        def __init__(self, n, batch, seed=0, device=None):
            self.device = device

        def __call__(self, step):
            return tuple(torch.from_numpy(a).to(self.device)
                         for a in draws["batches"][step])

    ffn.init_ffn = init_ffn
    synthetic.TeacherDataset = TeacherDataset
    return axes.rank


class VirtualStepClock:
    """A step clock (``train/trainer.py: metered_seconds``'s signature)
    under which every step takes ``dt`` virtual seconds plus the delay
    injected into it: a slow step of ``slow_factor`` then takes
    ``slow_factor`` times the others, whatever the host's load."""

    def __init__(self, dt: float = 0.01):
        self.dt = dt

    def __call__(self, step: int, metered_s: float,
                 injected_s: float) -> float:
        return self.dt + injected_s


def obs_trainer_body(axes, device, root, steps):
    """``launch/train.py``'s trainer of phi3-smoke (float32, batch 4 x
    seq 32) for ``steps`` steps on this rank, a checkpoint after each
    step under ``root``, and a watchdog whose prediction (1 us) every
    step exceeds: rank 0's first step trips it and every rank captures
    the next step under ``root/prof``.  Returns the rank, its watchdog's
    trips and captures."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.obs import EnergyDriftWatchdog
    from repro_torch.optim import AdamW
    from repro_torch.train.trainer import Trainer

    cfg = get_config("phi3-mini-3.8b", smoke=True, dtype="float32")
    wd = EnergyDriftWatchdog(predicted_s=1e-6, profile_dir=f"{root}/prof",
                             name="train_phi3-smoke")
    trainer = Trainer(cfg, axes, AdamW(1e-3), LMDataset(
        cfg.vocab_size, 4, 33, device=device), checkpoint_dir=f"{root}/ck",
        checkpoint_every=1, log_fn=lambda _m: None, watchdog=wd,
        step_clock=VirtualStepClock(), device=device)
    trainer.run(trainer.init_state(0), steps)
    return {"rank": axes.rank, "trips": [t.as_dict() for t in wd.trips],
            "captures": list(wd.captures)}
