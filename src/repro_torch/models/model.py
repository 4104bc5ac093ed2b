"""Model assembly for every LM family of the reference (dense, MoE, SSM,
hybrid, vision-language and encoder-decoder): decls, and the training,
prefill and decode forwards.

Parameters are the reference's tree (layers stacked on axis 0; on a
pipe axis ``[pp, G/pp, ...]``, each stage's slice of the stack); the
forward passes loop over the stack in Python where the reference scans.
A plan that repeats one block (period 1) stacks its layers under
``layers``; a hybrid plan (jamba) stacks superblocks, ``{"sub0": ...,
f"sub{per - 1}": ...}`` over ``num_layers // per`` groups, each sub one
block of the period (``models/blocks.py: plan_period``).
The training forwards also take ``params["layers"]`` as a list of
per-group trees (``train/trainer.py`` makes each group's slice a leaf
of its own).  The residual stream keeps the reference's layout
(``models/layers.py: residual_layout``): feature-sharded where a site is
phantom, sequence-sharded otherwise.  Training runs at any pp x dp x tp
(``forward_train_pipeline`` at pp > 1); prefill and decode (serving) of
every family at any dp x tp whose model axis divides the heads the
layers shard (``require_serving_mesh``).  At tp > 1 the attention's
decode cache is sequence-sharded, each rank holding ``max_len / tp``
positions of every row of its dp shard, and the SSD state is cut over
its channels and heads (``rank_cache_decls``).  An MoE block adds its
balance loss to the training forward's ``aux`` (the reference's scan
carry).  The decode cache holds, per
layer, the attention's K/V or the SSD state ``{"conv", "ssm"}`` (no
sequence dim); a hybrid's, the same per sub.
Under FSDP (``cfg.fsdp``) the embedding and the head gather their
dp-sharded dims where they are used, and each block its own
(``models/blocks.py``).

The vision-language family (qwen2-vl) is a dense stack whose batch also
carries the stubbed vision frontend's patch embeddings
(``vision_embeds`` ``[B, n_img, d]``, spliced over the first ``n_img``
positions of the embedded stream: ``_embed``) and M-RoPE's position ids
(``positions`` ``[3, B, S]``: ``_positions``).  The encoder-decoder
family (seamless) holds two stacks, ``enc_layers`` and ``dec_layers``,
and ``enc_final_norm``: the encoder runs non-causal blocks over the
batch's ``frames`` ``[B, S_enc, d]``, its output is gathered to full
features on every rank (the ``memory``), and each decoder block
cross-attends to it; its decode cache is ``{"self": ..., "cross":
...}``, each ``{k, v}`` over the decoder's layers.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.autograd import psum
from repro_torch.models.attention import resolve_attn_mode
from repro_torch.models.blocks import (block_apply, block_decls,
                                       block_train, layer_plan, plan_period,
                                       superblock_train)
from repro_torch.models.layers import (dtype_of, embed_apply, embed_decls,
                                       head_decls, head_logits, norm_apply,
                                       norm_decls, residual_layout, to_full,
                                       xent_loss)
from repro_torch.models.ssm import ssm_cache_shape, ssm_dims
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import (TensorSpec, param_count, stack,
                                         tree_leaves, tree_map,
                                         tree_unflatten)
from repro_torch.train.pipeline import (pipeline_run,
                                        split_batch_microbatches)


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")
VISION_TOKENS = 256
# the parameter trees' stacks of layers (or superblocks)
STACKS = ("layers", "enc_layers", "dec_layers")


def n_vision_tokens(cfg, seq_len: int) -> int:
    """Positions of a sequence that the vision stub's embeddings take."""
    return min(VISION_TOKENS, seq_len // 4)


def _plan(cfg: ModelConfig):
    """The (mixer, ffn) of each block of the repeating period: one block
    ("attn" with "mlp" or "moe", or "mamba" with None) for the families
    that repeat one, the superblock's subs for a hybrid plan."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} has no LM stack; the LM families are "
            f"{PORTED_FAMILIES}")
    return layer_plan(cfg)[:plan_period(cfg)]


def n_groups(cfg: ModelConfig) -> int:
    """Entries of the layer stack: layers, or a hybrid's superblocks."""
    return cfg.num_layers // plan_period(cfg)


def _subs(plan, group):
    """(params or cache of each block, mixer, ffn) of one entry of the
    stack: the entry itself at period 1, else its subs in plan order."""
    if len(plan) == 1:
        return [(group, *plan[0])]
    return [(group[f"sub{i}"], mx, ff) for i, (mx, ff) in enumerate(plan)]


def _group_decls(cfg: ModelConfig, axes: MeshAxes, layout: str, plan):
    if len(plan) == 1:
        return block_decls(cfg, axes, layout, plan[0][1], plan[0][0])
    return {f"sub{i}": block_decls(cfg, axes, layout, ff, mx)
            for i, (mx, ff) in enumerate(plan)}


def model_decls(cfg: ModelConfig, axes: MeshAxes):
    plan = _plan(cfg)
    layout = residual_layout(cfg, "train")
    d = {"embed": embed_decls(cfg),
         "final_norm": norm_decls(cfg, layout, cfg.d_model),
         "head": head_decls(cfg)}
    if cfg.family == "encdec":
        if axes.pp > 1:
            raise NotImplementedError(
                "pipeline parallelism does not cover encoder-decoder "
                "stacks (two heterogeneous stacks), as in the reference")
        d["enc_layers"] = stack(block_decls(cfg, axes, layout, "mlp"),
                                cfg.encoder_layers)
        d["dec_layers"] = stack(block_decls(cfg, axes, layout, "mlp",
                                            cross=True), cfg.num_layers)
        d["enc_final_norm"] = norm_decls(cfg, layout, cfg.d_model)
    else:
        d["layers"] = stack(_group_decls(cfg, axes, layout, plan),
                            n_groups(cfg))
        if axes.pp > 1:
            d["layers"] = _pp_shard_layer_decls(d["layers"], axes.pp)
    pdt = dtype_of(cfg.param_dtype)
    if pdt != torch.float32:
        d = tree_map(lambda x: dataclasses.replace(x, dtype=pdt), d)
    return d


def _pp_shard_layer_decls(layers, pp: int):
    """[G, ...] stacked layer (or superblock) decls -> [pp, G/pp, ...],
    the stage axis sharded over the pipe axis: each stage holds its
    contiguous slice of the groups.  The reshape keeps the layer order
    and ``materialize`` draws the same values for either shape, so a seed
    gives the same model at any pp."""
    def reshape(d):
        G = d.shape[0]
        if G % pp:
            raise ValueError(f"{G} layer groups do not divide into {pp} "
                             f"pipeline stages")
        return dataclasses.replace(d, shape=(pp, G // pp) + d.shape[1:],
                                   spec=("pp",) + tuple(d.spec))
    return tree_map(reshape, layers)


def require_serving_mesh(cfg: ModelConfig, axes: MeshAxes, what: str):
    """Serving at tp > 1 cuts what training cuts, and the decode cache
    over the model axis: every family serves on any dp x tp mesh whose
    model axis divides the heads that the layers shard, the attention's
    query heads in head mode (ring mode keeps every head on every rank)
    and the SSD heads.  Raises ValueError, before any rank computes,
    where it does not."""
    if axes.tp == 1:
        return
    mixers = {mx for mx, _ in _plan(cfg)}
    bad = []
    if ("attn" in mixers and resolve_attn_mode(cfg, axes) == "head"
            and cfg.num_heads % axes.tp):
        bad.append(f"{cfg.num_heads} attention heads (head mode)")
    if "mamba" in mixers and ssm_dims(cfg)[1] % axes.tp:
        bad.append(f"{ssm_dims(cfg)[1]} SSD heads")
    if bad:
        raise ValueError(f"{what} of {cfg.name} at tp={axes.tp}: "
                         f"{' and '.join(bad)} do not divide over the "
                         f"model axis")


def count_params(cfg: ModelConfig, tp: int = 1,
                 active_only: bool = False) -> int:
    """Parameters of the decls at ``tp``; ``active_only`` leaves out the
    experts a token does not reach (all but top_k of E, on every MoE
    layer of the plan), as the reference counts them."""
    total = param_count(model_decls(cfg, MeshAxes(tp=tp)))
    if active_only and cfg.moe is not None:
        m = cfg.moe
        n_moe = sum(1 for _, ffn in layer_plan(cfg) if ffn == "moe")
        per_layer = m.num_experts * cfg.d_model * m.d_ff_expert * 3
        total -= int(per_layer * (1 - m.top_k / m.num_experts) * n_moe)
    return total


# the SSD block's leaves that the reference computes in float32 (its
# norm scale among the "norm" leaves): the conv taps, the decay, the
# skip, dt's bias
_SSM_FP32 = ("mixer/conv_w", "mixer/A_log", "mixer/Dskip", "mixer/wdt/b")


def serving_params(cfg: ModelConfig, params, device=None):
    """Move params to ``device`` and cast, once, every leaf that the
    reference casts to the compute dtype on each call: all but the norm
    scales, the logit head, the MoE routers and the SSD block's float32
    leaves, which it computes in float32 (a router rounded to bf16 would
    pick other experts).  The numbers are identical, and the card holds
    the projection weights in bf16 instead of fp32 (12.5 GB instead of
    25 GB for chatglm3-6b)."""
    dt = dtype_of(cfg.dtype)
    flat = {}
    for path, t in tree_leaves(params):
        keep_fp32 = (path.startswith("head/") or "norm" in path
                     or path.endswith("ffn/router/w")
                     or path.endswith(_SSM_FP32))
        flat[path] = t.to(device=device,
                          dtype=t.dtype if keep_fp32 else dt)
    return tree_unflatten(params, flat)


def _layer(params, i: int, pp: int = 1, key: str = "layers"):
    """Entry ``i`` (a layer, or a hybrid's superblock) of this rank's
    stack ``key`` (one of ``STACKS``): an entry of the trainer's list of
    per-group trees, or a slice of the stacked tensors, ``[G, ...]`` or,
    pipe-sharded at ``pp`` > 1, the stage's local ``[1, G/pp, ...]``."""
    layers = params[key]
    if isinstance(layers, list):
        return layers[i]
    if pp > 1:
        return tree_map(lambda t: t[0, i], layers)
    return tree_map(lambda t: t[i], layers)


def _group_train(cfg, layout, group, h, positions, axes, plan):
    """One entry of the stack in the training forward -> (h, aux or
    None): a block, or a superblock as one recompute unit."""
    if len(plan) == 1:
        return block_train(cfg, layout, group, h, positions, axes,
                           plan[0][1], plan[0][0])
    return superblock_train(cfg, layout, group, h, positions, axes, plan)


def _embed(cfg, layout, params, batch, axes: MeshAxes):
    """The embedded tokens in ``layout``, with the vision stub's
    ``vision_embeds`` [B, n_img, d] spliced over the first ``n_img``
    positions where the config has the vision frontend and the batch
    carries them: in ``fp`` each rank takes its feature slice of them, in
    ``sp`` each rank's chunk selects them by global position, in ``rep``
    (and at tp = 1) they are concatenated with the rest."""
    h = embed_apply(cfg, layout, params["embed"], batch["tokens"], axes)
    if cfg.frontend != "vision" or "vision_embeds" not in batch:
        return h
    v = batch["vision_embeds"].to(h.dtype)
    n_img = v.shape[1]
    j = axes.tp_rank
    if layout == "sp":
        C = h.shape[1]
        at = j * C + torch.arange(C, device=h.device)
        rows = v[:, at.clamp(max=n_img - 1)]
        return torch.where((at < n_img)[None, :, None], rows, h)
    if layout == "fp":
        fsh = h.shape[-1]
        v = v[..., j * fsh:(j + 1) * fsh]
    return torch.cat([v, h[:, n_img:]], 1)


def _positions(cfg, batch, B: int, S: int, device):
    """M-RoPE's ``[3, B, S]`` position ids from the batch, else
    ``arange(S)`` over the rows."""
    if cfg.rope == "mrope":
        return batch["positions"]
    return torch.arange(S, device=device).expand(B, S)


def forward_train(cfg: ModelConfig, axes: MeshAxes, params, batch):
    """batch {"tokens", "labels"}: [B, S] (and the family's stubs:
    ``vision_embeds`` and ``positions``, or ``frames``) -> (sum_loss,
    n_valid, aux), this rank's contributions before the sums over dp (the
    model axis is reduced inside the loss); aux is the MoE layers' summed
    balance loss (0 for the other families).  Each block, or a hybrid's
    superblock, runs under the recompute policy of ``cfg.remat``
    (``block_train``, ``superblock_train``)."""
    if cfg.family == "encdec":
        return _encdec_forward_train(cfg, axes, params, batch)
    plan = _plan(cfg)
    layout = residual_layout(cfg, "train")
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = _embed(cfg, layout, params, batch, axes)
    positions = _positions(cfg, batch, B, S, tokens.device)
    aux = torch.zeros((), device=h.device)
    for i in range(n_groups(cfg)):
        h, a = _group_train(cfg, layout, _layer(params, i), h, positions,
                            axes, plan)
        if a is not None:
            aux = aux + a
    h = norm_apply(cfg, layout, params["final_norm"], h, axes)
    sum_loss, n_valid = xent_loss(cfg, layout, params["head"], h,
                                  batch["labels"], axes)
    return sum_loss, n_valid, aux


def forward_train_pipeline(cfg: ModelConfig, axes: MeshAxes, params, batch,
                           microbatches: int, objective,
                           aux_weight: float = 0.0):
    """The training pass of this rank's pipeline stage, forward AND
    backward: the port's ``pipeline_run`` interleaves the two in the 1F1B
    order, where the reference differentiates its wavefront afterwards.

    Stage 0 embeds every microbatch up front and back-propagates the
    engine's input gradient into the embedding; each stage runs its own
    ``G/pp`` layers (``block_train``: the recompute policy of
    ``cfg.remat``); the last stage applies the final norm, the head and
    the loss, and back-propagates ``objective(sum_loss_i)``, microbatch
    ``i``'s share of the objective (a scalar), from its summed token
    loss.  Each stage also back-propagates ``aux_weight`` times the
    balance loss of its own MoE layers on each microbatch (the
    reference's ``AUX_LOSS_WEIGHT / (dp M tp)``).  The stream crosses
    stage boundaries in its layout's local shape, in the compute dtype.
    The parameters' ``.grad`` accumulate over the microbatches.

    Returns (sum_loss, aux): the summed token loss of the rank's
    microbatches on the last stage, 0 on the others, and the balance
    loss of the stage's layers summed over the microbatches (0 for the
    dense family).  The caller counts the valid tokens from the labels
    before the schedule starts: the objective divides by the global
    count before the first backward."""
    plan = _plan(cfg)
    if cfg.family == "encdec":
        raise NotImplementedError("no pipeline path for encdec stacks, as "
                                  "in the reference")
    if cfg.rope == "mrope":
        raise NotImplementedError(
            "mrope positions vary per microbatch; the pipeline carries "
            "activations only")
    layout = residual_layout(cfg, "train")
    M = max(microbatches, 1)
    mb = split_batch_microbatches(batch, M)
    tokens, labels = mb["tokens"], mb["labels"]           # [M, B/M, S]
    _, B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    first, last = axes.pp_rank == 0, axes.pp_rank == axes.pp - 1

    auxes = []

    def stage_fn(h):
        aux = None
        for i in range(n_groups(cfg) // axes.pp):
            h, a = _group_train(cfg, layout, _layer(params, i, axes.pp), h,
                                positions, axes, plan)
            if a is not None:
                aux = a if aux is None else aux + a
        if aux is None:
            return h
        auxes.append(aux.detach())
        return h, aux_weight * aux

    sums = []

    def loss_fn(h, i):
        h = norm_apply(cfg, layout, params["final_norm"], h, axes)
        sl, _ = xent_loss(cfg, layout, params["head"], h, labels[i], axes)
        sums.append(sl.detach())
        return objective(sl)

    if first:
        h0 = torch.stack([embed_apply(cfg, layout, params["embed"],
                                      tokens[i], axes) for i in range(M)])
        x_mb = h0.detach()
    else:    # only the shape and dtype of a stage input are read: the
        # stream's local shard, feature- (fp) or sequence-sharded (sp)
        shape = ((B, S, cfg.d_model // axes.tp) if layout == "fp"
                 else (B, S // axes.tp, cfg.d_model))
        x_mb = torch.empty(shape, dtype=dtype_of(cfg.dtype),
                           device=tokens.device).expand(M, -1, -1, -1)
    _, x_grad = pipeline_run(stage_fn, x_mb, axes, loss_fn,
                             input_grad=first)
    if first:
        torch.autograd.backward(h0, x_grad)
    sum_loss = torch.zeros((), device=tokens.device)
    for sl in sums:
        sum_loss = sum_loss + sl
    aux = torch.zeros((), device=tokens.device)
    for a in auxes:
        aux = aux + a
    return sum_loss, aux


def _stack_caches(caches):
    """Per-group caches (a block's ``{name: [B, ...]}``, or a superblock's
    ``{sub: {name: ...}}``) -> one tree of ``[G, B, ...]`` stacks."""
    first = caches[0]
    return {k: (_stack_caches([c[k] for c in caches])
                if isinstance(first[k], dict)
                else torch.stack([c[k] for c in caches])) for k in first}


def forward_prefill(cfg: ModelConfig, axes: MeshAxes, params, batch):
    """batch {"tokens": [B, S]} (and the family's stubs) -> (last-token
    logits [B, 1, V_pad] fp32, cache: {"k", "v"} [L, B, S, kv, hd], or
    for the SSM family {"conv" [L, B, cw - 1, d_inner], "ssm"
    [L, B, H, hd, N]}; a hybrid's, one such tree per sub, ``[G, ...]``
    over its superblocks; an encoder-decoder's ``{"self": {k, v},
    "cross": {k, v}}``, the cross K/V over the encoder's length)."""
    if cfg.family == "encdec":
        return _encdec_forward_prefill(cfg, axes, params, batch)
    plan = _plan(cfg)
    require_serving_mesh(cfg, axes, "prefill")
    layout = residual_layout(cfg, "prefill")
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = _embed(cfg, layout, params, batch, axes)
    positions = _positions(cfg, batch, B, S, tokens.device)
    caches = []
    for i in range(n_groups(cfg)):
        group = []
        for lp, mixer, ffn in _subs(plan, _layer(params, i)):
            h, c, _ = block_apply(cfg, layout, lp, h, positions, axes,
                                  kind="prefill", ffn=ffn, mixer=mixer,
                                  return_kv=True)
            group.append(c)
        caches.append(group[0] if len(plan) == 1 else
                      {f"sub{j}": c for j, c in enumerate(group)})
    h = norm_apply(cfg, layout, params["final_norm"], h, axes)
    logits = head_logits(cfg, layout, params["head"],
                         _last_position(h, layout, axes), axes)
    return logits, _stack_caches(caches)


def _last_position(h, layout: str, axes: MeshAxes):
    """The stream's last position [B, 1, d-shard]; in ``sp`` only the
    last rank's chunk holds it, and one psum of the ranks' last rows,
    the others zeroed, gives it to every rank (the reference's)."""
    if layout != "sp" or axes.tp == 1:
        return h[:, -1:, :]
    mine = 1.0 if axes.tp_rank == axes.tp - 1 else 0.0
    return psum(h[:, -1:, :] * mine, axes)


def forward_decode(cfg: ModelConfig, axes: MeshAxes, params, cache,
                   tokens, pos):
    """tokens [B, 1]; pos [B] per-row positions (the SSD blocks read
    none).  Writes the new K/V rows, or the new SSD state, into
    ``cache`` in place; returns (logits [B, 1, V_pad], cache)."""
    if cfg.family == "encdec":
        return _encdec_forward_decode(cfg, axes, params, cache, tokens, pos)
    plan = _plan(cfg)
    require_serving_mesh(cfg, axes, "decode")
    layout = residual_layout(cfg, "decode")
    h = embed_apply(cfg, layout, params["embed"], tokens, axes)
    for i in range(n_groups(cfg)):
        for (lp, mixer, ffn), (c, _, _) in zip(
                _subs(plan, _layer(params, i)), _subs(plan, cache)):
            layer_cache = {name: t[i] for name, t in c.items()}
            h, new, _ = block_apply(cfg, layout, lp, h, None, axes,
                                    kind="decode", ffn=ffn, mixer=mixer,
                                    cache=layer_cache, pos=pos)
            if mixer == "mamba":
                for name, t in c.items():
                    t[i] = new[name]
    h = norm_apply(cfg, layout, params["final_norm"], h, axes)
    return head_logits(cfg, layout, params["head"], h, axes), cache


def cache_decls(cfg: ModelConfig, axes: MeshAxes, batch: int,
                max_len: int):
    """Global shapes of the decode cache, stacked like the params: per
    attention block its bf16 K/V ``[G, batch, max_len, kv, hd]``, per SSD
    block its state (the conv rows in bf16, the state in fp32, bf16 under
    ``kv_cache_quant``); a hybrid's, one such tree per sub; an
    encoder-decoder's ``{"self": ..., "cross": ...}`` over its decoder
    layers, the cross K/V ``max_len`` rows long too, as the reference's
    engine sizes them."""
    plan = _plan(cfg)
    G = n_groups(cfg)
    if cfg.family == "encdec":
        shape = (G, batch, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim())
        return {name: {t: TensorSpec(shape, torch.bfloat16)
                       for t in ("k", "v")} for name in ("self", "cross")}

    def one(mixer):
        if mixer == "mamba":
            shapes = ssm_cache_shape(cfg, axes, batch)
            sdt = torch.bfloat16 if cfg.kv_cache_quant else torch.float32
            return {"conv": TensorSpec((G,) + shapes["conv"][0],
                                       torch.bfloat16),
                    "ssm": TensorSpec((G,) + shapes["ssm"][0], sdt)}
        shape = (G, batch, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim())
        return {"k": TensorSpec(shape, torch.bfloat16),
                "v": TensorSpec(shape, torch.bfloat16)}
    if len(plan) == 1:
        return one(plan[0][0])
    return {f"sub{i}": one(mx) for i, (mx, _) in enumerate(plan)}


def rank_cache_decls(cfg: ModelConfig, axes: MeshAxes, batch: int,
                     max_len: int):
    """This rank's shard of ``cache_decls``, each leaf cut along the dims
    its global spec names, as the reference's cache specs cut them: the
    batch dim over dp (``batch / dp`` rows) and, at tp > 1, over the
    model axis the attention K/V's sequence dim (``max_len / tp``
    positions, rank j holding ``[j max_len / tp, (j + 1) max_len /
    tp)``, ``P(dp, "tp", None, None)``), the SSD conv rows' channels and
    the SSD state's heads (``ssm_cache_shape``: ``("dp", None, "tp")``
    and ``("dp", "tp", None, None)``), the rank's own channels and heads
    of the block."""
    if batch % axes.dp or max_len % axes.tp:
        raise ValueError(f"a cache of {batch} rows x {max_len} positions "
                         f"does not shard over dp={axes.dp} x "
                         f"tp={axes.tp}")
    require_serving_mesh(cfg, axes, "the decode cache")
    specs = {"k": ("dp", "tp", None, None), "v": ("dp", "tp", None, None)}
    if "mamba" in {mx for mx, _ in _plan(cfg)}:
        specs.update({name: spec for name, (_, spec)
                      in ssm_cache_shape(cfg, axes, batch).items()})
    size = {"dp": axes.dp, "tp": axes.tp, None: 1}

    def cut(path, t):
        # dim 0 stacks the layers; the spec names the dims after it
        spec = (None,) + specs[path.split("/")[-1]]
        return TensorSpec(tuple(n // size[a] for n, a in zip(t.shape, spec)),
                          t.dtype)
    glob = cache_decls(cfg, axes, batch, max_len)
    return tree_unflatten(glob, {path: cut(path, t) for path, t
                                 in tree_leaves(glob)})


# ---------------------------------------------------------------------------
# the encoder-decoder family
# ---------------------------------------------------------------------------

def _enc_stack(cfg, layout, params, axes: MeshAxes, frames, kind="train"):
    """frames [B, S_enc, d] (the same on every rank) -> the memory: the
    encoder's output gathered to full features [B, S_enc, d] on every
    rank.  The frames are cut into ``layout`` (each rank's
    features in ``fp``, its sequence chunk otherwise) and run through the
    non-causal encoder blocks, each a recompute unit in training under
    ``remat="full"`` (the reference runs them as training blocks in
    prefill too, without the recompute)."""
    p, j = axes.tp, axes.tp_rank
    if layout == "fp":
        fsh = frames.shape[-1] // p
        h = frames[..., j * fsh:(j + 1) * fsh]
    else:
        C = frames.shape[1] // p
        h = frames[:, j * C:(j + 1) * C]
    h = h.to(dtype_of(cfg.dtype))
    B, S = frames.shape[0], frames.shape[1]
    positions = _positions(cfg, {}, B, S, frames.device)
    for i in range(cfg.encoder_layers):
        lp = _layer(params, i, key="enc_layers")
        if kind == "train":
            h, _ = block_train(cfg, layout, lp, h, positions, axes, "mlp",
                               causal=False)
        else:
            h, _, _ = block_apply(cfg, layout, lp, h, positions, axes,
                                  kind="train", ffn="mlp", causal=False)
    h = norm_apply(cfg, layout, params["enc_final_norm"], h, axes)
    return to_full(h, layout, axes)


def _encdec_forward_train(cfg, axes: MeshAxes, params, batch):
    layout = residual_layout(cfg, "train")
    memory = _enc_stack(cfg, layout, params, axes, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = embed_apply(cfg, layout, params["embed"], tokens, axes)
    positions = _positions(cfg, batch, B, S, tokens.device)
    for i in range(cfg.num_layers):
        h, _ = block_train(cfg, layout, _layer(params, i, key="dec_layers"),
                           h, positions, axes, "mlp", memory=memory)
    h = norm_apply(cfg, layout, params["final_norm"], h, axes)
    sum_loss, n_valid = xent_loss(cfg, layout, params["head"], h,
                                  batch["labels"], axes)
    return sum_loss, n_valid, torch.zeros((), device=h.device)


def _encdec_forward_prefill(cfg, axes: MeshAxes, params, batch):
    require_serving_mesh(cfg, axes, "prefill")
    layout = residual_layout(cfg, "prefill")
    memory = _enc_stack(cfg, layout, params, axes, batch["frames"],
                        kind="prefill")
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = embed_apply(cfg, layout, params["embed"], tokens, axes)
    positions = _positions(cfg, batch, B, S, tokens.device)
    caches = []
    for i in range(cfg.num_layers):
        h, c, _ = block_apply(cfg, layout,
                              _layer(params, i, key="dec_layers"), h,
                              positions, axes, kind="prefill", ffn="mlp",
                              memory=memory, return_kv=True)
        caches.append(c)
    h = norm_apply(cfg, layout, params["final_norm"], h, axes)
    logits = head_logits(cfg, layout, params["head"],
                         _last_position(h, layout, axes), axes)
    return logits, _stack_caches(caches)


def _encdec_forward_decode(cfg, axes: MeshAxes, params, cache, tokens, pos):
    """The decoder's step: each layer writes its self K/V row into
    ``cache["self"]`` in place and reads ``cache["cross"]`` whole."""
    require_serving_mesh(cfg, axes, "decode")
    layout = residual_layout(cfg, "decode")
    h = embed_apply(cfg, layout, params["embed"], tokens, axes)
    for i in range(cfg.num_layers):
        layer_cache = tree_map(lambda t: t[i], cache)
        h, _, _ = block_apply(cfg, layout,
                              _layer(params, i, key="dec_layers"), h, None,
                              axes, kind="decode", ffn="mlp",
                              cache=layer_cache, pos=pos)
    h = norm_apply(cfg, layout, params["final_norm"], h, axes)
    return head_logits(cfg, layout, params["head"], h, axes), cache
