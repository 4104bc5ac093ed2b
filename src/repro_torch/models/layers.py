"""Shared layers: norms, embedding, MLP (dense-TP or phantom per site),
logit head and the sequence-chunked cross-entropy.

Residual-stream layouts, as in the reference (each rank sees its local
shard):

  * ``sp``  -- sequence-parallel  [B, S/p, d]   (the dense TP baseline)
  * ``fp``  -- feature-parallel   [B, S, d/p]   (phantom: activations
               stay feature-sharded end to end, the paper's layout)
  * ``rep`` -- replicated         [B, S, d]     (dense decode)

At tp = 1 all three are the full ``[B, S, d]`` tensor, and the gathers,
scatters and psums between them are the identity: they are skipped.

FSDP (``cfg.fsdp``): the decls also shard one dim of each large weight
over dp (``"dp"`` in the spec), and each module gathers them where it
uses them (``gather_fsdp``); the gather's gradient is the reduce-scatter
over dp.  Inside a block under ``remat="full"`` the gathers run again in
the recompute, as the reference's do inside its checkpointed layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import PHANTOM_KINDS
from repro_torch.core import tp as tpmod
from repro_torch.core.autograd import (all_gather_dp, all_gather_tiled,
                                       all_to_all, pmax, psum,
                                       psum_scatter_tiled)
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import ParamDecl
from repro_torch.parallel.strategies import site_strategy

NEG_INF = -1e30


def dtype_of(name: str) -> torch.dtype:
    """Config dtype string ("bfloat16", "float32") -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def residual_layout(cfg, kind: str) -> str:
    """The residual stream's layout for a config and step kind: any
    phantom-family site keeps it feature-sharded end to end."""
    if cfg.uses_phantom_sites():
        return "fp"
    return "rep" if kind == "decode" else "sp"


def to_full(x, layout: str, axes: MeshAxes):
    """Local residual shard -> full [B, S, d] (fwd AG, bwd RS)."""
    if axes.tp == 1 or layout == "rep":
        return x
    if layout == "sp":
        return tpmod.gather_seq(x, axes, axis=1)
    return tpmod.gather_features(x, axes)


def from_partial(z, layout: str, axes: MeshAxes):
    """Partial-sum full [B, S, d] -> reduced local shard (fwd RS, bwd
    AG)."""
    if axes.tp == 1:
        return z
    if layout == "sp":
        return tpmod.scatter_seq(z, axes, axis=1)
    if layout == "fp":
        return tpmod.scatter_features(z, axes)
    return psum(z, axes)


def seq_to_feature(x, axes: MeshAxes):
    """[B, S/p, d] -> [B, S, d/p] (one all-to-all)."""
    return all_to_all(x, axes, 2, 1)


def feature_to_seq(x, axes: MeshAxes):
    """[B, S, d/p] -> [B, S/p, d] (one all-to-all)."""
    return all_to_all(x, axes, 1, 2)


def gather_on_use(w, axes: MeshAxes, dim: int = 0):
    """A weight sharded over the model axis and gathered where it is used
    (ring attention's projections): forward all-gather, the gradient
    reduce-scattered."""
    if axes.tp == 1:
        return w
    return all_gather_tiled(w, axes, dim)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def _require(cfg):
    """The norm and MLP kinds of the ported configs: SwiGLU MLPs and
    experts, and seamless's gelu MLP; the reference's relu MLP, which no
    LM config sets, is not ported."""
    if cfg.norm not in ("rmsnorm", "layernorm") or cfg.mlp not in (
            "swiglu", "gelu"):
        raise NotImplementedError(
            f"norm={cfg.norm!r} mlp={cfg.mlp!r}: only rmsnorm or layernorm "
            f"with swiglu or gelu MLPs are ported")


def norm_decls(cfg, layout: str, d: int):
    """Scale (and LayerNorm's bias): feature-sharded in ``fp``,
    replicated in ``sp`` and ``rep``."""
    _require(cfg)
    spec = ("tp",) if layout == "fp" else ()
    decl = {"scale": ParamDecl((d,), spec, init="ones")}
    if cfg.norm == "layernorm":
        decl["bias"] = ParamDecl((d,), spec, init="zeros")
    return decl


def norm_apply(cfg, layout: str, params, x, axes: MeshAxes):
    """RMSNorm or LayerNorm (mean and variance form) over the feature
    dim, in float32; in ``fp`` at tp > 1 the partial moments of the
    feature shard are summed over the model axis."""
    xf = x.to(torch.float32)
    if layout == "fp" and axes.tp > 1:
        d = x.shape[-1] * axes.tp
        if cfg.norm == "layernorm":
            mean = psum(xf.sum(-1, keepdim=True), axes) / d
            xc = xf - mean
            var = psum((xc * xc).sum(-1, keepdim=True), axes) / d
            y = xc * torch.rsqrt(var + cfg.norm_eps) * params["scale"] \
                + params["bias"]
        else:
            ms = psum((xf * xf).sum(-1, keepdim=True), axes) / d
            y = xf * torch.rsqrt(ms + cfg.norm_eps) * params["scale"]
        return y.to(x.dtype)
    if cfg.norm == "layernorm":
        xc = xf - xf.mean(-1, keepdim=True)
        var = (xc * xc).mean(-1, keepdim=True)
        y = xc * torch.rsqrt(var + cfg.norm_eps) * params["scale"] \
            + params["bias"]
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * params["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------

def padded_vocab(cfg) -> int:
    """Vocab rounded up to a multiple of 128; padded logit columns are
    masked (``head_logits``)."""
    return -(-cfg.vocab_size // 128) * 128


def embed_decls(cfg):
    return {"table": ParamDecl((padded_vocab(cfg), cfg.d_model),
                               ("tp", "dp" if cfg.fsdp else None),
                               init="embed")}


def embed_apply(cfg, layout: str, params, tokens, axes: MeshAxes):
    """tokens [B, S] -> the residual shard in ``layout``, in the compute
    dtype.  At tp > 1 each rank looks up its vocab shard (tokens outside
    it give 0) and one reduce-scatter sums the shards into the layout
    (an all-reduce for ``rep``)."""
    table = params["table"]
    if cfg.fsdp:
        table = gather_fsdp(table, ("tp", "dp"), axes,
                            quant=cfg.fsdp_gather_quant)
    dt = dtype_of(cfg.dtype)
    if axes.tp == 1:
        return table[tokens].to(dt)
    vshard = table.shape[0]
    local = tokens - axes.tp_rank * vshard
    ok = (local >= 0) & (local < vshard)
    h = table[local.clamp(0, vshard - 1)]
    h = torch.where(ok[..., None], h, 0).to(dt)           # [B, S, d]
    if layout == "sp":
        return psum_scatter_tiled(h, axes, 1)
    if layout == "fp":
        return psum_scatter_tiled(h, axes, -1)
    return psum(h, axes)


# ---------------------------------------------------------------------------
# FSDP: gather on use
# ---------------------------------------------------------------------------

def gather_fsdp(w, spec, axes: MeshAxes, quant: bool = False):
    """All-gather the dims of ``w`` that ``spec`` shards over ``"dp"``
    (FSDP's gather on use; the gradient is reduce-scattered over dp).

    ``quant``: the reference's int8 gather.  The local shard is
    quantised symmetrically per column of the gathered dim (scale
    ``max|w| / 127``), the int8 values and the scales are gathered, and
    the product is bf16.  As in the reference, the rounding carries no
    gradient, so only each column's largest-magnitude element receives
    one, through the scale; with quantisation the weight is quantised
    even at dp = 1, where the gather itself is the identity."""
    for dim, entry in enumerate(spec):
        if entry != "dp":
            continue
        if quant and w.is_floating_point():
            scale = (w.abs().amax(dim, keepdim=True) / 127.0) \
                .clamp_min(1e-12)
            wq = all_gather_dp(torch.round(w.detach() / scale.detach())
                               .to(torch.int8), axes, dim)
            sc = all_gather_dp(scale, axes, dim)
            w = (wq.to(torch.bfloat16)
                 * _expand_scales(sc, wq.shape, dim).to(torch.bfloat16))
        else:
            w = all_gather_dp(w, axes, dim)
    return w


def _expand_scales(sc, target_shape, dim: int):
    """Per-shard scales gathered along ``dim`` -> broadcast to the
    gathered weight's shape."""
    reps = target_shape[dim] // sc.shape[dim]
    return sc.repeat_interleave(reps, dim=dim)


def gather_tree_fsdp(params, decls, axes: MeshAxes, quant: bool = False):
    """``gather_fsdp`` over a parameter subtree and its decls (``decls``
    None: the tree as it is)."""
    if decls is None:
        return params
    if isinstance(params, dict):
        return {k: gather_tree_fsdp(v, decls[k], axes, quant)
                for k, v in params.items()}
    return gather_fsdp(params, decls.spec, axes, quant)


def _fs(params, decls, key, axes: MeshAxes, quant: bool = False):
    """The subtree ``params[key]`` gathered on use."""
    return gather_tree_fsdp(params[key],
                            None if decls is None else decls[key],
                            axes, quant)


# ---------------------------------------------------------------------------
# MLP (dense TP and phantom, per site)
# ---------------------------------------------------------------------------

def mlp_strategies(cfg, axes: MeshAxes, d: int, ff: int):
    """One ProjectionStrategy per MLP site: gate/up/down for SwiGLU, none
    with a bias; up/down for gelu, a bias on ``up`` only."""
    _require(cfg)
    names = ("gate", "up", "down") if cfg.mlp == "swiglu" else ("up", "down")
    return {name: site_strategy(cfg, f"ffn_{name}",
                                *((ff, d) if name == "down" else (d, ff)),
                                axes.tp, dp=axes.dp,
                                bias=name == "up" and cfg.mlp != "swiglu",
                                fsdp=cfg.fsdp)
            for name in names}


def mlp_decls(cfg, axes: MeshAxes, d: int, ff: int):
    return {name: st.decls()
            for name, st in mlp_strategies(cfg, axes, d, ff).items()}


def mlp_apply(cfg, layout: str, params, x, axes: MeshAxes, decls=None):
    """SwiGLU (``silu(gate) * up``) or gelu (``gelu(up)``, jax's default
    tanh form), residual shard -> residual shard (same layout).

    all-phantom: stays feature-sharded; only the k-wide ghosts cross
                 ranks.
    all-tensor:  gather -> col -> act -> row -> reduce-scatter
                 (Megatron-SP; one gather shared by gate and up).
    mixed:       each site shard -> shard in ``fp``.
    ``decls`` (FSDP): the sites' weights are gathered over dp first."""
    params = gather_tree_fsdp(params, decls, axes, cfg.fsdp_gather_quant)
    dt = dtype_of(cfg.dtype)
    d = x.shape[-1] * (axes.tp if layout == "fp" else 1)
    sts = mlp_strategies(cfg, axes, d, cfg.d_ff)
    kinds = {st.kind for st in sts.values()}

    def hidden(site):
        """The activated hidden units; ``site(name)`` is one site's
        projection of the input."""
        if cfg.mlp == "swiglu":
            return F.silu(site("gate")) * site("up")
        return F.gelu(site("up"), approximate="tanh")

    if kinds <= set(PHANTOM_KINDS):
        h = hidden(lambda n: sts[n].apply(params[n], x, axes=axes,
                                          compute_dtype=dt))
        return sts["down"].apply(params["down"], h, axes=axes,
                                 compute_dtype=dt)
    if kinds <= {"tensor_col", "tensor_row"}:
        x_full = to_full(x, layout, axes)
        h = hidden(lambda n: sts[n].apply(params[n], x_full,
                                          compute_dtype=dt))
        z = sts["down"].apply(params["down"], h, compute_dtype=dt)
        return from_partial(z, layout, axes)     # down has no bias
    # mixed strategies: residual_layout is fp whenever a site is phantom
    if layout != "fp":
        raise ValueError(f"mixed MLP strategies {kinds} in layout "
                         f"{layout!r}")
    h = hidden(lambda n: sts[n].apply_shard(params[n], x, axes,
                                            compute_dtype=dt))
    return sts["down"].apply_shard(params["down"], h, axes,
                                   compute_dtype=dt)


# ---------------------------------------------------------------------------
# logit head
# ---------------------------------------------------------------------------

def head_decls(cfg):
    return {"w": ParamDecl((cfg.d_model, padded_vocab(cfg)),
                           ("dp" if cfg.fsdp else None, "tp"),
                           scale=cfg.d_model ** -0.5)}


def _head_w(cfg, params, axes):
    w = params["w"]
    if cfg.fsdp:
        w = gather_fsdp(w, ("dp", "tp"), axes, quant=cfg.fsdp_gather_quant)
    return w


def head_logits(cfg, layout: str, params, h_last, axes: MeshAxes):
    """h_last [B, 1, d] (in ``fp``: the feature shard [B, 1, d/p]) ->
    float32 logits [B, 1, V_pad], padded columns masked to -1e30.  At
    tp > 1 each rank multiplies by its vocab shard of the head and the
    shards' logits are all-gathered over the model axis, as the
    reference's are."""
    w = _head_w(cfg, params, axes)
    h = to_full(h_last, layout, axes) if layout == "fp" else h_last
    logits = h.to(torch.float32) @ w.to(torch.float32)
    vshard = w.shape[1]
    col_ok = (axes.tp_rank * vshard
              + torch.arange(vshard, device=w.device)) < cfg.vocab_size
    logits = logits.masked_fill(~col_ok, NEG_INF)
    if axes.tp == 1:
        return logits
    return all_gather_tiled(logits, axes, -1)


def _xent_chunk(cfg, w, h, labels, axes):
    """Summed token loss of one sequence chunk against this rank's vocab
    shard ``w``: float32 logits with the padded vocab columns masked, a
    global log-sum-exp shifted by a detached max over the model axis
    (the shift is a constant: exact without its gradient), the true
    logit summed from the rank that holds its column."""
    logits = h.to(torch.float32) @ w.to(torch.float32)     # [B, c, V/p]
    vshard = w.shape[1]
    vstart = axes.tp_rank * vshard
    col_ok = vstart + torch.arange(vshard, device=w.device) < cfg.vocab_size
    logits = logits.masked_fill(~col_ok, NEG_INF)
    m = pmax(logits.detach().amax(-1), axes)
    lse = torch.log(psum(torch.exp(logits - m[..., None]).sum(-1),
                         axes)) + m
    loc = labels - vstart
    ok = (loc >= 0) & (loc < vshard)
    true_logit = logits.gather(-1, loc.clamp(0, vshard - 1)[..., None])
    true_logit = psum(torch.where(ok, true_logit[..., 0], 0.0), axes)
    return (lse - true_logit).sum()


def xent_loss(cfg, layout: str, params, h, labels, axes: MeshAxes):
    """h: residual shard, labels [B, S] -> (sum_loss, n_valid): the
    summed cross-entropy of the tokens and their count, every token
    valid (the caller normalises and sums over dp; the model axis is
    reduced here).  Never holds [B, S, V] at once: the gathered sequence
    goes in chunks of ``cfg.loss_chunk`` against the rank's vocab shard,
    and with more than one chunk each is recomputed in the backward pass
    instead of saved (the reference scans the chunks)."""
    from torch.utils.checkpoint import checkpoint
    h = to_full(h, layout, axes)                          # [B, S, d]
    B, S, _ = h.shape
    chunk = min(cfg.loss_chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} does not tile into loss chunks "
                         f"of {chunk}")
    labels = labels.long()
    w = _head_w(cfg, params, axes)
    sum_loss = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S, chunk):
        args = (cfg, w, h[:, c:c + chunk], labels[:, c:c + chunk], axes)
        sum_loss = sum_loss + (
            checkpoint(_xent_chunk, *args, use_reentrant=False)
            if chunk < S else _xent_chunk(*args))
    return sum_loss, torch.tensor(labels.numel(), dtype=torch.int32,
                                  device=h.device)
