"""Shared layers: norms, embedding, MLP (dense-TP or phantom per site),
logit head and the sequence-chunked cross-entropy.

At dp = tp = 1 the reference's residual layouts (``sp``, ``fp``,
``rep``) are all the full ``[B, S, d]`` tensor and its feature gathers,
scatters and psums are the identity, so the functions here take no
layout argument.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
# norms
# ---------------------------------------------------------------------------

def _require(cfg):
    """The norm and MLP kinds of the ported dense configs; the
    reference's gelu and relu MLPs arrive with the configs that use
    them."""
    if cfg.norm not in ("rmsnorm", "layernorm") or cfg.mlp != "swiglu":
        raise NotImplementedError(
            f"norm={cfg.norm!r} mlp={cfg.mlp!r}: only rmsnorm or layernorm "
            f"with swiglu are ported (ROADMAP.md queue 1, item 6)")


def norm_decls(cfg, d: int):
    _require(cfg)
    decl = {"scale": ParamDecl((d,), ("tp",), init="ones")}
    if cfg.norm == "layernorm":
        decl["bias"] = ParamDecl((d,), ("tp",), init="zeros")
    return decl


def norm_apply(cfg, params, x):
    """RMSNorm or LayerNorm (mean and variance form) over the feature
    dim, in float32."""
    xf = x.to(torch.float32)
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
                               ("tp", None), init="embed")}


def embed_apply(cfg, params, tokens):
    """tokens [B, S] -> [B, S, d] in the compute dtype."""
    return params["table"][tokens].to(dtype_of(cfg.dtype))


# ---------------------------------------------------------------------------
# MLP (dense TP and phantom, per site)
# ---------------------------------------------------------------------------

def mlp_strategies(cfg, axes: MeshAxes, d: int, ff: int):
    """One ProjectionStrategy per SwiGLU site (gate/up/down), none with
    a bias."""
    _require(cfg)
    return {name: site_strategy(cfg, f"ffn_{name}",
                                *((ff, d) if name == "down" else (d, ff)),
                                axes.tp, dp=axes.dp, bias=False)
            for name in ("gate", "up", "down")}


def mlp_decls(cfg, axes: MeshAxes, d: int, ff: int):
    return {name: st.decls()
            for name, st in mlp_strategies(cfg, axes, d, ff).items()}


def mlp_apply(cfg, params, x, axes: MeshAxes):
    """SwiGLU, x [B, S, d] -> [B, S, d].  At tp = 1 the reference's
    all-phantom, all-tensor and mixed branches compute the same sequence:
    silu(gate) * up, then down (the row strategy's reduction is the
    identity, and no site has a bias)."""
    dt = dtype_of(cfg.dtype)
    sts = mlp_strategies(cfg, axes, x.shape[-1], cfg.d_ff)
    g = sts["gate"].apply(params["gate"], x, compute_dtype=dt)
    u = sts["up"].apply(params["up"], x, compute_dtype=dt)
    return sts["down"].apply(params["down"], F.silu(g) * u,
                             compute_dtype=dt)


# ---------------------------------------------------------------------------
# logit head
# ---------------------------------------------------------------------------

def head_decls(cfg):
    return {"w": ParamDecl((cfg.d_model, padded_vocab(cfg)), (None, "tp"),
                           scale=cfg.d_model ** -0.5)}


def head_logits(cfg, params, h_last):
    """h_last [B, 1, d] -> float32 logits [B, 1, V_pad], padded columns
    masked to -1e30."""
    w = params["w"]
    logits = h_last.to(torch.float32) @ w.to(torch.float32)
    col_ok = torch.arange(w.shape[1], device=w.device) < cfg.vocab_size
    return logits.masked_fill(~col_ok, NEG_INF)


def _xent_chunk(cfg, w, h, labels):
    """Summed token loss of one sequence chunk: float32 logits with the
    padded vocab columns masked, log-sum-exp shifted by a detached max
    (the shift is a constant: exact without its gradient)."""
    logits = h.to(torch.float32) @ w.to(torch.float32)
    col_ok = torch.arange(w.shape[1], device=w.device) < cfg.vocab_size
    logits = logits.masked_fill(~col_ok, NEG_INF)
    m = logits.detach().amax(-1)
    lse = torch.log(torch.exp(logits - m[..., None]).sum(-1)) + m
    true_logit = logits.gather(-1, labels[..., None])[..., 0]
    return (lse - true_logit).sum()


def xent_loss(cfg, params, h, labels):
    """h [B, S, d], labels [B, S] -> (sum_loss, n_valid): the summed
    cross-entropy of the tokens and their count, every token valid (the
    caller normalises and sums over dp).  Never holds [B, S, V] at once:
    the sequence goes in chunks of ``cfg.loss_chunk``, and with more than
    one chunk each is recomputed in the backward pass instead of saved
    (the reference scans the chunks)."""
    from torch.utils.checkpoint import checkpoint
    B, S, _ = h.shape
    chunk = min(cfg.loss_chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} does not tile into loss chunks "
                         f"of {chunk}")
    labels = labels.long()
    w = params["w"]
    sum_loss = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S, chunk):
        args = (cfg, w, h[:, c:c + chunk], labels[:, c:c + chunk])
        sum_loss = sum_loss + (
            checkpoint(_xent_chunk, *args, use_reentrant=False)
            if chunk < S else _xent_chunk(*args))
    return sum_loss, torch.tensor(labels.numel(), dtype=torch.int32,
                                  device=h.device)
