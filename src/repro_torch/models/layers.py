"""Shared layers: norms, embedding, MLP (dense-TP or phantom per site),
logit head.

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
    """The dense family as chatglm3-6b uses it; the reference's other
    norm and MLP kinds arrive with the configs that use them."""
    if cfg.norm != "rmsnorm" or cfg.mlp != "swiglu":
        raise NotImplementedError(
            f"norm={cfg.norm!r} mlp={cfg.mlp!r}: only rmsnorm + swiglu "
            f"are ported (ROADMAP.md queue 1, item 6)")


def norm_decls(cfg, d: int):
    _require(cfg)
    return {"scale": ParamDecl((d,), ("tp",), init="ones")}


def norm_apply(cfg, params, x):
    """RMSNorm over the feature dim, in float32."""
    xf = x.to(torch.float32)
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
