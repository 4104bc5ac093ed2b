"""The dense block: (attention + MLP) residual layer.  The reference's
Mamba, MoE and cross-attention blocks arrive with their families."""
from __future__ import annotations

from repro_torch.models import attention as attn
from repro_torch.models.layers import (mlp_apply, mlp_decls, norm_apply,
                                       norm_decls)
from repro_torch.parallel.axes import MeshAxes


def block_decls(cfg, axes: MeshAxes):
    return {"norm1": norm_decls(cfg, cfg.d_model),
            "mixer": attn.attn_decls(cfg, axes),
            "norm2": norm_decls(cfg, cfg.d_model),
            "ffn": mlp_decls(cfg, axes, cfg.d_model, cfg.d_ff)}


def block_apply(cfg, params, x, positions, axes: MeshAxes, *, kind: str,
                cache=None, pos=None, return_kv: bool = False):
    """Returns (x, new_kv)."""
    h = norm_apply(cfg, params["norm1"], x)
    out, new_kv = attn.attention(cfg, params["mixer"], h, positions, axes,
                                 kind=kind, cache=cache, pos=pos,
                                 return_kv=return_kv)
    x = x + out.to(x.dtype)
    h2 = norm_apply(cfg, params["norm2"], x)
    x = x + mlp_apply(cfg, params["ffn"], h2, axes).to(x.dtype)
    return x, new_kv
