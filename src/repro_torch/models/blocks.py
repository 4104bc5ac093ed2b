"""Composable blocks: (attention + FFN) residual layers, on the residual
stream's layout (``models/layers.py``).  The FFN is the MLP (dense or
phantom per site) or the MoE (``models/moe.py``); the reference's
Mamba and cross-attention blocks arrive with their families."""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moemod
from repro_torch.models.layers import (mlp_apply, mlp_decls, norm_apply,
                                       norm_decls)
from repro_torch.parallel.axes import MeshAxes


def layer_plan(cfg):
    """[(mixer, ffn)] for each layer: attention everywhere (the port's
    families), the MoE on the layers its ``every_n`` / ``offset`` pick,
    the MLP elsewhere."""
    plan = []
    for l in range(cfg.num_layers):
        if cfg.moe is not None and l % cfg.moe.every_n == cfg.moe.offset:
            ffn = "moe"
        elif cfg.d_ff > 0:
            ffn = "mlp"
        else:
            ffn = None
        plan.append(("attn", ffn))
    return plan


def block_decls(cfg, axes: MeshAxes, layout: str, ffn: str):
    d = {"norm1": norm_decls(cfg, layout, cfg.d_model),
         "mixer": attn.attn_decls(cfg, axes),
         "norm2": norm_decls(cfg, layout, cfg.d_model)}
    if ffn == "moe":
        d["ffn"] = moemod.moe_decls(cfg, axes)
    else:
        d["ffn"] = mlp_decls(cfg, axes, cfg.d_model, cfg.d_ff)
    return d


def block_apply(cfg, layout: str, params, x, positions, axes: MeshAxes, *,
                kind: str, ffn: str, cache=None, pos=None,
                return_kv: bool = False):
    """Returns (x, new_kv, aux): ``aux`` the MoE's balance loss, None for
    an MLP block.  kind: train | prefill | decode."""
    h = norm_apply(cfg, layout, params["norm1"], x, axes)
    out, new_kv = attn.attention(cfg, layout, params["mixer"], h, positions,
                                 axes, kind=kind, cache=cache, pos=pos,
                                 return_kv=return_kv)
    x = x + out.to(x.dtype)
    h2 = norm_apply(cfg, layout, params["norm2"], x, axes)
    aux = None
    if ffn == "moe":
        f, aux = moemod.moe_apply(cfg, layout, params["ffn"], h2, axes)
    else:
        f = mlp_apply(cfg, layout, params["ffn"], h2, axes)
    return x + f.to(x.dtype), new_kv, aux


def _train_block(cfg, layout, params, x, positions, axes, ffn):
    x, _, aux = block_apply(cfg, layout, params, x, positions, axes,
                            kind="train", ffn=ffn)
    return x, aux


def block_train(cfg, layout: str, params, x, positions, axes: MeshAxes,
                ffn: str):
    """One block of the training forward -> (x, aux or None).
    ``cfg.remat == "full"`` keeps only the block's input and recomputes
    the rest in the backward pass (the reference's ``jax.checkpoint`` of
    its layer-scan body), so the flash kernel, the phantom forward
    kernel, the block's collectives and the MoE's router and all-to-alls
    run there a second time (the router picks the same experts from the
    same input); ``"none"`` saves every activation."""
    if cfg.remat == "none":
        return _train_block(cfg, layout, params, x, positions, axes, ffn)
    if cfg.remat != "full":
        raise NotImplementedError(f"remat={cfg.remat!r}: the port has "
                                  f"'full' and 'none'")
    return checkpoint(_train_block, cfg, layout, params, x, positions, axes,
                      ffn, use_reentrant=False)
