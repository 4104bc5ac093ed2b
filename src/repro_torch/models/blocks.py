"""The dense block: (attention + MLP) residual layer, on the residual
stream's layout (``models/layers.py``).  The reference's Mamba, MoE and
cross-attention blocks arrive with their families."""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.layers import (mlp_apply, mlp_decls, norm_apply,
                                       norm_decls)
from repro_torch.parallel.axes import MeshAxes


def block_decls(cfg, axes: MeshAxes, layout: str):
    return {"norm1": norm_decls(cfg, layout, cfg.d_model),
            "mixer": attn.attn_decls(cfg, axes),
            "norm2": norm_decls(cfg, layout, cfg.d_model),
            "ffn": mlp_decls(cfg, axes, cfg.d_model, cfg.d_ff)}


def block_apply(cfg, layout: str, params, x, positions, axes: MeshAxes, *,
                kind: str, cache=None, pos=None, return_kv: bool = False):
    """Returns (x, new_kv).  kind: train | prefill | decode."""
    h = norm_apply(cfg, layout, params["norm1"], x, axes)
    out, new_kv = attn.attention(cfg, layout, params["mixer"], h, positions,
                                 axes, kind=kind, cache=cache, pos=pos,
                                 return_kv=return_kv)
    x = x + out.to(x.dtype)
    h2 = norm_apply(cfg, layout, params["norm2"], x, axes)
    x = x + mlp_apply(cfg, layout, params["ffn"], h2, axes).to(x.dtype)
    return x, new_kv


def _train_block(cfg, layout, params, x, positions, axes):
    return block_apply(cfg, layout, params, x, positions, axes,
                       kind="train")[0]


def block_train(cfg, layout: str, params, x, positions, axes: MeshAxes):
    """One block of the training forward.  ``cfg.remat == "full"`` keeps
    only the block's input and recomputes the rest in the backward pass
    (the reference's ``jax.checkpoint`` of its layer-scan body), so the
    flash kernel, the phantom forward kernel and the block's collectives
    run there a second time; ``"none"`` saves every activation."""
    if cfg.remat == "none":
        return _train_block(cfg, layout, params, x, positions, axes)
    if cfg.remat != "full":
        raise NotImplementedError(f"remat={cfg.remat!r}: the port has "
                                  f"'full' and 'none'")
    return checkpoint(_train_block, cfg, layout, params, x, positions, axes,
                      use_reentrant=False)
