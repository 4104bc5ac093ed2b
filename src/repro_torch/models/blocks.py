"""Composable blocks: (mixer + FFN) residual layers, on the residual
stream's layout (``models/layers.py``).

mixer: ``"attn"`` (GQA in head or ring mode) or ``"mamba"`` (SSD,
``models/ssm.py``); FFN: the MLP (dense or phantom per site), the MoE
(``models/moe.py``) or None (mamba2 has none).  A hybrid plan
(``attn_period`` > 0: jamba's 1 attention layer in 8, the MoE on every
other layer) repeats a superblock of ``plan_period`` layers, which
``superblock_train`` runs as one recompute unit.  A decoder block of
the encoder-decoder family (``cross=True``) adds a cross-attention
sub-layer (``norm_x``, ``cross``) between the mixer and the FFN, which
reads the encoder's output (``memory``); its cache is ``{"self": ...,
"cross": ...}``.  The encoder's blocks run with ``causal=False``.

Under FSDP each module gathers its dp-sharded weights where it uses
them, from the block's decls (``block_decls``)."""
from __future__ import annotations

from functools import lru_cache

from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moemod
from repro_torch.models import ssm as ssmmod
from repro_torch.models.layers import (mlp_apply, mlp_decls, norm_apply,
                                       norm_decls)
from repro_torch.parallel.axes import MeshAxes


def layer_plan(cfg):
    """[(mixer, ffn)] for each layer: SSD mixers everywhere at
    ``attn_period == -1``, attention elsewhere (``attn_period`` > 0,
    the hybrid interleave, is planned as in the reference); no FFN for
    the SSM family, the MoE on the layers its ``every_n`` / ``offset``
    pick, the MLP elsewhere."""
    plan = []
    for l in range(cfg.num_layers):
        if cfg.attn_period == -1:
            mixer = "mamba"
        elif cfg.attn_period > 0:
            mixer = "attn" if l % cfg.attn_period == 0 else "mamba"
        else:
            mixer = "attn"
        if cfg.family == "ssm":
            ffn = None
        elif cfg.moe is not None and l % cfg.moe.every_n == cfg.moe.offset:
            ffn = "moe"
        elif cfg.d_ff > 0:
            ffn = "mlp"
        else:
            ffn = None
        plan.append((mixer, ffn))
    return plan


def plan_period(cfg) -> int:
    """The smallest repeating period of the layer plan: the superblock
    that the stack repeats (jamba: 8)."""
    plan = layer_plan(cfg)
    for per in range(1, len(plan) + 1):
        if len(plan) % per == 0 and plan == plan[:per] * (len(plan) // per):
            return per
    return len(plan)


def block_decls(cfg, axes: MeshAxes, layout: str, ffn, mixer: str = "attn",
                cross: bool = False):
    d = {"norm1": norm_decls(cfg, layout, cfg.d_model),
         "mixer": (ssmmod.ssm_decls(cfg, axes) if mixer == "mamba"
                   else attn.attn_decls(cfg, axes))}
    if cross:
        d["norm_x"] = norm_decls(cfg, layout, cfg.d_model)
        d["cross"] = attn.attn_decls(cfg, axes, cross=True)
    if ffn is not None:
        d["norm2"] = norm_decls(cfg, layout, cfg.d_model)
        d["ffn"] = (moemod.moe_decls(cfg, axes) if ffn == "moe"
                    else mlp_decls(cfg, axes, cfg.d_model, cfg.d_ff))
    return d


@lru_cache(maxsize=64)
def _fsdp_decls(cfg, tp: int, dp: int, layout: str, ffn, mixer: str,
                cross: bool):
    return block_decls(cfg, MeshAxes(tp=tp, dp=dp), layout, ffn, mixer,
                       cross)


def block_apply(cfg, layout: str, params, x, positions, axes: MeshAxes, *,
                kind: str, ffn, mixer: str = "attn", cache=None, pos=None,
                return_kv: bool = False, causal: bool = True, memory=None):
    """Returns (x, new_cache, aux): ``aux`` the MoE's balance loss, None
    for any other block.  kind: train | prefill | decode; the cache is
    the attention's {k, v}, the SSD's {conv, ssm}, or a decoder block's
    ``{"self": {k, v}, "cross": {k, v}}`` (the cross sub-layer reads the
    encoder's ``memory`` in train and prefill, its cache in decode)."""
    has_cross = "cross" in params
    decls = (_fsdp_decls(cfg, axes.tp, axes.dp, layout, ffn, mixer,
                         has_cross) if cfg.fsdp else {})
    self_cache = (cache["self"] if has_cross and cache is not None
                  else cache)
    h = norm_apply(cfg, layout, params["norm1"], x, axes)
    if mixer == "mamba":
        out, new_kv = ssmmod.ssm_apply(cfg, layout, params["mixer"], h,
                                       axes, decls.get("mixer"), kind=kind,
                                       cache=self_cache)
    else:
        out, new_kv = attn.attention(cfg, layout, params["mixer"], h,
                                     positions, axes, kind=kind,
                                     causal=causal, cache=self_cache,
                                     pos=pos, return_kv=return_kv,
                                     decls=decls.get("mixer"))
    x = x + out.to(x.dtype)
    if has_cross:
        hx = norm_apply(cfg, layout, params["norm_x"], x, axes)
        cout, cross_kv = attn.attention(
            cfg, layout, params["cross"], hx, positions, axes, kind=kind,
            causal=False, memory=memory, cross=True,
            cache=cache["cross"] if kind == "decode" else None, pos=pos,
            return_kv=return_kv and kind == "prefill",
            decls=decls.get("cross"))
        x = x + cout.to(x.dtype)
        if kind == "decode" or (kind == "prefill" and return_kv):
            new_kv = {"self": new_kv, "cross": cross_kv}
    if ffn is None:
        return x, new_kv, None
    h2 = norm_apply(cfg, layout, params["norm2"], x, axes)
    aux = None
    if ffn == "moe":
        f, aux = moemod.moe_apply(cfg, layout, params["ffn"], h2, axes,
                                  decls.get("ffn"))
    else:
        f = mlp_apply(cfg, layout, params["ffn"], h2, axes, decls.get("ffn"))
    return x + f.to(x.dtype), new_kv, aux


def _train_block(cfg, layout, params, x, positions, axes, ffn, mixer,
                 causal=True, memory=None):
    x, _, aux = block_apply(cfg, layout, params, x, positions, axes,
                            kind="train", ffn=ffn, mixer=mixer,
                            causal=causal, memory=memory)
    return x, aux


def block_train(cfg, layout: str, params, x, positions, axes: MeshAxes,
                ffn, mixer: str = "attn", causal: bool = True, memory=None):
    """One block of the training forward -> (x, aux or None); an
    encoder's block with ``causal=False``, a decoder's with its
    ``memory``.
    ``cfg.remat == "full"`` keeps only the block's input and recomputes
    the rest in the backward pass (the reference's ``jax.checkpoint`` of
    its layer-scan body), so the flash kernel, the phantom forward
    kernel, the block's collectives (FSDP's gathers among them) and the
    MoE's router and all-to-alls run there a second time (the router
    picks the same experts from the same input); ``"none"`` saves every
    activation."""
    if cfg.remat == "none":
        return _train_block(cfg, layout, params, x, positions, axes, ffn,
                            mixer, causal, memory)
    if cfg.remat != "full":
        raise NotImplementedError(f"remat={cfg.remat!r}: the port has "
                                  f"'full' and 'none'")
    return checkpoint(_train_block, cfg, layout, params, x, positions, axes,
                      ffn, mixer, causal, memory, use_reentrant=False)


def _train_superblock(cfg, layout, params, x, positions, axes, plan):
    aux = None
    for i, (mixer, ffn) in enumerate(plan):
        x, a = _train_block(cfg, layout, params[f"sub{i}"], x, positions,
                            axes, ffn, mixer)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def superblock_train(cfg, layout: str, params, x, positions,
                     axes: MeshAxes, plan):
    """One superblock of the training forward -> (x, aux or None), its
    subs ``{"sub0": ..., f"sub{len(plan) - 1}": ...}`` in the order of
    ``plan`` ([(mixer, ffn)]), the MoE subs' balance losses summed.
    ``cfg.remat == "full"`` keeps only the superblock's input and
    recomputes all of it in the backward pass, as the reference's
    ``jax.checkpoint`` of its superblock-scan body."""
    if cfg.remat == "none":
        return _train_superblock(cfg, layout, params, x, positions, axes,
                                 plan)
    if cfg.remat != "full":
        raise NotImplementedError(f"remat={cfg.remat!r}: the port has "
                                  f"'full' and 'none'")
    return checkpoint(_train_superblock, cfg, layout, params, x, positions,
                      axes, plan, use_reentrant=False)
