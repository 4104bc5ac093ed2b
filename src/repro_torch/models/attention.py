"""GQA attention in the reference's two training modes, chosen by
``resolve_attn_mode``:

* ``head``: the query heads (and the KV heads when the model axis
  divides them) column-sharded over the model axis.  A phantom site
  reads the residual's feature shard, a tensor site the gathered
  features; with kv % p != 0 the KV projection is replicated and each
  rank slices its GQA group's head.  ``wo`` is phantom (its output stays
  feature-sharded) or a row projection whose partial sums are reduced
  into the residual layout.  The core is the flash kernel through
  ``kernels/ops.py: flash_attention_vjp`` when all four q/k/v/o site
  specs resolve to the ``"pallas"`` backend and
  ``flash_attention_supported`` accepts the rank's local heads (the
  hand-written CUDA kernel on a CUDA tensor, its plain version on a CPU
  tensor, autograd through the plain version backward), else the plain
  blockwise core ``attn_block_update`` / ``finalize_acc``.
* ``ring``: sequence-sharded, for head counts the model axis does not
  divide (qwen2.5-14b): each rank holds a sequence chunk with every
  head, the projection weights are sharded on their input dim and
  gathered on use, and K/V rotate over ``p`` ppermute hops (or one
  all-gather, ``attn_ring_gather_kv``) into the plain blockwise core.
  As in the reference, ring mode never runs the flash kernel.

Serving (prefill and decode) runs in both modes at any tp, and so does
cross-attention.  Prefill emits its K/V in the decode cache's layout,
sequence-sharded ``[B, S/p, kv, hd]``: in head mode an all-to-all from
head shards onto sequence shards when the model axis divides the KV
heads, else the rank's sequence chunk of the replicated K/V
(``_emit_cache_head_mode``); ring mode's K/V are the rank's chunk
already.  Decode gathers the new token's query heads (and its K/V heads
when they are sharded; ring mode gathers its four weights on use and
projects every head, as the reference does), writes each row's K/V into
the rank whose chunk of ``max_len / p`` positions holds ``pos`` (in
place; the reference returns a new, donated cache instead), attends the
plain core over the rank's chunk and merges the ranks' partials with the
flash-decoding log-sum-exp merge: the max over ranks, then the sums of
the rescaled numerators and denominators.  ``wo`` is then a row
projection whose partial sums are reduced into the layout, or, phantom,
reads the rank's feature slice of the merged heads; in ring mode the
gathered ``wo`` gives the whole output, of which an ``fp`` stream keeps
its feature slice.  With one rank the gathers and the merge are the
identity and are skipped.

Cross-attention (the encoder-decoder's ``cross`` sub-layer,
``cross=True`` with the encoder's output ``memory``, full ``[B, S_enc,
d]`` on every rank): q comes from the stream through its site, K and V
from ``memory`` through the ``wk``/``wv`` weights, which are never
phantom (the memory is not feature-sharded); no rotary positions; the
plain core, never the flash kernel (as the reference's ``use_flash``
requires ``memory is None``).  Prefill emits the memory's K/V as the
cross cache, sequence-sharded like the self K/V; decode reads the rank's
chunk of it, with no causal mask and no ``kv_limit``, merges as above
and writes nothing.  M-RoPE (``cfg.rope == "mrope"``) reads
``positions`` as ``[3, B, S]`` (ring mode slices the chunk's on axis 2;
decode broadcasts ``pos`` to ``[3, B, 1]``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import PHANTOM_KINDS
from repro_torch.core.autograd import (all_gather_tiled, all_to_all, pmax,
                                       ppermute, psum)
from repro_torch.kernels.ops import (flash_attention_supported,
                                     flash_attention_vjp,
                                     resolve_kernel_backend)
from repro_torch.models import rope as ropemod
from repro_torch.models.layers import (_fs, dtype_of, from_partial,
                                       gather_on_use, seq_to_feature,
                                       to_full)
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import ParamDecl
from repro_torch.parallel.strategies import site_strategy

NEG_INF = -1e30

_ATTN_SITES = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v",
               "wo": "attn_o"}


def _kv_chunk(cfg, full: int, default: int) -> int:
    """-1 = one block, 0 = the default blockwise size, else explicit."""
    if cfg.attn_kv_chunk == -1:
        return full
    return cfg.attn_kv_chunk or default


def resolve_attn_mode(cfg, axes: MeshAxes) -> str:
    """``cfg.attn_shard`` when it names a mode; ``"auto"`` is head mode
    where the model axis divides the heads and ring mode elsewhere."""
    if cfg.attn_shard in ("head", "ring"):
        return cfg.attn_shard
    return "head" if cfg.num_heads % axes.tp == 0 else "ring"


def attn_site_strategies(cfg, axes: MeshAxes, cross: bool = False):
    """Per-site ProjectionStrategy for the four attention projections.
    A phantom-family spec takes effect only where the factorisation's
    layout allows it (head mode, heads, KV heads and features divisible
    by tp); a site failing the guard takes its dense strategy, and so do
    cross-attention's K/V, which read the replicated encoder memory."""
    d, H, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim()
    p = axes.tp
    ok = (resolve_attn_mode(cfg, axes) == "head"
          and H % p == 0 and kv % p == 0 and d % p == 0)
    dims = {"wq": (d, H * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
            "wo": (H * hd, d)}
    return {name: site_strategy(cfg, _ATTN_SITES[name], ni, no, p,
                                dp=axes.dp,
                                bias=cfg.qkv_bias and name != "wo",
                                fsdp=cfg.fsdp,
                                allow_phantom=ok and not (
                                    cross and name in ("wk", "wv")))
            for name, (ni, no) in dims.items()}


def _is_phantom(st) -> bool:
    return st.kind in PHANTOM_KINDS


def _attn_kernel_backend(sts) -> str:
    """The flash kernel runs only when ALL four q/k/v/o specs resolve to
    the pallas backend (one core, one switch)."""
    backends = {resolve_kernel_backend(st.spec.kernel_backend)
                for st in sts.values()}
    return "pallas" if backends == {"pallas"} else "xla"


def attn_decls(cfg, axes: MeshAxes, cross: bool = False):
    """Ring mode: every weight sharded on its input dim (gathered on
    use), the biases replicated, none sharded over dp under FSDP (as in
    the reference).  Head mode: the sites' decls (FSDP shards their
    weights over dp too); with kv % tp != 0 the KV projections are
    replicated (each rank slices its GQA group's head)."""
    if resolve_attn_mode(cfg, axes) == "ring":
        d, H, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim()
        dec = {name: {"w": ParamDecl(shape, ("tp", None))} for name, shape
               in (("wq", (d, H * hd)), ("wk", (d, kv * hd)),
                   ("wv", (d, kv * hd)), ("wo", (H * hd, d)))}
        if cfg.qkv_bias:
            for name, n in (("wq", H * hd), ("wk", kv * hd),
                            ("wv", kv * hd)):
                dec[name]["b"] = ParamDecl((n,), (), init="zeros")
        return dec
    sts = attn_site_strategies(cfg, axes, cross=cross)
    dec = {name: st.decls() for name, st in sts.items()}
    if cfg.num_kv_heads % axes.tp:
        n = cfg.num_kv_heads * cfg.resolved_head_dim()
        for name in ("wk", "wv"):
            dec[name] = {"w": ParamDecl((cfg.d_model, n), ())}
            if cfg.qkv_bias:
                dec[name]["b"] = ParamDecl((n,), (), init="zeros")
    return dec


# ---------------------------------------------------------------------------
# blockwise online-softmax attention core (the plain path)
# ---------------------------------------------------------------------------

class AttnAcc(NamedTuple):
    num: torch.Tensor    # [B, Sq, KV, Hg, hd] fp32 running numerator
    m: torch.Tensor      # [B, Sq, KV, Hg] running max
    l: torch.Tensor      # [B, Sq, KV, Hg] running denominator


def init_acc(B, Sq, KV, Hg, hd, device=None):
    return AttnAcc(
        torch.zeros((B, Sq, KV, Hg, hd), dtype=torch.float32, device=device),
        torch.full((B, Sq, KV, Hg), NEG_INF, dtype=torch.float32,
                   device=device),
        torch.zeros((B, Sq, KV, Hg), dtype=torch.float32, device=device))


def attn_block_update(acc: AttnAcc, q, k, v, q_pos, kv_pos0: int, *,
                      causal: bool, kv_limit=None, kv_chunk: int = 512,
                      scores_dtype=torch.float32) -> AttnAcc:
    """Accumulate attention of q [B, Sq, KV, Hg, hd] against
    k, v [B, Skv, KV, hd], kv-chunked.  q_pos [B, Sq] are global query
    positions, kv_pos0 the position of k[:, 0]; kv_limit [B] masks kv
    positions >= kv_limit[b] (unwritten cache rows)."""
    B, Skv = k.shape[0], k.shape[1]
    kv_chunk = min(kv_chunk, Skv)
    if Skv % kv_chunk:
        raise ValueError(f"kv length {Skv} does not tile into chunks of "
                         f"{kv_chunk}")
    scale = q.shape[-1] ** -0.5
    num, m, l = acc
    qs = q.to(scores_dtype)
    for i in range(Skv // kv_chunk):
        sl = slice(i * kv_chunk, (i + 1) * kv_chunk)
        ks, vs = k[:, sl].to(scores_dtype), v[:, sl].to(scores_dtype)
        s = torch.einsum("bqkgh,bckh->bqkgc", qs, ks) * scale
        kv_pos = kv_pos0 + i * kv_chunk + torch.arange(kv_chunk,
                                                       device=q.device)
        mask = torch.ones((B, q.shape[1], kv_chunk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (kv_pos[None, None, :] <= q_pos[:, :, None])
        if kv_limit is not None:
            mask = mask & (kv_pos[None, None, :] < kv_limit[:, None, None])
        s = s.masked_fill(~mask[:, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1).to(torch.float32))
        # fully masked rows keep m at NEG_INF; their exp underflows to 0
        p_ = torch.exp(s - m_new[..., None].to(scores_dtype)).float()
        corr = torch.exp(m - m_new)
        num = num * corr[..., None] + torch.einsum(
            "bqkgc,bckh->bqkgh", p_, vs.float())
        l = l * corr + p_.sum(-1)
        m = m_new
    return AttnAcc(num, m, l)


def finalize_acc(acc: AttnAcc, dtype):
    out = acc.num / acc.l.clamp_min(1e-30)[..., None]
    B, Sq, KV, Hg, hd = out.shape
    return out.reshape(B, Sq, KV * Hg, hd).to(dtype)


def _gqa_q(q, KV):
    """[B, S, H, hd] -> [B, S, KV, H/KV, hd]."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, KV, H // KV, hd)


# ---------------------------------------------------------------------------
# main entry
# ---------------------------------------------------------------------------

def attention(cfg, layout: str, params, x, positions, axes: MeshAxes, *,
              kind: str = "prefill", causal: bool = True, cache=None,
              pos=None, return_kv: bool = False, decls=None, memory=None,
              cross: bool = False):
    """Returns (out, new_kv or None): ``out`` the residual shard in
    ``layout``.  kind: train | prefill | decode.  Decode writes into
    ``cache`` ({k, v}, this rank's chunk [B, Smax/p, kv, hd]) in place; a
    cross decode (``cross``) only reads it.  ``memory`` ([B, S_enc, d],
    with ``cross``): the encoder output that K and V project.  ``decls``
    (FSDP): the projections' dp-sharded weights are gathered first, as the
    reference's ``_g`` gathers them (int8 only for the decode's ``wq``
    under ``fsdp_gather_quant``)."""
    params = {name: _fs(params, decls, name, axes,
                        cfg.fsdp_gather_quant and kind == "decode"
                        and name == "wq")
              for name in params}
    if kind == "decode":
        return _attention_decode(cfg, layout, params, x, axes, cache=cache,
                                 pos=pos, cross=cross)
    if resolve_attn_mode(cfg, axes) == "ring" and not cross:
        return _attention_ring(cfg, layout, params, x, positions, axes,
                               causal=causal, return_kv=return_kv)
    return _attention_head(cfg, layout, params, x, positions, axes,
                           causal=causal, return_kv=return_kv,
                           memory=memory if cross else None)


def _site_proj(st, params, x_full, x_shard, nheads, hd, axes, dtype):
    """One head-mode projection through its strategy: phantom reads the
    feature shard, tensor_col the gathered features; both give the
    rank's [..., nheads, hd] heads."""
    if _is_phantom(st):
        y = st.apply(params, x_shard, axes=axes, compute_dtype=dtype)
    else:
        y = st.apply(params, x_full, compute_dtype=dtype)
    return y.reshape(*y.shape[:-1], nheads, hd)


def _replicated_proj(params, x, nheads, hd, dtype):
    """A projection no strategy governs: the replicated KV projection,
    and cross-attention's K/V of the memory (with the rank's shard of a
    column-parallel weight)."""
    y = x.to(dtype) @ params["w"].to(dtype)
    if "b" in params:
        y = y + params["b"].to(dtype)
    return y.reshape(*y.shape[:-1], nheads, hd)


def _attention_head(cfg, layout, params, x, positions, axes, *, causal,
                    return_kv=False, memory=None):
    H, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    p = axes.tp
    dtype = dtype_of(cfg.dtype)
    sts = attn_site_strategies(cfg, axes, cross=memory is not None)
    kv_sharded = kv % p == 0
    # phantom sites read the fp feature shard as it is; the gathered
    # features are made only when a site that reads the stream needs them
    users = ("wq",) if memory is not None else ("wq", "wk", "wv")
    need_full = (not kv_sharded
                 or any(not _is_phantom(sts[n]) for n in users))
    x_shard = x if layout == "fp" else None
    x_full = to_full(x, layout, axes) if need_full else None
    q = _site_proj(sts["wq"], params["wq"], x_full, x_shard, H // p, hd,
                   axes, dtype)
    if memory is not None:
        # cross-attention: K/V of the encoder's memory, no positions
        k, v = (_replicated_proj(params[n], memory,
                                 kv // p if kv_sharded else kv, hd, dtype)
                for n in ("wk", "wv"))
        causal = False
    elif kv_sharded:
        k, v = (_site_proj(sts[n], params[n], x_full, x_shard, kv // p, hd,
                           axes, dtype) for n in ("wk", "wv"))
    else:
        k, v = (_replicated_proj(params[n], x_full, kv, hd, dtype)
                for n in ("wk", "wv"))
    if cfg.rope != "none" and memory is None:
        q = ropemod.rope_for(cfg, q, positions)
        k = ropemod.rope_for(cfg, k, positions)

    B, S = q.shape[0], q.shape[1]
    if kv_sharded:
        k_use, v_use, kv_loc = k, v, kv // p
    else:
        # replicated KV: this rank's query heads share one GQA group
        grp = (axes.tp_rank * kv) // p
        k_use, v_use = (t[:, :, grp:grp + 1].contiguous() for t in (k, v))
        kv_loc = 1
    h_loc = H // p
    use_flash = (memory is None
                 and _attn_kernel_backend(sts) == "pallas"
                 and flash_attention_supported(S, k_use.shape[1], h_loc,
                                               kv_loc))
    if use_flash:
        out = flash_attention_vjp(q, k_use, v_use, causal=causal).to(dtype)
    else:
        acc = init_acc(B, S, kv_loc, h_loc // kv_loc, hd, device=x.device)
        q_pos = torch.arange(S, device=x.device).expand(B, S)
        sdt = torch.bfloat16 if cfg.attn_bf16_scores else torch.float32
        acc = attn_block_update(acc, _gqa_q(q, kv_loc), k_use, v_use, q_pos,
                                0, causal=causal, scores_dtype=sdt,
                                kv_chunk=_kv_chunk(cfg, k_use.shape[1], 512))
        out = finalize_acc(acc, dtype)
    out = out.reshape(B, S, -1)
    # wo carries no bias in head mode, as in the reference
    if _is_phantom(sts["wo"]):
        res = sts["wo"].apply(params["wo"], out, axes=axes,
                              compute_dtype=dtype)
    else:
        res = from_partial(sts["wo"].apply(params["wo"], out,
                                           compute_dtype=dtype),
                           layout, axes)
    new_kv = (_emit_cache_head_mode(k, v, kv_sharded, axes) if return_kv
              else None)
    return res, new_kv


def _emit_cache_head_mode(k, v, kv_sharded: bool, axes: MeshAxes):
    """Prefill-layout K/V -> the decode cache's layout, sequence-sharded
    [B, S/p, kv, hd]: head shards [B, S, kv/p, hd] cross one all-to-all
    onto sequence shards; replicated K/V [B, S, kv, hd] (kv % p != 0)
    are the same on every rank, which keeps its sequence chunk.  The
    identity at p = 1."""
    p = axes.tp
    if p == 1:
        return {"k": k, "v": v}
    if kv_sharded:
        return {"k": all_to_all(k, axes, 1, 2),
                "v": all_to_all(v, axes, 1, 2)}
    C, j = k.shape[1] // p, axes.tp_rank
    return {"k": k[:, j * C:(j + 1) * C].contiguous(),
            "v": v[:, j * C:(j + 1) * C].contiguous()}


def _attention_ring(cfg, layout, params, x, positions, axes, *, causal,
                    return_kv=False):
    """Sequence-sharded attention: rank j attends its chunk of C = S/p
    queries, with every head, against the K/V of every chunk."""
    H, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    p, j = axes.tp, axes.tp_rank
    dtype = dtype_of(cfg.dtype)
    # this rank's sequence chunk with every feature
    if layout == "sp":
        xc = x
    else:
        x_full = to_full(x, layout, axes)
        C = x_full.shape[1] // p
        xc = x_full[:, j * C:(j + 1) * C]
    B, C = xc.shape[0], xc.shape[1]
    wq, wk, wv, wo = (gather_on_use(params[n]["w"], axes)
                      for n in ("wq", "wk", "wv", "wo"))

    def proj(w, b, nheads):
        y = xc.to(dtype) @ w.to(dtype)
        if b is not None:
            y = y + b.to(dtype)
        return y.reshape(B, C, nheads, hd)

    q = proj(wq, params["wq"].get("b"), H)
    k = proj(wk, params["wk"].get("b"), kv)
    v = proj(wv, params["wv"].get("b"), kv)
    chunk_pos = (j * C + torch.arange(C, device=x.device)).expand(B, C)
    if cfg.rope != "none":
        pos_c = (positions[:, :, j * C:(j + 1) * C] if cfg.rope == "mrope"
                 else chunk_pos)
        q = ropemod.rope_for(cfg, q, pos_c)
        k = ropemod.rope_for(cfg, k, pos_c)

    qg = _gqa_q(q, kv)
    acc = init_acc(B, C, kv, H // kv, hd, device=x.device)
    sdt = torch.bfloat16 if cfg.attn_bf16_scores else torch.float32
    if cfg.attn_ring_gather_kv:
        # one all-gather of K and V, stacked by rank: global sequence
        # order, since rank j holds chunk j
        k_all, v_all = (all_gather_tiled(t, axes, 1) for t in (k, v))
        acc = attn_block_update(acc, qg, k_all, v_all, chunk_pos, 0,
                                causal=causal, scores_dtype=sdt,
                                kv_chunk=_kv_chunk(cfg, p * C, 512))
    else:
        # hop s holds the K/V chunk of rank (j - s) mod p
        perm = [(s, (s + 1) % p) for s in range(p)]
        k_rot, v_rot = k, v
        for s in range(p):
            acc = attn_block_update(acc, qg, k_rot, v_rot, chunk_pos,
                                    ((j - s) % p) * C, causal=causal,
                                    scores_dtype=sdt,
                                    kv_chunk=_kv_chunk(cfg, C, 512))
            if s < p - 1:
                k_rot = ppermute(k_rot, axes, perm)
                v_rot = ppermute(v_rot, axes, perm)
    out = finalize_acc(acc, dtype).reshape(B, C, H * hd)
    z = out @ wo.to(dtype)                                  # [B, C, d]
    res = z if layout == "sp" else seq_to_feature(z, axes)
    # K/V are sequence-sharded already: the decode cache's layout
    return res, ({"k": k, "v": v} if return_kv else None)


def _attention_decode(cfg, layout, params, x, axes, *, cache, pos,
                      cross=False):
    H, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    p, j = axes.tp, axes.tp_rank
    dtype = dtype_of(cfg.dtype)
    ring = resolve_attn_mode(cfg, axes) == "ring"
    sts = attn_site_strategies(cfg, axes, cross=cross)
    # the new token's features: full for the tensor sites, the rank's
    # shard for the phantom ones (every rank needs every head: the
    # projections' head shards are gathered, a few rows each)
    x_full = to_full(x, layout, axes)
    x_shard = x if layout == "fp" else x_full
    B = x.shape[0]
    if ring:
        # the ring-sharded weights gathered on use: every rank projects
        # the new token's heads whole
        def proj(name, nheads):
            w = gather_on_use(params[name]["w"], axes)
            return _replicated_proj({**params[name], "w": w}, x_full,
                                    nheads, hd, dtype)
        q = proj("wq", H)
        if not cross:
            kn, vn = proj("wk", kv), proj("wv", kv)
    else:
        q = _site_proj(sts["wq"], params["wq"], x_full, x_shard, H // p,
                       hd, axes, dtype)                       # [B,1,H/p,hd]
        if p > 1:
            q = all_gather_tiled(q, axes, 2)
        if not cross and kv % p == 0:
            kn, vn = (_site_proj(sts[n], params[n], x_full, x_shard,
                                 kv // p, hd, axes, dtype)
                      for n in ("wk", "wv"))
            if p > 1:
                kn, vn = (all_gather_tiled(t, axes, 2) for t in (kn, vn))
        elif not cross:
            kn, vn = (_replicated_proj(params[n], x_full, kv, hd, dtype)
                      for n in ("wk", "wv"))

    pos = pos.reshape(B).to(torch.long)
    if cfg.rope != "none":
        # as in the reference, a cross decode rotates its q too
        at = (pos[None, :, None].expand(3, B, 1) if cfg.rope == "mrope"
              else pos[:, None])
        q = ropemod.rope_for(cfg, q, at)
        if not cross:
            kn = ropemod.rope_for(cfg, kn, at)

    # --- cache update, in place: the rank whose chunk of ``chunk``
    # positions holds a row's ``pos`` writes that row's new K/V ---------
    ck, cv = cache["k"], cache["v"]
    chunk = ck.shape[1]
    if not cross:
        local = pos - j * chunk
        in_range = ((local >= 0) & (local < chunk))[:, None, None]
        widx = local.clamp(0, chunk - 1)
        rows = torch.arange(B, device=x.device)
        ck[rows, widx] = torch.where(in_range, kn[:, 0].to(ck.dtype),
                                     ck[rows, widx])
        cv[rows, widx] = torch.where(in_range, vn[:, 0].to(cv.dtype),
                                     cv[rows, widx])

    # --- partial attention over the rank's chunk; a cross read weighs
    # every row, the zero rows past the encoder's length among them, as
    # the reference's does
    acc = init_acc(B, 1, kv, H // kv, hd, device=x.device)
    acc = attn_block_update(
        acc, _gqa_q(q, kv), ck, cv, pos[:, None], j * chunk,
        causal=not cross, kv_limit=None if cross else pos + 1,
        kv_chunk=_kv_chunk(cfg, chunk, min(1024, chunk)),
        scores_dtype=(torch.bfloat16 if cfg.attn_bf16_scores
                      else torch.float32))
    num, den = acc.num, acc.l
    if p > 1:
        # the flash-decoding merge of the ranks' partials
        w = torch.exp(acc.m - pmax(acc.m, axes))
        num = psum(num * w[..., None], axes)
        den = psum(den * w, axes)
    out = (num / den.clamp_min(1e-30)[..., None])
    out = out.reshape(B, 1, H * hd).to(dtype)

    if ring:
        # wo gathered too: every rank's product is the whole output, of
        # which the stream keeps its layout's part
        z = out @ gather_on_use(params["wo"]["w"], axes).to(dtype)
        if layout == "fp" and p > 1:
            fsh = z.shape[-1] // p
            z = z[..., j * fsh:(j + 1) * fsh]
        return z, cache
    # --- output projection: each rank's slice of the merged heads
    nshard = (H * hd) // p
    mine = out[..., j * nshard:(j + 1) * nshard]
    if _is_phantom(sts["wo"]):
        return sts["wo"].apply(params["wo"], mine, axes=axes,
                               compute_dtype=dtype), cache
    z = sts["wo"].apply(params["wo"], mine, compute_dtype=dtype)
    return from_partial(z, layout, axes), cache
