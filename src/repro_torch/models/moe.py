"""Mixture-of-Experts with top-k routing and capacity-based, index-driven
dispatch: the port of the reference's ``models/moe.py``.  Tokens go to
their experts through an index table (a gather and, in the backward
pass, its scatter-add), not a one-hot einsum, whose cost grows with the
square of the tokens.

Two ways to partition the experts over the model axis:

* ``expert`` (olmoe 64e): the expert dim sharded; one all-to-all moves
  the capacity slots to the ranks that own their experts (and in the
  ``fp`` layout un-shards the features at the same time), its inverse
  moves the outputs back.
* ``tensor`` (granite 40e, E % tp != 0): every expert's d_ff sharded;
  the tokens are gathered once (the Megatron all-gather) and the expert
  outputs reduce-scattered back.

The routing is the same on every rank (a replicated router, or the
partial logits summed over the model axis), so the dispatch tables
agree without communication.  At tp = 1 every collective here is the
identity and none is issued.

The expert GEMMs, the routing, the dispatch and the combine are plain
torch ops: the reference computes them with XLA ops, outside any Pallas
kernel.  Phantom experts (the ``moe_experts`` site, tensor partition)
run each expert's projections through ``core/phantom.py:
phantom_apply``, and so through the phantom kernels on the kernel
backend.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import PHANTOM_KINDS, PhantomConfig
from repro_torch.core.autograd import all_to_all, psum
from repro_torch.core.phantom import phantom_apply, phantom_decls
from repro_torch.models.layers import (_require, dtype_of, from_partial,
                                       gather_tree_fsdp, residual_layout,
                                       to_full)
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import ParamDecl, stack


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------

def moe_expert_spec(cfg, axes: MeshAxes):
    """The ``moe_experts`` site's ProjectionSpec where the experts are
    phantom-factorised, else None (dense experts).  Phantom experts need
    the tensor partition (each expert's d_ff sharded over the model
    axis), widths the model axis divides, and no FSDP (the stacked
    phantom decls carry no dp-sharded dim)."""
    m = cfg.moe
    spec = cfg.projection_spec("moe_experts")
    if (spec.kind in PHANTOM_KINDS and m.partition == "tensor"
            and cfg.d_model % axes.tp == 0
            and m.d_ff_expert % axes.tp == 0 and not cfg.fsdp):
        return spec
    return None


def moe_decls(cfg, axes: MeshAxes):
    """Router ``[d, E]`` (scale d^-1/2) and the expert weights
    ``[E, d, ff]`` / ``[E, ff, d]``.  Expert partition: the expert dim
    sharded, the router row-sharded in the ``fp`` layout (its partial
    logits summed) and replicated otherwise.  Tensor partition: each
    expert's d_ff sharded, the router replicated.  Phantom experts: each
    projection the E-stacked phantom decls (``stack(phantom_decls(...),
    E)``).  FSDP also shards each dense expert weight's d over dp."""
    _require(cfg)
    m = cfg.moe
    d, E, ff = cfg.d_model, m.num_experts, m.d_ff_expert
    fs = "dp" if cfg.fsdp else None
    pspec = moe_expert_spec(cfg, axes)
    router = ParamDecl((d, E), (), scale=d ** -0.5)
    if pspec is not None:
        def mk(ni, no):
            return stack(phantom_decls(ni, no, pspec.k, axes.tp,
                                       bias=False), E)
        return {"router": {"w": router}, "w_up": mk(d, ff),
                "w_down": mk(ff, d), "w_gate": mk(d, ff)}
    if m.partition == "expert":
        if E % axes.tp:
            raise ValueError(f"{E} experts do not divide over tp="
                             f"{axes.tp}: use partition='tensor'")
        if residual_layout(cfg, "train") == "fp":
            router = ParamDecl((d, E), ("tp", None), scale=d ** -0.5)
        spec_in, spec_out = ("tp", fs, None), ("tp", None, fs)
    else:
        spec_in, spec_out = (None, fs, "tp"), (None, "tp", fs)
    return {"router": {"w": router},
            "w_up": {"w": ParamDecl((E, d, ff), spec_in)},
            "w_down": {"w": ParamDecl((E, ff, d), spec_out)},
            "w_gate": {"w": ParamDecl((E, d, ff), spec_in)}}


# ---------------------------------------------------------------------------
# routing: top-k and capacity assignment (index-based)
# ---------------------------------------------------------------------------

def route(logits, top_k: int, capacity: int):
    """logits [T, E] -> (disp_tok [E, C] token ids, disp_ok [E, C] slot
    used, gates [T, K] normalised gate weights, combine_slot [T, K] flat
    slot ids, -1 where dropped).

    An entry's position in its expert is the count of earlier entries
    for that expert in (token, top-k rank) order, ranks in descending
    probability (``torch.topk`` sorts as ``lax.top_k`` does); entries
    past the capacity are dropped.  Dropped entries write to the
    sentinel row ``E * C`` of the tables, which is cut off."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, exp_idx = torch.topk(probs, top_k, dim=-1)     # [T, K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    ohf = F.one_hot(exp_idx.reshape(-1), E)                   # [T*K, E]
    pos = ((ohf.cumsum(0) - ohf) * ohf).sum(-1)               # rank in expert
    e_flat = exp_idx.reshape(-1)
    keep = pos < capacity
    slot = torch.where(keep, e_flat * capacity + pos, E * capacity)
    tok_ids = torch.arange(T, device=logits.device).repeat_interleave(top_k)
    disp_tok = torch.zeros(E * capacity + 1, dtype=torch.long,
                           device=logits.device).scatter_(0, slot, tok_ids)
    disp_ok = torch.zeros(E * capacity + 1, dtype=torch.bool,
                          device=logits.device).scatter_(0, slot, keep)
    combine_slot = torch.where(keep, slot, -1).reshape(T, top_k)
    return (disp_tok[:-1].reshape(E, capacity),
            disp_ok[:-1].reshape(E, capacity), gate_vals, combine_slot)


def moe_capacity(tokens: int, E: int, top_k: int, cf: float) -> int:
    """Slots an expert takes: ``tokens * top_k * cf / E``, rounded up to
    a multiple of 8, at least 8."""
    c = int(tokens * top_k * cf / E)
    return max(8, c + (-c) % 8)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def moe_apply(cfg, layout: str, params, x, axes: MeshAxes, decls=None):
    """Residual shard -> (residual shard in the same layout, aux loss).
    ``decls`` (FSDP): the experts' dp-sharded weights are gathered
    first (the router is never dp-sharded)."""
    params = gather_tree_fsdp(params, decls, axes, cfg.fsdp_gather_quant)
    if cfg.moe.partition == "expert":
        return _moe_expert_partition(cfg, layout, params, x, axes)
    return _moe_tensor_partition(cfg, layout, params, x, axes)


def _expert_ffn(cfg, params, xin, dtype):
    """xin [E_loc, C', d] -> [E_loc, C', d]: the batched SwiGLU expert
    GEMMs."""
    w_gate, w_up, w_down = (params[n]["w"].to(dtype)
                            for n in ("w_gate", "w_up", "w_down"))
    h = F.silu(torch.bmm(xin, w_gate)) * torch.bmm(xin, w_up)
    return torch.bmm(h, w_down)


def _combine(yout, gates, combine_slot):
    """Expert outputs [E, C, d'] -> each token's gate-weighted sum of its
    kept top-k slots [T, d']."""
    E, C, dd = yout.shape
    T, K = combine_slot.shape
    ok = combine_slot >= 0
    slots = torch.where(ok, combine_slot, 0)
    picked = yout.reshape(E * C, dd)[slots.reshape(-1)].reshape(T, K, dd)
    w = torch.where(ok, gates, 0.0)[..., None].to(picked.dtype)
    return (picked * w).sum(1)


def _route_and_gather(cfg, logits, xf, dtype):
    """Route the tokens ``xf`` [T, d'] on ``logits`` [T, E] and gather
    them into the expert slots [E, C, d'] (zero where no token took the
    slot).  Returns (xin, gates, combine_slot)."""
    m = cfg.moe
    T, E = logits.shape
    C = moe_capacity(T, E, m.top_k, m.capacity_factor)
    disp_tok, disp_ok, gates, combine_slot = route(logits, m.top_k, C)
    xin = xf[disp_tok.reshape(-1)]
    xin = torch.where(disp_ok.reshape(-1, 1), xin, 0)
    return xin.reshape(E, C, -1).to(dtype), gates, combine_slot


def _moe_expert_partition(cfg, layout, params, x, axes):
    """Experts sharded over the model axis, in three residual layouts:

    fp  -- x [B, S, d/p]: all tokens, a feature shard.  The partial
           logits are summed; one all-to-all moves the slots to the
           experts' owners and un-shards the features.
    sp  -- x [B, S/p, d]: this rank's tokens, every feature.  The
           all-to-all swaps the expert dim against the source rank.
    rep -- x [B, S, d] replicated (dense decode): each rank runs its own
           experts, and a psum combines them.
    """
    dtype = dtype_of(cfg.dtype)
    p, E = axes.tp, cfg.moe.num_experts
    xf = x.reshape(-1, x.shape[-1])
    logits = xf.float() @ params["router"]["w"].float()       # [T, E]
    if layout == "fp":
        logits = psum(logits, axes)
    xin, gates, combine_slot = _route_and_gather(cfg, logits, xf, dtype)
    if layout == "fp":
        # split experts, concat features: [E/p, C, d]
        xin = all_to_all(xin, axes, 0, 2)
        yout = all_to_all(_expert_ffn(cfg, params, xin, dtype), axes, 2, 0)
    elif layout == "sp":
        # split experts, concat capacity (every source rank's): [E/p, pC, d]
        xin = all_to_all(xin, axes, 0, 1)
        yout = all_to_all(_expert_ffn(cfg, params, xin, dtype), axes, 1, 0)
    elif p == 1:
        yout = _expert_ffn(cfg, params, xin, dtype)
    else:   # rep: each rank serves its slice of the experts
        j, E_loc = axes.tp_rank, E // p
        y_loc = _expert_ffn(cfg, params, xin[j * E_loc:(j + 1) * E_loc],
                            dtype)
        yout = psum(F.pad(y_loc, (0, 0, 0, 0, j * E_loc,
                                  (p - 1 - j) * E_loc)), axes)
    y = _combine(yout, gates, combine_slot)
    return y.reshape(x.shape), _aux_loss(logits, E)


def _expert_ffn_phantom(cfg, pspec, params, xin, axes, dtype):
    """Phantom-factorised experts (tensor partition): xin [E, C, d] every
    feature -> the feature shard [E, C, d/p].  Each expert's three
    projections go through ``phantom_apply`` one expert at a time (the
    reference vmaps it over the experts, batching their ghost
    gathers).  The site's kernel backend reaches ``phantom_apply`` (the
    reference's ``PhantomConfig`` here leaves it at ``"xla"``; the two
    compute the same function)."""
    pp = PhantomConfig(k=pspec.k, variant=pspec.variant,
                       include_self_term=pspec.include_self_term,
                       kernel_backend=pspec.kernel_backend)
    dloc = xin.shape[-1] // axes.tp
    xloc = xin[..., axes.tp_rank * dloc:(axes.tp_rank + 1) * dloc]

    def pa(pe, xe):
        return torch.stack([
            phantom_apply(pp, {n: t[e] for n, t in pe.items()}, xe[e], axes,
                          compute_dtype=dtype)
            for e in range(xe.shape[0])])

    h = F.silu(pa(params["w_gate"], xloc)) * pa(params["w_up"], xloc)
    return pa(params["w_down"], h)                            # [E, C, d/p]


def _moe_tensor_partition(cfg, layout, params, x, axes):
    """Tokens gathered once (the Megatron all-gather), every expert's d_ff
    sharded; the partial outputs reduce-scatter back into the layout.
    Phantom experts (``fp`` layout) return the feature shard itself, so
    only the k-wide ghosts cross the mesh."""
    dtype = dtype_of(cfg.dtype)
    E = cfg.moe.num_experts
    x_full = to_full(x, layout, axes)                         # [B, S, d]
    B, S, d = x_full.shape
    xf = x_full.reshape(B * S, d)
    logits = xf.float() @ params["router"]["w"].float()
    xin, gates, combine_slot = _route_and_gather(cfg, logits, xf, dtype)
    pspec = moe_expert_spec(cfg, axes)
    if pspec is not None:
        if layout != "fp":
            raise ValueError(f"phantom experts keep the features sharded; "
                             f"layout {layout!r}")
        yout = _expert_ffn_phantom(cfg, pspec, params, xin, axes, dtype)
    else:
        yout = _expert_ffn(cfg, params, xin, dtype)   # partial over d_ff
    y = _combine(yout, gates, combine_slot).reshape(B, S, -1)
    if pspec is None:
        y = from_partial(y, layout, axes)
    return y, _aux_loss(logits, E)


def _aux_loss(logits, E: int):
    """The Switch-style load-balancing loss ``E * sum_e f_e * P_e``: f the
    share of tokens whose top-1 is expert e, P the mean router
    probability of e."""
    probs = torch.softmax(logits.float(), dim=-1)
    f = F.one_hot(probs.argmax(-1), E).float().mean(0)
    return E * (f * probs.mean(0)).sum()
