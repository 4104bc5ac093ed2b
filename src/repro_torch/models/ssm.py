"""Mamba2 (SSD, state-space duality) blocks: the port of the reference's
``models/ssm.py``.

Chunked SSD (arXiv:2405.21060, section 6): the sequence is cut into
chunks of Q tokens.  Inside a chunk the quadratic (attention-like) form;
across chunks the ``[hd x N]`` state of each head, carried by a loop over
the chunks where the reference scans them.  The scan is plain torch
ops, as the reference's is XLA outside any Pallas kernel.

Sharding: ``d_inner`` (and so the SSD heads) over the model axis; the
B/C projection (one group) replicated; the scan local to each head.
Phantom applies only to the in (``wz``, ``wx``) and out projections:
the scan has no cross-rank weight block to factorise.  The short causal
conv runs on x only, as in the reference.

Two differences from the reference, both where its results are wrong
(ROADMAP.md queue 3):

* ``_ssd_chunked`` masks the intra-chunk exponent ``cum_i - cum_j``
  before the ``exp`` (``-inf`` where j > i).  The reference takes the
  ``exp`` of every pair and masks after: past an exponent of about 88
  the masked triangle overflows to inf, and its backward pass computes
  ``0 * inf = NaN``.  The forward values are the same; the port's
  gradient stays finite where the reference's is NaN.
* Prefill keeps the last ``conv_width - 1`` rows of the left-padded x
  as the conv state.  For a prompt of at least that many tokens these
  are the reference's rows; for a shorter one the reference keeps fewer
  rows, which its cache merge broadcasts over the missing ones.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import PHANTOM_KINDS
from repro_torch.core.autograd import psum
from repro_torch.models.layers import (dtype_of, from_partial,
                                       gather_tree_fsdp, to_full)
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import ParamDecl
from repro_torch.parallel.strategies import site_strategy


def ssm_dims(cfg):
    """(d_inner, SSD heads H, state N, head dim hd)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.d_state, s.head_dim


def ssm_site_strategies(cfg, axes: MeshAxes):
    """The strategies of the in (z and x) and out projections: phantom
    only where the model axis divides d and d_inner."""
    d = cfg.d_model
    d_inner = cfg.ssm.expand * d
    p = axes.tp
    ok = d_inner % p == 0 and d % p == 0

    def mk(site, n_in, n_out):
        return site_strategy(cfg, site, n_in, n_out, p, dp=axes.dp,
                             bias=False, fsdp=cfg.fsdp, allow_phantom=ok)
    return {"in": mk("ssm_in", d, d_inner), "out": mk("ssm_out", d_inner, d)}


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------

def ssm_decls(cfg, axes: MeshAxes):
    d = cfg.d_model
    d_inner, H, N, _ = ssm_dims(cfg)
    s = cfg.ssm
    if H % axes.tp:
        raise ValueError(f"{H} SSD heads do not divide over tp={axes.tp}")
    sts = ssm_site_strategies(cfg, axes)
    return {
        "wz": sts["in"].decls(),
        "wx": sts["in"].decls(),
        "wbc": {"w": ParamDecl((d, 2 * s.ngroups * N), (),
                               scale=d ** -0.5)},
        "wdt": {"w": ParamDecl((d, H), (None, "tp"), scale=d ** -0.5),
                "b": ParamDecl((H,), ("tp",), init="zeros")},
        "out": sts["out"].decls(),
        "A_log": ParamDecl((H,), ("tp",), init="zeros"),
        "Dskip": ParamDecl((H,), ("tp",), init="ones"),
        "conv_w": ParamDecl((s.conv_width, d_inner), (None, "tp"),
                            scale=s.conv_width ** -0.5),
        "norm_scale": ParamDecl((d_inner,), ("tp",), init="ones"),
    }


def ssm_cache_shape(cfg, axes: MeshAxes, batch: int):
    """The decode state of one layer, global shapes and specs: the conv
    rolling buffer and the SSD state."""
    d_inner, H, N, hd = ssm_dims(cfg)
    return {"conv": ((batch, cfg.ssm.conv_width - 1, d_inner),
                     ("dp", None, "tp")),
            "ssm": ((batch, H, hd, N), ("dp", "tp", None, None))}


# ---------------------------------------------------------------------------
# chunked SSD (train / prefill) and the one-token step (decode)
# ---------------------------------------------------------------------------

def _pick_chunk(S: int, chunk: int) -> int:
    """The largest divisor of S that is at most ``chunk`` (ragged
    exact-length prompts: a prime S gives Q = S)."""
    q = min(chunk, S)
    while S % q:
        q -= 1
    return q


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """x [B, S, H, hd]; dt [B, S, H] (> 0); A [H] (< 0); Bm, Cm
    [B, S, N].  Returns (y [B, S, H, hd], final state [B, H, hd, N])."""
    Bsz, S, H, hd = x.shape
    N = Bm.shape[-1]
    Q = _pick_chunk(S, chunk)
    nc = S // Q
    xr = x.reshape(Bsz, nc, Q, H, hd)
    dtr = dt.reshape(Bsz, nc, Q, H)
    Br = Bm.reshape(Bsz, nc, Q, N)
    Cr = Cm.reshape(Bsz, nc, Q, N)

    dA = dtr * A                                          # [B,nc,Q,H] < 0
    cum = torch.cumsum(dA, dim=2)                         # inclusive
    # intra-chunk: scores[i, j] = C_i.B_j exp(cum_i - cum_j) dt_j, i >= j;
    # the exponent masked before the exp (module docstring)
    CB = torch.einsum("bnim,bnjm->bnij", Cr, Br)          # [B,nc,Q,Q]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Q,Q,H]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(diff.masked_fill(~tri[:, :, None], float("-inf")))
    scores = CB[..., None] * decay * dtr[:, :, None, :, :]  # [B,nc,i,j,H]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", scores, xr)

    # chunk-local end states: sum_j exp(cum_Q - cum_j) dt_j B_j (x) x_j
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dtr      # [B,nc,Q,H]
    states = torch.einsum("bnjh,bnjm,bnjhp->bnhpm", w_end, Br, xr)

    # the recurrence over the chunks: each chunk reads the state before it
    chunk_decay = torch.exp(dA.sum(2))                    # [B,nc,H]
    s = (initial_state if initial_state is not None else
         torch.zeros((Bsz, H, hd, N), dtype=torch.float32, device=x.device))
    prev = []
    for n in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, n, :, None, None] + states[:, n]
    prev_states = torch.stack(prev, 1)                    # [B,nc,H,hd,N]

    # y_inter[i] = exp(cum_i) C_i . S_prev
    y_inter = torch.einsum("bnim,bnhpm,bnih->bnihp", Cr, prev_states,
                           torch.exp(cum))
    return (y_intra + y_inter).reshape(Bsz, S, H, hd), s


def _ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One token.  state [B, H, hd, N]; x [B, H, hd]; dt [B, H]; Bm, Cm
    [B, N] -> (y [B, H, hd], new state)."""
    dA = torch.exp(dt * A[None, :])                       # [B,H]
    dBx = torch.einsum("bh,bm,bhp->bhpm", dt, Bm, x)
    s_new = state * dA[:, :, None, None] + dBx
    return torch.einsum("bm,bhpm->bhp", Cm, s_new), s_new


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def _in_projs(params, xin, axes, dtype, st_in):
    """z and x through the in site's strategy: phantom reads the feature
    shard, tensor_col the full features."""
    return (st_in.apply(params["wz"], xin, axes=axes, compute_dtype=dtype),
            st_in.apply(params["wx"], xin, axes=axes, compute_dtype=dtype))


def _small_projs(params, x_full, dtype):
    """B, C (replicated projection, fp32) and dt = softplus(x wdt + b)
    from the full features [..., d]."""
    bc = x_full.to(dtype) @ params["wbc"]["w"].to(dtype)
    Bm, Cm = bc.float().chunk(2, dim=-1)                  # one group
    dt_raw = x_full.to(dtype) @ params["wdt"]["w"].to(dtype)
    v = dt_raw.float() + params["wdt"]["b"].float()
    # jax.nn.softplus: logaddexp(v, 0)
    return Bm, Cm, torch.logaddexp(v, torch.zeros_like(v))


def _gate_norm_out(cfg, layout, params, y, z, axes, dtype, st_out):
    """Gate by silu(z), RMSNorm over the local channels (the mean summed
    over the model axis, over p), then the out projection into the
    residual layout."""
    y = y * F.silu(z.float())
    ms = psum((y * y).mean(-1, keepdim=True), axes) / axes.tp
    y = (y * torch.rsqrt(ms + cfg.norm_eps)
         * params["norm_scale"].float()).to(dtype)
    if st_out.kind in PHANTOM_KINDS:
        return st_out.apply(params["out"], y, axes=axes, compute_dtype=dtype)
    return from_partial(st_out.apply(params["out"], y, compute_dtype=dtype),
                        layout, axes)


def ssm_apply(cfg, layout: str, params, x, axes: MeshAxes, decls=None, *,
              kind: str = "train", cache=None):
    """x: the residual shard -> (residual shard, new cache or None).
    kind: train | prefill (returns the cache {"conv": the raw pre-conv
    x's last conv_width - 1 rows in ``cfg.dtype``, "ssm": the final
    state in fp32}) | decode (one token against ``cache``).  ``decls``
    (FSDP): the block's dp-sharded weights are gathered first."""
    d_inner, H, N, hd = ssm_dims(cfg)
    p = axes.tp
    dtype = dtype_of(cfg.dtype)
    H_loc, d_loc = H // p, d_inner // p
    sts = ssm_site_strategies(cfg, axes)
    phantom_in = sts["in"].kind in PHANTOM_KINDS
    s = cfg.ssm
    params = gather_tree_fsdp(params, decls, axes, cfg.fsdp_gather_quant)
    if kind == "decode":
        return _ssm_decode(cfg, layout, params, x, axes, sts, cache=cache)

    # --- input projections ----------------------------------------------
    x_full = to_full(x, layout, axes)                      # [B, S, d]
    z, xs = _in_projs(params, x if phantom_in else x_full, axes, dtype,
                      sts["in"])
    Bsz, S = x_full.shape[0], x_full.shape[1]
    xs = xs.reshape(Bsz, S, d_loc)
    z = z.reshape(Bsz, S, d_loc)
    Bm, Cm, dt = _small_projs(params, x_full, dtype)

    # --- the short causal conv on x (local channels) ----------------------
    conv_w = params["conv_w"]                              # [cw, d_loc]
    xpad = F.pad(xs, (0, 0, s.conv_width - 1, 0))
    xc = sum(xpad[:, i:i + S] * conv_w[i][None, None, :]
             for i in range(s.conv_width))
    xc = F.silu(xc.float())

    # --- SSD ---------------------------------------------------------------
    A = -torch.exp(params["A_log"].float())                # [H_loc]
    xh = xc.reshape(Bsz, S, H_loc, hd)
    y, final_state = _ssd_chunked(xh, dt, A, Bm, Cm, s.chunk)
    y = y + params["Dskip"].float()[None, None, :, None] * xh
    res = _gate_norm_out(cfg, layout, params, y.reshape(Bsz, S, d_loc), z,
                         axes, dtype, sts["out"])
    if kind != "prefill":
        return res, None
    return res, {"conv": xpad[:, S:].to(dtype),            # raw pre-conv x
                 "ssm": final_state.float()}


def _ssm_decode(cfg, layout, params, x, axes, sts, *, cache):
    d_inner, H, N, hd = ssm_dims(cfg)
    dtype = dtype_of(cfg.dtype)
    H_loc, d_loc = H // axes.tp, d_inner // axes.tp

    x_full = to_full(x, layout, axes)                      # [B, 1, d]
    xin = x if sts["in"].kind in PHANTOM_KINDS else x_full
    z, xs = _in_projs(params, xin, axes, dtype, sts["in"])
    Bsz = x_full.shape[0]
    xs = xs.reshape(Bsz, d_loc)
    z = z.reshape(Bsz, d_loc)
    Bm, Cm, dt = _small_projs(params, x_full[:, 0], dtype)

    # the conv over the rolling state and the new token
    hist = torch.cat([cache["conv"].to(dtype), xs[:, None, :]], dim=1)
    xc = F.silu((hist * params["conv_w"][None, :, :]).sum(1).float())

    A = -torch.exp(params["A_log"].float())
    xh = xc.reshape(Bsz, H_loc, hd)
    y, new_state = _ssd_decode_step(cache["ssm"], xh, dt, A, Bm, Cm)
    y = y + params["Dskip"].float()[None, :, None] * xh
    res = _gate_norm_out(cfg, layout, params, y.reshape(Bsz, 1, d_loc),
                         z[:, None, :], axes, dtype, sts["out"])
    return res, {"conv": hist[:, 1:].to(dtype),
                 "ssm": new_state.to(cache["ssm"].dtype)}
