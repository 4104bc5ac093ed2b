"""Predicted per-step costs of the paper-FFN step, summed from the very
``ProjectionStrategy`` objects that execute: the port of the FFN half of
the JAX package's ``telemetry/predict.py``, with the same keys and
formulas, so the two packages' reports compare key by key.

Everything here is a thin sum over ``strategy.flops()`` /
``strategy.comm_events()`` (the account ``core/energy.py`` prices, paper
Eqns. 1-2, 24-26) plus the ring-model conversion of a ``CommEvent`` to
wire bytes, which is the SAME formula the measured side applies to the
collectives the ranks issued (``telemetry/counted.py``):

  all_gather      m·(p-1)·itemsize   (gathered result = m·p, ring wire
                                      = result·(p-1)/p)
  reduce_scatter  m·(p-1)·itemsize   (result = m, ring wire = result·(p-1))
  all_reduce      2·m·(p-1)/p·itemsize

with ``m`` the per-rank message in floats (the ``CommEvent`` unit).

The pipelined step's account (``pipeline_ffn_step_events`` /
``pipeline_ffn_step_prediction``) is the reference's, both accounts, and
so is one serving step's (``serve_site_strategies`` ..
``serve_step_prediction``), the account the router prices candidates
with, and the fleet's KV-page transfer (``kv_cache_token_bytes``,
``kv_transfer_prediction``), and the elastic runtime's recovery
account (``recovery_account``).
"""
from __future__ import annotations

import math
from typing import List, Sequence

from repro_torch.core.energy import (FRONTIER_A_W, FRONTIER_B_W,
                                     H100_PEAK_FLOPS_FP32,
                                     PAPER_COLLECTIVE_FITS, comm_time_us,
                                     costs_from_strategies,
                                     energy_per_iteration)
from repro_torch.parallel.strategies.base import CommEvent

FLOAT_BYTES = 4.0


def event_wire_bytes(ev: CommEvent, p: int,
                     itemsize: float = FLOAT_BYTES) -> float:
    """Per-device ring wire bytes for one strategy collective — the
    prediction the measured wire bytes are compared to."""
    if p <= 1:
        return 0.0
    m = ev.m_floats * itemsize
    if ev.collective == "all_gather":
        return m * (p - 1)
    if ev.collective == "reduce_scatter":
        return m * (p - 1)
    if ev.collective == "all_reduce":
        return 2.0 * m * (p - 1) / p
    if ev.collective == "all_to_all":
        return m * (p - 1) / p
    return m                                  # collective_permute: one hop


def events_for(strategies: Sequence, batch: int,
               training: bool = True) -> List[CommEvent]:
    """All collectives the strategies issue per pass; inference drops the
    backward-phase events (no gradient collectives at serving time)."""
    out = []
    for st in strategies:
        for ev in st.comm_events(batch):
            if not training and ev.phase == "bwd":
                continue
            out.append(ev)
    return out


def strategy_prediction(strategies: Sequence, p: int, L: int, batch: int,
                        *, training: bool = True,
                        peak_flops: float = H100_PEAK_FLOPS_FP32,
                        fits=None, A: float = FRONTIER_A_W,
                        B: float = FRONTIER_B_W,
                        itemsize: float = FLOAT_BYTES) -> dict:
    """The ledger's ``predicted`` block for a step executing each of
    ``strategies`` once per layer, ``L`` layers.

    Keys are aligned with ``MeasuredCosts.measured_fields()`` so the
    ledger can ratio them directly; the energy projection applies the
    paper's E = p·(A·α + B·β) per iteration.
    """
    alpha_s, beta_s = costs_from_strategies(
        strategies, p, L, batch, peak_flops, fits, training=training)
    events = events_for(strategies, batch, training)
    wire = sum(event_wire_bytes(ev, p, itemsize) for ev in events) * L
    m_floats = sum(ev.m_floats for ev in events) * L
    comm_us = sum(comm_time_us(ev.collective, ev.m_floats, p, fits)
                  for ev in events) * L
    return {
        "flops_per_device": alpha_s * peak_flops,
        "collective_wire_bytes_per_device": wire,
        "collective_m_floats": m_floats,
        "comm_us": comm_us,
        "alpha_s": alpha_s,
        "beta_s": beta_s,
        "energy_j_per_iter": energy_per_iteration(alpha_s, beta_s, p,
                                                  A, B),
        "training": training,
        "model": "E = nu*p*(A*alpha + B*beta)",
        "A_w": A, "B_w": B,
        "peak_flops": peak_flops,
    }


def serve_site_strategies(cfg, p: int, dp: int = 1) -> List:
    """The per-layer ProjectionStrategy objects a transformer serving
    config executes: the four attention projections plus the MLP sites
    (the same objects ``models/attention.py`` / ``models/layers.py``
    instantiate at run time, so the predicted account prices exactly
    what executes).  Dense/attention families only — recurrent families
    would need their own site list."""
    from repro_torch.models.attention import attn_site_strategies
    from repro_torch.models.layers import mlp_strategies
    from repro_torch.parallel.axes import MeshAxes
    axes = MeshAxes(tp=p, dp=dp)
    sts = list(attn_site_strategies(cfg, axes).values())
    if cfg.d_ff:
        sts += list(mlp_strategies(cfg, axes, cfg.d_model,
                                   cfg.d_ff).values())
    return sts


def serve_overhead_events(cfg, p: int, rows: int, phase: str,
                          sequences: int = 0):
    """Serving-path collectives beyond the projection strategies' own
    events, per the decode/prefill code paths of the reference's
    ``models/attention.py`` and ``models/model.py``.  Latency (the Eqn. 26
    c1 term) dominates these at serving message sizes, so the COUNT
    structure matters more than the exact byte sizes.  Returns
    ``(per_layer, per_step)`` event lists:

      * decode, head mode — q (and, when kv divides p, k/v) head
        gathers plus the flash-decoding LSE merge (pmax + psum);
      * decode, phantom MLP sites — the gather-on-use ghost decompress
        per site;
      * prefill in the fp residual layout (phantom configs) — attention
        reads the full residual: gather + scatter per layer;
      * both phases — the vocab-sharded head's logits all-gather and
        the last-position/embed psum, once per step.
    """
    from repro_torch.configs.base import PHANTOM_KINDS
    if p <= 1:
        return [], []
    H, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    d, V = cfg.d_model, cfg.vocab_size
    head_rows = sequences or rows
    per_layer, per_step = [], []
    phantom_mlp = [s for s in ("ffn_gate", "ffn_up", "ffn_down")
                   if cfg.projection_spec(s).kind in PHANTOM_KINDS]
    if phase == "decode":
        per_layer.append(CommEvent("all_gather", rows * H * hd / p))
        if kv and kv % p == 0:
            per_layer += [CommEvent("all_gather", rows * kv * hd / p)] * 2
        per_layer += [CommEvent("all_reduce", rows * H * hd)] * 2
        for site in phantom_mlp:
            k = cfg.projection_spec(site).k
            per_layer.append(CommEvent("all_gather", d * k / p))
    elif cfg.uses_phantom_sites():
        per_layer += [CommEvent("all_gather", rows * d / p),
                      CommEvent("reduce_scatter", rows * d / p)]
    per_step += [CommEvent("all_gather", head_rows * V / p),
                 CommEvent("all_reduce", head_rows * d)]
    return per_layer, per_step


def serve_step_events(cfg, p: int, rows: int, phase: str,
                      sequences: int = 0, dp: int = 1):
    """The full per-step serving collective account: the projection
    strategies' own events plus the ``serve_overhead_events`` terms,
    as ``(CommEvent, repeats)`` pairs (all on the model axis — the
    serving path issues no data-axis collectives).  Shared by
    ``serve_step_prediction`` and the static audit's collective-
    accounting rule, so the audit checks exactly the account the
    ledger prices."""
    sts = serve_site_strategies(cfg, p, dp)
    ov_layer, ov_step = serve_overhead_events(cfg, p, rows, phase,
                                              sequences)
    events = [(ev, cfg.num_layers)
              for ev in events_for(sts, rows, training=False)]
    events += [(ev, cfg.num_layers) for ev in ov_layer]
    events += [(ev, 1) for ev in ov_step]
    return events


def serve_step_prediction(cfg, p: int, rows: int, *, phase: str = "decode",
                          ctx_tokens: float = 0.0, sequences: int = 0,
                          dp: int = 1,
                          fits=None, alpha_scale: float = 1.0,
                          beta_scale: float = 1.0,
                          peak_flops: float = H100_PEAK_FLOPS_FP32,
                          A: float = FRONTIER_A_W, B: float = FRONTIER_B_W,
                          itemsize: float = FLOAT_BYTES) -> dict:
    """The ledger's ``predicted`` block for ONE serving step.

    ``rows`` is the token rows through the per-layer projections
    (prefill: ``slots * padded_len``; decode: ``slots``);
    ``ctx_tokens`` the EXECUTED attention window per query token —
    blockwise attention computes the full masked window, so prefill
    passes the padded length S and decode the cache ``max_len``.  On
    top of the projection strategies' account this adds the serving
    terms the strategy objects don't own: the attention score/value
    GEMMs (``4·H·hd·ctx`` flops per query token, sharded over the
    model axis in both head and sequence sharding), the vocab-sharded
    LM head (last position per sequence at prefill, every row at
    decode), and the ``serve_overhead_events`` collectives.
    ``alpha_scale``/``beta_scale`` are the planner's calibrated
    measured/predicted correction scales for the executing strategy
    kind (docs/planner.md)."""
    sts = serve_site_strategies(cfg, p, dp)
    alpha_s, _ = costs_from_strategies(
        sts, p, cfg.num_layers, rows, peak_flops, fits, training=False)
    H, hd = cfg.num_heads, cfg.resolved_head_dim()
    attn_flops = 4.0 * H * hd * max(ctx_tokens, 0.0) * rows \
        * cfg.num_layers / max(p, 1)
    # LM head runs on one row per sequence at prefill (last position
    # only), on every row at decode
    head_rows = sequences or rows
    head_flops = 2.0 * cfg.d_model * cfg.vocab_size * head_rows / max(p, 1)
    alpha_s += (attn_flops + head_flops) / peak_flops
    alpha_s *= alpha_scale
    events = serve_step_events(cfg, p, rows, phase, sequences, dp)
    wire = sum(event_wire_bytes(ev, p, itemsize) * n for ev, n in events)
    m_floats = sum(ev.m_floats * n for ev, n in events)
    comm_us = sum(comm_time_us(ev.collective, ev.m_floats, p, fits) * n
                  for ev, n in events)
    beta_s = comm_us * 1e-6 * beta_scale
    return {
        "flops_per_device": alpha_s * peak_flops,
        "collective_wire_bytes_per_device": wire * beta_scale,
        "collective_m_floats": m_floats,
        "comm_us": comm_us,
        "alpha_s": alpha_s,
        "beta_s": beta_s,
        "energy_j_per_iter": energy_per_iteration(alpha_s, beta_s, p,
                                                  A, B),
        "phase": phase, "rows": rows, "ctx_tokens": ctx_tokens,
        "training": False,
        "model": "E = p*(A*alpha + B*beta), serving (fwd-only)",
        "A_w": A, "B_w": B, "peak_flops": peak_flops,
        "alpha_scale": alpha_scale, "beta_scale": beta_scale,
    }


def measured_energy_fields(costs, p: int, *, fits=None,
                           peak_flops: float = H100_PEAK_FLOPS_FP32,
                           A: float = FRONTIER_A_W,
                           B: float = FRONTIER_B_W) -> dict:
    """Price the MEASURED account of one step with the same
    E = p·(A·α + B·β) the predictions use: α from the counted flops, β
    from the issued collectives' per-event message sizes run through the
    Eqn. 26 comm model.  The measured/predicted ``energy_j_per_iter``
    ratio is then a pure model-accuracy number (same constants both
    sides, wall time out of the picture).  ``costs`` is a
    ``MeasuredCosts``; its ``collectives`` are keyed by the paper's
    collective names."""
    alpha_s = costs.flops / peak_flops
    table = dict(fits or PAPER_COLLECTIVE_FITS)
    # collectives without a Table III fit of their own are priced at the
    # nearest fitted shape: a2a moves (p-1)/p of a gather's wire, a
    # permute hop is broadcast-like
    fallback = {"all_to_all": "all_gather",
                "collective_permute": "broadcast"}
    us = 0.0
    for op, rec in costs.collectives.items():
        count = rec.get("count", 0)
        if not count:
            continue
        paper = op if op in table else fallback.get(op, "all_gather")
        if paper not in table:
            continue
        us += comm_time_us(paper, rec["m_floats"] / count, p, table) * count
    beta_s = us * 1e-6
    return {
        "flops_per_device": costs.flops,
        "collective_wire_bytes_per_device": costs.collective_wire_bytes,
        "collective_m_floats": costs.collective_m_floats,
        "alpha_s": alpha_s,
        "beta_s": beta_s,
        "energy_j_per_iter": energy_per_iteration(alpha_s, beta_s, p,
                                                  A, B),
    }


def ffn_step_prediction(cfg, p: int, global_batch: int, *,
                        training: bool = True,
                        peak_flops: float = H100_PEAK_FLOPS_FP32,
                        fits=None, A: float = FRONTIER_A_W,
                        B: float = FRONTIER_B_W) -> dict:
    """Prediction for one paper-FFN step (the strategy ``cfg`` selects at
    the ``ffn_layer`` site, applied once per layer)."""
    from repro_torch.core.ffn import ffn_strategy
    st = ffn_strategy(cfg, p)
    pred = strategy_prediction([st], p, cfg.num_layers, global_batch,
                               training=training, peak_flops=peak_flops,
                               fits=fits, A=A, B=B)
    pred["strategy"] = st.kind
    pred["param_count"] = st.param_count() * cfg.num_layers
    return pred


def fused_kernel_step_events(cfg, p: int, rows: int,
                             training: bool = True) -> List[tuple]:
    """(CommEvent, layer-repeats) account of a phantom FFN step running
    with ``kernel_backend="pallas"`` (the hand-written kernels) —
    IDENTICAL to the plain path's account by construction: the fused
    kernel moves GEMM traffic, never collectives (the ghost all-gather /
    reduce-scatter stay outside the autograd op), so this re-exports the
    strategy's own ``comm_events``."""
    from repro_torch.core.ffn import ffn_strategy
    st = ffn_strategy(cfg, p)
    return [(ev, cfg.num_layers)
            for ev in events_for([st], rows, training)]


def fused_ffn_step_prediction(cfg, p: int, global_batch: int, *,
                              training: bool = True,
                              itemsize: float = FLOAT_BYTES,
                              **kw) -> dict:
    """``ffn_step_prediction`` for the kernel backend: same flops, same
    collectives, same energy projection (zero drift), annotated with
    what fusion DOES change — the decompress GEMM accumulates into the
    local GEMM's tile instead of a second read+write pass of z over HBM
    (one saved round trip per layer per pass)."""
    pred = ffn_step_prediction(cfg, p, global_batch,
                               training=training, **kw)
    from repro_torch.core.ffn import ffn_strategy
    st = ffn_strategy(cfg, p)
    z_bytes = global_batch * (st.n_out // p) * itemsize
    passes = 3 if training else 1          # fwd + fused dgrad + wgrad
    pred["kernel_backend"] = cfg.projection_spec("ffn_layer").kernel_backend
    pred["hbm_bytes_saved_per_device"] = (2.0 * z_bytes * passes
                                          * cfg.num_layers)
    return pred


def pipeline_ffn_step_events(cfg, pp: int, tp: int, dp: int,
                             global_batch: int, *,
                             executed: bool = True) -> dict:
    """The per-step collective account of the pipelined paper-FFN step
    as ``(CommEvent, group, repeats)`` triples, with the schedule /
    strategy context the prediction needs.  ``group`` is the mesh-axis
    size each event runs over (permute -> pp, gradient all-reduce ->
    dp, layer collectives -> tp)."""
    from repro_torch.core.ffn import ffn_stage_strategies
    from repro_torch.train.pipeline import PipelineSchedule

    if cfg.pipeline.mixed:
        raise ValueError("per-device prediction needs homogeneous stages "
                         "(mixed stages run different per-rank programs)")
    M = max(cfg.microbatches, 1)
    sched = PipelineSchedule(stages=pp, microbatches=M)
    st = ffn_stage_strategies(cfg, tp)[0]
    L_loc = cfg.num_layers // max(pp, 1)
    rows_mb = global_batch / max(dp, 1) / M
    reps = sched.num_ticks if executed else M

    layer_events = [(ev, reps * L_loc) for ev in st.comm_events(rows_mb)]
    m_boundary = rows_mb * cfg.ffn_width / max(tp, 1)
    p2p = sched.p2p_events(m_boundary, executed=executed)
    events = layer_events + [(ev, 1) for ev in p2p]
    if dp > 1:
        # dp gradient sync of this device's stage-local (tp-sharded)
        # param grads — once per step, after the pipeline
        m_grads = L_loc * st.param_count() / max(tp, 1)
        events.append((CommEvent("all_reduce", m_grads, "bwd"), 1))

    def group(ev):
        if ev.collective in ("collective_permute", "p2p"):
            return pp
        return dp if ev.collective == "all_reduce" else tp

    return {
        "events": [(ev, group(ev), n) for ev, n in events],
        "p2p": p2p,
        "schedule": sched,
        "strategy": st,
        "rows_mb": rows_mb,
        "L_loc": L_loc,
        "reps": reps,
    }


def pipeline_ffn_step_prediction(cfg, pp: int, tp: int, dp: int,
                                 global_batch: int, *,
                                 executed: bool = True,
                                 peak_flops: float = H100_PEAK_FLOPS_FP32,
                                 fits=None, A: float = FRONTIER_A_W,
                                 B: float = FRONTIER_B_W,
                                 itemsize: float = FLOAT_BYTES) -> dict:
    """The ledger's ``predicted`` block for one PIPELINED paper-FFN step
    on a pp×dp×tp mesh (homogeneous stages).

    ``executed=True`` predicts the reference's SPMD 1F1B emulation —
    every rank applies its stage at every wavefront tick (bubbles
    compute on masked garbage) and ppermutes at every tick but the last,
    forward and transposed-backward alike.  ``executed=False`` is the
    ideal deployment account (bubbles idle; M sends per boundary per
    direction): the port's pipeline executes it (``telemetry/probe.py``
    says how a rank's boundary sends differ by stage).

    The stage-boundary message is the carried feature shard:
    ``rows_mb * n / tp`` floats per device per hop.
    """
    acct = pipeline_ffn_step_events(cfg, pp, tp, dp, global_batch,
                                    executed=executed)
    sched, st = acct["schedule"], acct["strategy"]
    M = sched.microbatches

    alpha_s = (3.0 * acct["reps"] * acct["L_loc"]
               * st.flops(acct["rows_mb"])) / peak_flops
    events = acct["events"]
    wire = sum(event_wire_bytes(ev, g, itemsize) * nrep
               for ev, g, nrep in events)
    boundary_wire = sum(event_wire_bytes(ev, pp, itemsize)
                        for ev in acct["p2p"])
    m_floats = sum(ev.m_floats * nrep for ev, _, nrep in events)
    comm_us = sum(comm_time_us(ev.collective, ev.m_floats, g, fits)
                  * nrep for ev, g, nrep in events)
    beta_s = comm_us * 1e-6
    devices = pp * dp * tp
    return {
        "flops_per_device": alpha_s * peak_flops,
        "collective_wire_bytes_per_device": wire,
        "boundary_wire_bytes_per_device": boundary_wire,
        "collective_m_floats": m_floats,
        "comm_us": comm_us,
        "alpha_s": alpha_s,
        "beta_s": beta_s,
        "energy_j_per_iter": energy_per_iteration(alpha_s, beta_s,
                                                  devices, A, B),
        "training": True,
        "model": "E = nu*p*(A*alpha + B*beta), 1F1B pipeline",
        "A_w": A, "B_w": B, "peak_flops": peak_flops,
        "pp": pp, "tp": tp, "dp": dp, "microbatches": M,
        "ticks": sched.num_ticks,
        "bubble_fraction": sched.bubble_fraction,
        "executed": executed,
        "strategy": st.kind,
    }


def kv_cache_token_bytes(cfg) -> tuple:
    """``(per_token_bytes, per_sequence_bytes)`` of ONE request's decode
    cache rows at the model's true cache dtypes (bf16 k/v, fp32 SSD
    state unless quantized): the unit the fleet's KV-page transfer
    channel is priced in.

    Computed by differencing ``models/model.py: cache_decls`` at two
    lengths, so length-proportional leaves (attention k/v, encdec cross
    k/v) land in the per-token term and fixed-size recurrent state
    (Mamba conv/SSD) in the per-sequence term, with no per-family
    arithmetic to drift out of sync with the real cache layout."""
    from repro_torch.models.model import PORTED_FAMILIES, cache_decls
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import tree_leaves
    if cfg.family not in PORTED_FAMILIES:
        return 0.0, 0.0       # the paper FFN: no LM stack, no decode cache

    def total_bytes(n_tokens: int) -> float:
        sds = cache_decls(cfg, MeshAxes(), 1, n_tokens)
        return float(sum(math.prod(t.shape) * t.dtype.itemsize
                         for _, t in tree_leaves(sds)))

    step = 16
    b1, b2 = total_bytes(step), total_bytes(2 * step)
    per_token = (b2 - b1) / step
    per_seq = b1 - per_token * step
    return per_token, max(per_seq, 0.0)


def kv_transfer_prediction(cfg, migrations: int, mean_tokens: float, *,
                           tp_src: int = 1, tp_dst: int = 1,
                           fits=None, B: float = FRONTIER_B_W) -> dict:
    """The ``predicted`` block for the fleet's prefill->decode KV-page
    migrations: ``migrations`` requests, each carrying ``mean_tokens``
    padded prompt rows of cache across the pool boundary.

    The wire term is a point-to-point hop (Eqn. 26 ``c1 + c2·m``, the
    same single-hop pricing as the pipeline's stage boundaries); the
    energy term bills the transfer seconds at static power ``B`` across
    the endpoint devices of both pools (the devices sit idle from the
    compute account's view while pages move).  The measured side is the
    ``TransferChannel``'s actual byte count."""
    per_tok, per_seq = kv_cache_token_bytes(cfg)
    bytes_each = per_seq + mean_tokens * per_tok
    wire = migrations * bytes_each
    hop_us = comm_time_us("collective_permute", bytes_each / FLOAT_BYTES,
                          2, fits)
    comm_us = migrations * hop_us
    beta_s = comm_us * 1e-6
    devices = max(tp_src, 1) + max(tp_dst, 1)
    return {
        "transfer_wire_bytes": wire,
        "migrations": migrations,
        "bytes_per_migration": bytes_each,
        "cache_bytes_per_token": per_tok,
        "cache_bytes_per_sequence": per_seq,
        "comm_us": comm_us,
        "beta_s": beta_s,
        "energy_j": beta_s * B * devices,
        "model": "E = B*(tp_src+tp_dst)*beta, p2p hop c1 + c2*m",
        "B_w": B, "tp_src": tp_src, "tp_dst": tp_dst,
    }


# An ASSUMED checkpoint-store bandwidth, not a measurement: it prices a
# phase's checkpoint IO seconds only where no write time was measured
CKPT_DISK_BW_BPS = 1.0e9


def recovery_account(phases: Sequence[dict],
                     recoveries: Sequence[dict] = (), *,
                     A: float = FRONTIER_A_W, B: float = FRONTIER_B_W,
                     disk_bw_bps: float = CKPT_DISK_BW_BPS) -> dict:
    """Joules to the target loss INCLUDING the recovery overhead: the
    elastic runtime's energy account, the reference's formula.

    ``phases``: one dict per plan the run executed on, with ``steps``,
    ``replayed_steps`` (of those, re-runs of lost progress), ``devices``,
    ``energy_j_per_iter`` (the planner's price), ``ckpt_io_bytes``,
    ``ckpt_io_s`` (measured write seconds; 0 derives them from the bytes
    at ``disk_bw_bps``), ``compile_s`` and ``wall_s``.  ``recoveries``:
    one dict per fault handled, with measured ``restore_s``,
    ``replan_s`` and ``devices_after``.

    Useful and replayed steps are priced at the phase's per-iteration
    energy, so ``replay_overhead_ratio`` (replayed over all STEP energy)
    is a pure schedule quantity.  Checkpoint IO and restart time
    (restore + re-plan + compile) are host seconds during which the
    devices wait, priced at static power ``B`` across them;
    ``recovery_overhead_ratio`` folds those in."""
    useful_j = replay_j = ckpt_j = restart_j = 0.0
    steps = replayed = 0
    io_bytes = io_s = compile_s = wall_s = 0.0
    for ph in phases:
        e = float(ph.get("energy_j_per_iter", 0.0))
        n = int(ph.get("steps", 0))
        r = min(int(ph.get("replayed_steps", 0)), n)
        dev = int(ph.get("devices", 1))
        useful_j += e * (n - r)
        replay_j += e * r
        steps += n
        replayed += r
        b = float(ph.get("ckpt_io_bytes", 0.0))
        s = float(ph.get("ckpt_io_s", 0.0)) or b / disk_bw_bps
        ckpt_j += s * B * dev
        io_bytes += b
        io_s += s
        c = float(ph.get("compile_s", 0.0))
        compile_s += c
        restart_j += c * B * dev
        wall_s += float(ph.get("wall_s", 0.0))
    restore_s = replan_s = 0.0
    for rec in recoveries:
        dev = int(rec.get("devices_after", 1))
        rs = float(rec.get("restore_s", 0.0))
        ps = float(rec.get("replan_s", 0.0))
        restore_s += rs
        replan_s += ps
        restart_j += (rs + ps) * B * dev
    step_j = useful_j + replay_j
    total_j = step_j + ckpt_j + restart_j
    return {
        "schema": "recovery-account/v1",
        "energy_j_useful": useful_j,
        "energy_j_replay": replay_j,
        "energy_j_ckpt_io": ckpt_j,
        "energy_j_restart": restart_j,
        "energy_j_total": total_j,
        "replay_overhead_ratio": (replay_j / step_j) if step_j else 0.0,
        "recovery_overhead_ratio": ((total_j - useful_j) / total_j)
        if total_j else 0.0,
        "steps_total": steps,
        "replayed_steps": replayed,
        "restarts": len(list(recoveries)),
        "ckpt_io_bytes": io_bytes,
        "ckpt_io_s": io_s,
        "compile_s": compile_s,
        "restore_s": restore_s,
        "replan_s": replan_s,
        "wall_s": wall_s,
        "disk_bw_bps": disk_bw_bps,
        "A_w": A, "B_w": B,
    }
