"""Energy-aware serve routing: price candidate configs in predicted
joules per token, route a trace to the cheapest one meeting the SLO,
and record measured-vs-predicted serve energy to the Ledger: the port of
the reference's ``serve/router.py``.

A ``ServeConfig`` is one way to stand the serving engine up: projection
family (tensor vs phantom at the MLP sites: the paper's technique on
the inference path), mesh shape (dp x tp) and slot count.  Phantom
candidates may use fewer devices than the budget: the claim under test
is that a phantom config on a smaller mesh can meet the same SLO at
lower joules per token.

Pricing takes the calibrated constants (``planner.load_calibration``)
and ``telemetry.predict.serve_step_prediction``, the forward-only
per-step account of the very strategy objects that execute, priced by
E = p·(A·α + B·β).  Joules per token for a trace with mean padded
prompt length S, mean output length G, at full slot occupancy:

    J/tok = (E_prefill_step / slots + G · E_decode_step / slots) / G

(the prefill step serves ``slots`` prompts, each decode step yields
``slots`` tokens).  Predicted TTFT/TPOT are the α+β step times of the
modelled accelerator (``peak_flops``, the H100's float32 peak unless
the caller gives another, and the paper's collective fits): the SLO gate
is a model-based feasibility screen; the measured SLO report comes from
the replay itself.

The reference prices the arch's smoke config; the port prices and
serves one config, the smoke one (``ServeConfig.smoke``, the default)
or the published one, with the sites' kernels selected by
``kernel_backend``.  ``run_config`` runs inside each rank of the
config's mesh (``launch/mesh.py: spawn``): it replays the trace through
the rank's engine and reads the measured account of one prefill at the
probe bucket and one decode step with ``telemetry/counted.py:
count_step`` (flops and issued collectives; the reference lowers its
step functions and reads their HLO instead), priced by
``measured_energy_fields``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import (ModelConfig, ProjectionMap,
                                      ProjectionSpec, get_config)
from repro_torch.core.energy import H100_PEAK_FLOPS_FP32
from repro_torch.planner.calibration import Calibration
from repro_torch.serve.scheduler import bucket_of
from repro_torch.serve.traffic import (SLOTracker, TraceItem, replay,
                                       trace_requests)

# the ffn sites the phantom candidates factorize (the paper's technique;
# attention projections stay dense on the serving path)
_PHANTOM_FFN = ("ffn_gate", "ffn_up", "ffn_down")


@dataclass(frozen=True)
class ServeConfig:
    """One candidate serving configuration."""
    arch: str
    impl: str                    # "tensor" | "phantom"
    dp: int
    tp: int
    slots: int
    max_len: int = 64
    page_size: int = 16
    k: int = 0                   # ghost width; 0 = the arch's default
    smoke: bool = True           # the arch's smoke config, else published
    kernel_backend: str = "auto"  # the sites' (and flash's) kernels

    @property
    def devices(self) -> int:
        return self.dp * self.tp

    @property
    def name(self) -> str:
        tag = f"{self.arch}-{self.impl}-mesh{self.dp}x{self.tp}" \
              f"-slots{self.slots}"
        if self.impl == "phantom" and self.k:
            tag += f"-k{self.k}"
        return tag

    @property
    def strategy_kind(self) -> str:
        """The calibration table key for this config's MLP strategy."""
        return "phantom" if self.impl == "phantom" else "tensor_col"

    def model_config(self) -> ModelConfig:
        """The ModelConfig this candidate serves: every site tensor, or
        phantom at the MLP sites and tensor elsewhere (the strategies
        the reference's candidate resolves to), each with
        ``kernel_backend``."""
        cfg = get_config(self.arch, smoke=self.smoke)
        dense = ProjectionSpec(kind="tensor",
                               kernel_backend=self.kernel_backend)
        if self.impl == "phantom":
            ph = ProjectionSpec(kind="phantom", k=self.k or cfg.phantom.k,
                                kernel_backend=self.kernel_backend)
            pm = ProjectionMap(default=dense,
                               **{s: ph for s in _PHANTOM_FFN})
        else:
            pm = ProjectionMap(default=dense)
        return cfg.replace(name=self.name, projections=pm)

    def as_dict(self) -> dict:
        return {"name": self.name, "arch": self.arch, "impl": self.impl,
                "dp": self.dp, "tp": self.tp, "devices": self.devices,
                "slots": self.slots, "max_len": self.max_len,
                "page_size": self.page_size, "k": self.k,
                "smoke": self.smoke, "kernel_backend": self.kernel_backend}


def candidate_configs(arch: str, devices: int = 8, *,
                      slots_options: Sequence[int] = (4, 8),
                      max_len: int = 64, page_size: int = 16,
                      smoke: bool = True,
                      kernel_backend: str = "auto") -> List[ServeConfig]:
    """Enumerate candidates: tensor configs use the FULL device budget
    (idling paid-for devices under the baseline would make the phantom
    comparison trivially winnable: the training planner's rule);
    phantom configs may downsize to sub-meshes.  tp >= 2 only: the
    router arbitrates model-parallel serving configs (a tp = 1
    deployment has no collectives and would trivially win the
    latency-dominated energy model; ``--route fixed --tp 1`` reaches
    it)."""
    cfg = get_config(arch, smoke=smoke)
    out = []
    for tp in (2, 4, 8, 16):
        if tp > devices or cfg.d_model % tp:
            continue
        if cfg.num_heads and cfg.num_heads % tp:
            continue
        for slots in slots_options:
            kw = dict(max_len=max_len, page_size=page_size, smoke=smoke,
                      kernel_backend=kernel_backend)
            if devices % tp == 0:
                out.append(ServeConfig(arch, "tensor", devices // tp, tp,
                                       slots, **kw))
            # phantom needs >= 2 model ranks and ffn divisibility
            if cfg.d_ff and cfg.d_ff % tp == 0:
                for dp in (1, 2):
                    if dp * tp <= devices:
                        out.append(ServeConfig(arch, "phantom", dp, tp,
                                               slots, **kw))
    seen, uniq = set(), []
    for sc in out:
        if sc.name not in seen:
            seen.add(sc.name)
            uniq.append(sc)
    return uniq


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------

@dataclass
class PricedConfig:
    config: ServeConfig
    j_per_token: float
    prefill_energy_j: float       # per prefill step (slots prompts)
    decode_energy_j: float        # per decode step (slots tokens)
    ttft_s: float                 # modelled prefill step time
    tpot_s: float                 # modelled decode step time
    meets_slo: bool
    notes: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"config": self.config.as_dict(),
                "j_per_token": self.j_per_token,
                "prefill_energy_j": self.prefill_energy_j,
                "decode_energy_j": self.decode_energy_j,
                "ttft_s": self.ttft_s, "tpot_s": self.tpot_s,
                "meets_slo": self.meets_slo, "notes": self.notes}


def trace_stats(trace: Sequence[TraceItem], page_size: int = 16) -> dict:
    """Mean padded prompt length / output length the pricing uses."""
    pads = [bucket_of(t.prompt_len, page_size) for t in trace]
    outs = [t.max_new_tokens for t in trace]
    return {"n": len(trace),
            "mean_padded_prompt": float(np.mean(pads)) if pads else 0.0,
            "mean_new_tokens": float(np.mean(outs)) if outs else 1.0,
            "max_padded_prompt": max(pads) if pads else 0}


def serve_predictions(sc: ServeConfig, calib: Calibration, stats: dict, *,
                      cfg: Optional[ModelConfig] = None,
                      peak_flops: float = H100_PEAK_FLOPS_FP32
                      ) -> Tuple[dict, dict]:
    """(prefill, decode) ``serve_step_prediction`` blocks for one
    candidate under a trace's length statistics; ``cfg`` (default
    ``sc.model_config()``) is the config it serves."""
    from repro_torch.telemetry.predict import serve_step_prediction
    cfg = cfg or sc.model_config()
    a_s, b_s, _nu = calib.scales_for(sc.strategy_kind)
    S = max(stats["mean_padded_prompt"], 1.0)
    # ctx_tokens follows the executed attention windows: S keys per
    # prefill query token, the whole max_len cache per decode token
    kw = dict(dp=sc.dp, fits=calib.collective_fits, alpha_scale=a_s,
              beta_scale=b_s, peak_flops=peak_flops)
    pre = serve_step_prediction(cfg, sc.tp, int(round(sc.slots * S)),
                                phase="prefill", ctx_tokens=S,
                                sequences=sc.slots, **kw)
    dec = serve_step_prediction(cfg, sc.tp, sc.slots, phase="decode",
                                ctx_tokens=float(sc.max_len), **kw)
    return pre, dec


def price_config(sc: ServeConfig, calib: Calibration, stats: dict, *,
                 slo_ms: float = 0.0,
                 peak_flops: float = H100_PEAK_FLOPS_FP32) -> PricedConfig:
    """Predicted joules per generated token + modelled step times."""
    pre, dec = serve_predictions(sc, calib, stats, peak_flops=peak_flops)
    G = max(stats["mean_new_tokens"], 1.0)
    # the prediction's E = p*(A*alpha + B*beta) is per model group; a
    # dp-replicated mesh runs dp copies of the step for dp x the rows:
    # price per global step over global tokens (j/token is dp-invariant)
    e_pre = pre["energy_j_per_iter"] * sc.dp
    e_dec = dec["energy_j_per_iter"] * sc.dp
    tokens_per_step = sc.slots * sc.dp
    j_tok = (e_pre / tokens_per_step + G * e_dec / tokens_per_step) / G
    ttft = pre["alpha_s"] + pre["beta_s"]
    tpot = dec["alpha_s"] + dec["beta_s"]
    meets = (not slo_ms) or (ttft * 1e3 <= slo_ms and tpot * 1e3 <= slo_ms)
    return PricedConfig(
        config=sc, j_per_token=j_tok, prefill_energy_j=e_pre,
        decode_energy_j=e_dec, ttft_s=ttft, tpot_s=tpot, meets_slo=meets,
        notes={"alpha_scale": pre["alpha_scale"],
               "beta_scale": pre["beta_scale"],
               "calibration": calib.source,
               "mean_padded_prompt": stats["mean_padded_prompt"],
               "mean_new_tokens": stats["mean_new_tokens"]})


def route(candidates: Sequence[ServeConfig], calib: Calibration,
          trace: Sequence[TraceItem], *, slo_ms: float = 0.0,
          peak_flops: float = H100_PEAK_FLOPS_FP32
          ) -> Tuple[PricedConfig, List[PricedConfig]]:
    """Price every candidate and pick the cheapest j/token among those
    meeting the (modelled) SLO; with no feasible candidate, the
    lowest-latency one, so serving still comes up."""
    if not candidates:
        raise ValueError("no serve candidates to route over")
    from repro_torch.obs import get_tracer
    with get_tracer().span("serve/route", cat="serve",
                           candidates=len(candidates)) as sp:
        stats = trace_stats(trace, candidates[0].page_size)
        priced = [price_config(sc, calib, stats, slo_ms=slo_ms,
                               peak_flops=peak_flops) for sc in candidates]
        # ties in j/token (dp-invariant pricing) go to the SMALLER mesh
        priced.sort(key=lambda pc: (pc.j_per_token, pc.config.devices))
        feasible = [pc for pc in priced if pc.meets_slo]
        winner = feasible[0] if feasible else \
            min(priced, key=lambda pc: pc.ttft_s)
        sp.annotate(winner=winner.config.name, feasible=len(feasible),
                    j_per_token=winner.j_per_token)
    return winner, priced


# ---------------------------------------------------------------------------
# routed execution, inside each rank
# ---------------------------------------------------------------------------

def serve_params(cfg: ModelConfig, axes, seed: int, device):
    """This rank's shards of random global parameters drawn from
    ``seed`` on the device, cast for serving (``serving_params``) as
    each rank's turn ends (``materialize_shards_in_turn``): only one rank
    at a time holds a global leaf and its float32 shards."""
    from repro_torch.models.model import model_decls, serving_params
    from repro_torch.parallel.params import materialize_shards_in_turn
    return materialize_shards_in_turn(
        model_decls(cfg, axes), axes, seed, device,
        cast=lambda tree: serving_params(cfg, tree, device))


def run_config(sc: ServeConfig, trace: Sequence[TraceItem], axes, *,
               device=None, cfg: Optional[ModelConfig] = None, params=None,
               ledger=None, calib: Optional[Calibration] = None,
               seed: int = 0, slo_ms: float = 0.0, sampling=None,
               order: str = "fcfs", max_steps: int = 100_000,
               peak_flops: float = H100_PEAK_FLOPS_FP32,
               stubs=None) -> dict:
    """Stand up this rank's engine for ``sc`` (on ``axes``, a
    ``sc.dp x sc.tp`` mesh), replay ``trace`` through it, read the
    measured account of one prefill at the probe bucket and one decode
    step, and record joined measured-vs-predicted serve rows to
    ``ledger``.  ``cfg`` overrides ``sc.model_config()`` (a depth cut);
    ``params`` the rank's weights (default: ``serve_params`` from
    ``seed``); ``stubs`` the engine's frontend stubs (``ServeEngine``'s
    default: zeros).

    Returns ``{"slo": <SLO report>, "measured": ..., "predicted": ...,
    "energy_ratio": ..., "j_per_token_measured": ...}``, the steps run
    (the replay's, the warm-up's one prefill a bucket, the probe's
    bucket), the probes' collectives, the engine's telemetry and the
    greedy streams: the same on every rank but the measured accounts
    (each rank's own)."""
    import torch

    from repro_torch.parallel.axes import resolve_device
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.telemetry.counted import count_step
    from repro_torch.telemetry.predict import measured_energy_fields

    if (axes.dp, axes.tp) != (sc.dp, sc.tp):
        raise ValueError(f"{sc.name} runs on dp={sc.dp} x tp={sc.tp}, "
                         f"not on dp={axes.dp} x tp={axes.tp}")
    device = resolve_device(device)
    calib = calib or Calibration()
    cfg = cfg or sc.model_config()
    if params is None:
        params = serve_params(cfg, axes, seed, device)
    stats = trace_stats(trace, sc.page_size)
    reqs = trace_requests(trace, cfg.vocab_size, seed=seed,
                          sampling=sampling)

    eng = ServeEngine(cfg, params, slots=sc.slots, max_len=sc.max_len,
                      page_size=sc.page_size, axes=axes, device=device,
                      order=order, stubs=stubs)
    buckets = {bucket_of(t.prompt_len, sc.page_size) for t in trace}
    eng.warmup(buckets)
    from repro_torch.obs import get_tracer
    with get_tracer().span("serve/replay", cat="serve", config=sc.name,
                           requests=len(reqs)):
        tracker = replay(eng, reqs,
                         tracker=SLOTracker(slo_ttft_ms=slo_ms),
                         max_steps=max_steps)
    slo_report = tracker.report()

    # the measured account of the engine's own step functions: one
    # prefill at the probe bucket, one decode step on a scratch cache
    S_probe = int(stats["max_padded_prompt"] or sc.page_size)
    n = len(eng.rows)
    zeros = torch.zeros((n, S_probe), dtype=torch.long, device=device)
    pre_costs, _ = count_step(eng.prefill_fn, zeros, device=device)
    dec_costs, _ = count_step(eng.decode_fn, eng._zero_cache(),
                              zeros[:, :1], zeros[:, 0], device=device)
    fields = dict(fits=calib.collective_fits, peak_flops=peak_flops)
    measured = {
        "prefill": measured_energy_fields(pre_costs, sc.tp, **fields),
        "decode": measured_energy_fields(dec_costs, sc.tp, **fields),
    }
    # the prediction prices the MEAN padded prompt; the probe ran the
    # max bucket: rescale the prediction to the probed shape so the
    # ratio compares like with like
    probe_stats = dict(stats, mean_padded_prompt=float(S_probe))
    pred_pre, pred_dec = serve_predictions(sc, calib, probe_stats, cfg=cfg,
                                           peak_flops=peak_flops)
    predicted = {"prefill": pred_pre, "decode": pred_dec}

    g_tok = slo_report.get("generated_tokens", 0)
    e_meas_total = (measured["prefill"]["energy_j_per_iter"] * sc.dp
                    * eng.prefill_meter.calls
                    + measured["decode"]["energy_j_per_iter"] * sc.dp
                    * eng.decode_meter.calls)
    out = {
        "config": sc.as_dict(),
        "slo": slo_report,
        "pages": eng.pages.stats(),
        "measured": measured,
        "predicted": predicted,
        "energy_ratio": {
            k: measured[k]["energy_j_per_iter"]
            / predicted[k]["energy_j_per_iter"]
            for k in ("prefill", "decode")
            if predicted[k]["energy_j_per_iter"]},
        "j_per_token_measured": (e_meas_total / g_tok) if g_tok else 0.0,
        "prefill_steps": eng.prefill_meter.calls,
        "decode_steps": eng.decode_meter.calls,
        "warmup_prefills": len(buckets),
        "probe_bucket": S_probe,
        "collectives": {"prefill": pre_costs.collectives,
                        "decode": dec_costs.collectives},
        "telemetry": eng.telemetry(),
        "streams": [list(r.out_tokens) for r in reqs],
    }
    if ledger is not None:
        eng.record_to(ledger, predicted=predicted, measured_extra=measured,
                      extra={"config": sc.as_dict(), "slo": slo_report,
                             "j_per_token_measured":
                                 out["j_per_token_measured"]})
    eng.close()
    return out
