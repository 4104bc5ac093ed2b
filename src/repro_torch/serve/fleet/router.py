"""FleetRouter: disaggregated prefill/decode serving with
joules-per-token autoscaling (the reference's ``serve/fleet/router.py``).

``plan_pools`` picks each pool's ``ServeConfig`` independently by
predicted joules per unit of ITS phase (prefill: J/prompt, decode:
J/token) over the router's candidate table, either priced fresh with
the calibrated constants or read from the ``serve-route/v1`` JSON block
that ``launch/serve.py --route auto --route-out`` writes.
Disaggregation is exactly why per-phase choice matters: the
prefill-optimal config (throughput-bound, big batch-tokens) and the
decode-optimal config (latency-bound, often phantom on a sub-mesh) are
rarely the same deployment.

``FleetRouter.run`` replays a trace through a discrete-event loop on
the virtual clock: admit -> queue -> prefill group on a prefill
replica -> KV-page migration through the ``TransferChannel`` (a priced
wire event) -> adoption into a decode replica -> decode to completion.
An ``Autoscaler`` per pool scales replica counts against live queue
depth and SLO headroom (scale-down drains, never drops).  The run
records fleet-level TTFT/TPOT/goodput plus per-pool and whole-fleet
J/token to the ledger, with the transfer account's measured/predicted
``transfer_wire_bytes`` ratio.

``colocated=True`` turns the same simulator into the single-engine
baseline: one pool config serves both phases on one replica set,
prefill steps stall decode (the ``ServeEngine`` interleave), and the
migration is a free slot splice: the comparison partner for the
fleet's J/token claim.

Executed (``FleetConfig.executed``), the pools run real engines on this
rank (``runners.py``): on one device (``axes=None``) any two pool
configs serve in one process; on a dp x tp mesh both pools take the
mesh's dp x tp (their impl and k may differ), every rank runs this same
discrete-event loop, and since durations are modeled and tokens agreed
by the engines, the ranks stay in step.  Executed pools on different
meshes are ROADMAP.md queue 1, item 7; the modeled fleet prices any
pair.  The run is traced and metered as the reference's (``obs/``): the
``fleet/run``, ``fleet/prefill``, ``fleet/decode`` and ``fleet/scale``
spans, the pools' replica and queue-depth gauges.
"""
from __future__ import annotations

import heapq
import json
import os
from collections import deque
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence

from repro_torch.core.energy import FRONTIER_B_W, H100_PEAK_FLOPS_FP32
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.planner.calibration import Calibration
from repro_torch.serve.fleet.autoscaler import (AutoscalePolicy, Autoscaler,
                                                PoolStats)
from repro_torch.serve.fleet.runners import (DecodePool, FleetRequest,
                                             PoolAccount, PrefillPool,
                                             form_group, req_prompt_len)
from repro_torch.serve.fleet.transfer import TransferChannel
from repro_torch.serve.router import (PricedConfig, ServeConfig,
                                      candidate_configs, price_config,
                                      trace_stats)
from repro_torch.serve.scheduler import bucket_of
from repro_torch.serve.traffic import SLOTracker, TraceItem, trace_requests

ROUTE_SCHEMA = "serve-route/v1"
MESHES_TODO = ("ROADMAP.md queue 1, item 7 (executed pools on different "
               "meshes)")


# ---------------------------------------------------------------------------
# serve-route/v1: the persisted candidate J/token table
# ---------------------------------------------------------------------------

def write_route_table(path: str, arch: str, winner: PricedConfig,
                      priced: Sequence[PricedConfig], *,
                      calibration: str = "", stats: Optional[dict] = None,
                      slo_ms: float = 0.0) -> dict:
    """Persist the router's candidate J/token table so the fleet router
    can consume the pricing pass instead of re-running it."""
    block = {
        "schema": ROUTE_SCHEMA,
        "arch": arch,
        "slo_ms": slo_ms,
        "calibration": calibration,
        "trace": dict(stats or {}),
        "winner": winner.config.name,
        "candidates": [pc.as_dict() for pc in priced],
    }
    with open(path, "w") as f:
        json.dump(block, f, indent=1)
    return block


def load_route_table(path: str) -> Optional[dict]:
    """Read a ``serve-route/v1`` block; None when absent, ValueError on
    a schema mismatch (a wrong file should fail loudly, not silently
    re-price)."""
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        block = json.load(f)
    if block.get("schema") != ROUTE_SCHEMA:
        raise ValueError(f"{path}: schema {block.get('schema')!r} "
                         f"(want {ROUTE_SCHEMA})")
    return block


def _sc_from_dict(d: dict) -> ServeConfig:
    return ServeConfig(d["arch"], d["impl"], d["dp"], d["tp"],
                       d["slots"], max_len=d.get("max_len", 64),
                       page_size=d.get("page_size", 16),
                       k=d.get("k", 0), smoke=d.get("smoke", True),
                       kernel_backend=d.get("kernel_backend", "auto"))


# ---------------------------------------------------------------------------
# per-phase pool planning
# ---------------------------------------------------------------------------

def plan_pools(arch: str, devices: int, calib: Calibration,
               trace: Sequence[TraceItem], *, slo_ms: float = 0.0,
               slots: int = 4, max_len: int = 64, page_size: int = 16,
               route_table: Optional[dict] = None, smoke: bool = True,
               kernel_backend: str = "auto",
               peak_flops: float = H100_PEAK_FLOPS_FP32) -> tuple:
    """Choose (prefill_sc, decode_sc, notes): per phase, the candidate
    minimizing predicted joules per unit of that phase among those
    meeting the phase's SLO term (TTFT for prefill, TPOT for decode);
    ties go to fewer devices.  ``route_table`` (a ``serve-route/v1``
    block for the same arch) supplies the priced table instead of a
    fresh pricing pass; ``smoke`` and ``kernel_backend`` are the fresh
    candidates' (``serve/router.py: candidate_configs``)."""
    stats = trace_stats(trace, page_size)
    rows = []
    if route_table and route_table.get("arch") == arch \
            and route_table.get("candidates"):
        source = "route-table"
        for d in route_table["candidates"]:
            rows.append({
                "config": _sc_from_dict(d["config"]),
                "prefill_energy_j": d["prefill_energy_j"],
                "decode_energy_j": d["decode_energy_j"],
                "ttft_s": d["ttft_s"], "tpot_s": d["tpot_s"],
            })
    else:
        source = "priced"
        cands = candidate_configs(arch, devices, slots_options=(slots,),
                                  max_len=max_len, page_size=page_size,
                                  smoke=smoke, kernel_backend=kernel_backend)
        for pc in (price_config(sc, calib, stats, slo_ms=slo_ms,
                                peak_flops=peak_flops) for sc in cands):
            rows.append({
                "config": pc.config,
                "prefill_energy_j": pc.prefill_energy_j,
                "decode_energy_j": pc.decode_energy_j,
                "ttft_s": pc.ttft_s, "tpot_s": pc.tpot_s,
            })
    if not rows:
        raise ValueError(f"no serve candidates for {arch} "
                         f"on {devices} devices")

    def pick(energy_key: str, lat_key: str) -> dict:
        # per-unit: a step covers slots*dp prompts (prefill) or tokens
        # (decode), so normalize before comparing across meshes
        def unit(r):
            sc = r["config"]
            return r[energy_key] / (sc.slots * sc.dp)
        ok = [r for r in rows
              if not slo_ms or r[lat_key] * 1e3 <= slo_ms]
        pool = ok or rows
        return min(pool, key=lambda r: (unit(r), r["config"].devices))

    pre = pick("prefill_energy_j", "ttft_s")
    dec = pick("decode_energy_j", "tpot_s")
    # fleet replicas ARE the data-parallel axis: deploy each pool at
    # dp=1 (one model group per replica) and let the autoscaler stretch
    # the dp dimension elastically.  J/token is dp-invariant so the
    # per-phase pick carries over unchanged.
    pre_sc = replace(pre["config"], dp=1)
    dec_sc = replace(dec["config"], dp=1)
    notes = {
        "source": source,
        "slo_ms": slo_ms,
        "prefill": {"config": pre["config"].name,
                    "j_per_prompt": pre["prefill_energy_j"]
                    / (pre["config"].slots * pre["config"].dp)},
        "decode": {"config": dec["config"].name,
                   "j_per_token": dec["decode_energy_j"]
                   / (dec["config"].slots * dec["config"].dp)},
        "candidates": len(rows),
    }
    return pre_sc, dec_sc, notes


def baseline_config(arch: str, devices: int = 8, *, slots: int = 4,
                    max_len: int = 64, page_size: int = 16,
                    smoke: bool = True,
                    kernel_backend: str = "auto") -> ServeConfig:
    """The conventional single-engine deployment the fleet is compared
    against: one TENSOR engine tensor-parallel across the full device
    budget (largest divisible tp), colocating both phases, always on."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch, smoke=smoke)
    kw = dict(smoke=smoke, kernel_backend=kernel_backend)
    for tp in sorted({devices, 8, 4, 2}, reverse=True):
        if tp <= devices and cfg.d_model % tp == 0 \
                and (not cfg.num_heads or cfg.num_heads % tp == 0):
            return ServeConfig(arch, "tensor", 1, tp, slots,
                               max_len, page_size, **kw)
    return ServeConfig(arch, "tensor", 1, 1, slots, max_len, page_size,
                       **kw)


def auto_rate_rps(dec_sc: ServeConfig, calib: Calibration,
                  mean_new_tokens: float, *, replicas: int = 1,
                  utilization: float = 0.6,
                  peak_flops: float = H100_PEAK_FLOPS_FP32) -> float:
    """Arrival rate that loads the INITIAL decode pool to
    ``utilization`` of its modeled token throughput, so a bursty
    trace's 8x bursts overload it (scale-up) and its quiet phases
    underload it (scale-down)."""
    acct = PoolAccount(dec_sc, calib, peak_flops=peak_flops)
    step_s, _ = acct.decode_step()
    tokens_per_s = dec_sc.slots * dec_sc.dp * max(replicas, 1) / step_s
    return utilization * tokens_per_s / max(mean_new_tokens, 1.0)


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

@dataclass
class FleetConfig:
    """One fleet deployment: a pool config per phase, autoscaling
    policies, and the run mode."""
    prefill: ServeConfig
    decode: ServeConfig
    slo_ms: float = 0.0
    executed: bool = False        # real engines (small traces only)
    colocated: bool = False       # single-engine baseline mode
    prefill_replicas: int = 1     # initial pool sizes
    decode_replicas: int = 1
    prefill_policy: AutoscalePolicy = field(
        default_factory=AutoscalePolicy)
    decode_policy: AutoscalePolicy = field(
        default_factory=AutoscalePolicy)

    def as_dict(self) -> dict:
        return {"prefill": self.prefill.as_dict(),
                "decode": self.decode.as_dict(),
                "slo_ms": self.slo_ms, "executed": self.executed,
                "colocated": self.colocated,
                "prefill_replicas": self.prefill_replicas,
                "decode_replicas": self.decode_replicas}


def executed_mesh(fc: FleetConfig) -> tuple:
    """The (dp, tp) both executed pools run on; pools on different
    meshes raise (the modeled fleet prices any pair)."""
    meshes = {(sc.dp, sc.tp) for sc in (fc.prefill, fc.decode)}
    if len(meshes) > 1:
        raise NotImplementedError(
            f"executed pools on different meshes ({fc.prefill.name}, "
            f"{fc.decode.name}): {MESHES_TODO}")
    return meshes.pop()


class FleetRouter:
    """Admission, placement, migration and autoscaling over the two
    pools; one ``run()`` = one trace replay on the virtual clock.

    As ``serve/router.py: run_config`` takes them: ``axes`` is this
    rank's mesh (default one device) and ``device`` the card unless the
    caller asks for the CPU, both read by executed pools only; ``cfg``
    replaces every pool's ``sc.model_config()`` (a depth cut; only for
    pools of one model config); ``params`` are this rank's weights of
    that config (default: drawn with ``serve_params`` from ``seed``,
    one tree for pools of equal configs); ``peak_flops`` prices the
    modeled steps.  ``price_counted`` is the reference's ``price_hlo``
    (``runners.py: PoolAccount``): executed pools only."""

    def __init__(self, fc: FleetConfig, *,
                 calib: Optional[Calibration] = None, ledger=None,
                 seed: int = 0, axes=None, device=None, cfg=None,
                 params=None, peak_flops: float = H100_PEAK_FLOPS_FP32,
                 price_counted: bool = False):
        if fc.executed and fc.colocated:
            raise NotImplementedError(
                "colocated baseline is modeled-only; executed "
                "single-engine serving is ServeEngine itself")
        if price_counted and not fc.executed:
            raise ValueError("price_counted counts the executed pools' "
                             "steps; a modeled fleet runs none")
        if fc.colocated:
            # the baseline is a FIXED single-engine deployment: pin the
            # decode pool to its initial size so autoscaling never fires
            n = max(fc.decode_replicas, 1)
            fc = replace(fc, decode_policy=replace(
                fc.decode_policy, min_replicas=n, max_replicas=n))
        self.fc = fc
        self.calib = calib or Calibration()
        self.ledger = ledger
        self.seed = seed
        cfgs = self._pool_cfgs(fc, cfg)
        kw = dict(price_counted=price_counted, peak_flops=peak_flops)
        dec_acct = PoolAccount(fc.decode, self.calib, cfg=cfgs[1], **kw)
        pre_acct = dec_acct if fc.colocated else \
            PoolAccount(fc.prefill, self.calib, cfg=cfgs[0], **kw)
        pool_kw = [{}, {}]
        if fc.executed:
            pool_kw = self._executed_pools(cfgs, axes, device, params)
        self.pre = PrefillPool(
            fc.prefill, pre_acct, executed=fc.executed,
            n_init=0 if fc.colocated else max(fc.prefill_replicas, 1),
            **pool_kw[0])
        self.dec = DecodePool(
            fc.decode, dec_acct, executed=fc.executed,
            n_init=max(fc.decode_replicas, 1), **pool_kw[1])
        self.channel = TransferChannel(
            dec_acct.cfg, tp_src=fc.prefill.tp, tp_dst=fc.decode.tp,
            fits=self.calib.collective_fits, colocated=fc.colocated)
        self.pre_scaler = Autoscaler(fc.prefill_policy, pool="prefill",
                                     slo_ms=fc.slo_ms)
        self.dec_scaler = Autoscaler(fc.decode_policy, pool="decode",
                                     slo_ms=fc.slo_ms)
        self.finished: List = []
        self.rejected: List = []

    @staticmethod
    def _pool_cfgs(fc: FleetConfig, cfg) -> tuple:
        """(prefill, decode) model configs: ``cfg`` for both, else each
        pool's own."""
        own = (fc.prefill.model_config(), fc.decode.model_config())
        if cfg is None:
            return own
        if own[0].replace(name="") != own[1].replace(name=""):
            raise ValueError(f"cfg replaces one model config; the pools "
                             f"serve two ({fc.prefill.name}, "
                             f"{fc.decode.name})")
        return cfg, cfg

    def _executed_pools(self, cfgs, axes, device, params) -> list:
        """The executed pools' engine arguments on this rank: its mesh,
        its device and its weights of each pool's config."""
        from repro_torch.parallel.axes import MeshAxes, resolve_device
        from repro_torch.serve.router import serve_params
        mesh = executed_mesh(self.fc)
        axes = axes or MeshAxes()
        if (axes.dp, axes.tp) != mesh:
            raise ValueError(f"the pools run on dp x tp {mesh}, not on "
                             f"dp={axes.dp} x tp={axes.tp}")
        device = resolve_device(device)
        same = cfgs[0].replace(name="") == cfgs[1].replace(name="")
        if params is None:
            params = serve_params(cfgs[0], axes, self.seed, device)
        trees = [params, params if same else
                 serve_params(cfgs[1], axes, self.seed, device)]
        return [dict(params=t, axes=axes, device=device) for t in trees]

    @property
    def mixed(self) -> bool:
        return self.pre.mixed_lengths

    # --- admission -------------------------------------------------------

    def _padded_len(self, prompt_len: int) -> int:
        if self.mixed:
            return bucket_of(prompt_len, self.fc.decode.page_size)
        if prompt_len % self.fc.decode.page_size:
            raise ValueError(
                f"recurrent family: prompt length {prompt_len} must be "
                f"a multiple of {self.fc.decode.page_size}")
        return prompt_len

    def _admit(self, req) -> bool:
        s = req_prompt_len(req)
        if s <= 0:
            req.done, req.error = True, "rejected: empty prompt"
            return False
        try:
            padded = self._padded_len(s)
        except ValueError as exc:
            req.done, req.error = True, f"rejected: {exc}"
            return False
        need = padded + max(req.max_new_tokens, 1)
        if need > self.fc.decode.max_len \
                or padded > self.fc.prefill.max_len:
            req.done = True
            req.error = (f"rejected: padded prompt {padded} + "
                         f"{req.max_new_tokens} new tokens exceeds "
                         f"max_len {self.fc.decode.max_len}")
            return False
        if isinstance(req, FleetRequest):
            req.padded_len = padded
        return True

    # --- the a-priori transfer prediction --------------------------------

    def _transfer_prediction_stats(
            self, trace: Sequence[TraceItem]) -> tuple:
        """(expected migrations, mean padded prompt of migrators) from
        the trace ALONE (the predicted side of the transfer account must
        not peek at the run): a request migrates iff it statically
        admits and is not finished at prefill (exact-length with <= 1
        new token)."""
        migr, padded_sum = 0, 0.0
        for it in trace:
            s = it.prompt_len
            if s <= 0:
                continue
            try:
                padded = self._padded_len(s)
            except ValueError:
                continue
            if padded + max(it.max_new_tokens, 1) \
                    > self.fc.decode.max_len \
                    or padded > self.fc.prefill.max_len:
                continue
            if s == padded and it.max_new_tokens <= 1:
                continue
            migr += 1
            padded_sum += padded
        return migr, (padded_sum / migr if migr else 0.0)

    # --- the event loop --------------------------------------------------

    def run(self, trace: Sequence[TraceItem], *, sampling=None,
            max_events: int = 0) -> dict:
        fc = self.fc
        if fc.executed:
            reqs = trace_requests(trace,
                                  self.dec.account.cfg.vocab_size,
                                  seed=self.seed, sampling=sampling)
        else:
            reqs = [FleetRequest(req_id=i, prompt_len=it.prompt_len,
                                 max_new_tokens=it.max_new_tokens,
                                 arrival_s=it.arrival_s,
                                 deadline_ms=it.deadline_ms)
                    for i, it in enumerate(trace)]
        admitted = []
        for req in reqs:
            if self._admit(req):
                admitted.append(req)
            else:
                self.rejected.append(req)
        self._arrivals = deque(sorted(admitted,
                                      key=lambda r: r.arrival_s))
        self._heap: List[tuple] = []
        self._eseq = 0
        self._xseq = 0
        self._now = 0.0
        # in-flight transfers (min-heap by completion time) feeding an
        # FCFS adoption queue: O(log n) per bundle at 100k+ scale
        self._xfer: List[tuple] = []
        self._ready: deque = deque()
        self._inflight_prefills = 0
        self._last_tick = 0.0
        stats = trace_stats(trace, fc.decode.page_size)
        self._mean_bucket = bucket_of(
            max(int(round(stats["mean_padded_prompt"])), 1),
            fc.decode.page_size)
        self._mean_new = stats["mean_new_tokens"]
        self._push(fc.decode_policy.tick_s, "tick", None)
        events = 0
        with get_tracer().span("fleet/run", cat="fleet",
                               requests=len(reqs), executed=fc.executed,
                               colocated=fc.colocated):
            while True:
                self._ingest()
                self._dispatch()
                if not self._heap:
                    if self._arrivals:
                        self._now = self._arrivals[0].arrival_s
                        continue
                    break
                t, _, kind, payload = heapq.heappop(self._heap)
                self._now = max(self._now, t)
                self._handle(kind, payload)
                events += 1
                if max_events and events >= max_events:
                    break
        return self._report(trace, stats)

    def _push(self, t: float, kind: str, payload):
        self._eseq += 1
        heapq.heappush(self._heap, (t, self._eseq, kind, payload))

    def _ingest(self):
        while self._arrivals \
                and self._arrivals[0].arrival_s <= self._now:
            req = self._arrivals.popleft()
            req.t_submit_s = req.arrival_s
            self.pre.queue.append(req)

    def _has_work(self) -> bool:
        return bool(
            self.pre.queue or self._ready or self._xfer
            or self._inflight_prefills
            or any(r.busy or r.active for r in self.dec.replicas))

    def _over_min(self) -> bool:
        return (self.dec.n_active() > self.fc.decode_policy.min_replicas
                or self.pre.n_active()
                > self.fc.prefill_policy.min_replicas)

    # --- dispatch --------------------------------------------------------

    def _dispatch(self):
        self._adopt_ready()
        for rep in self.dec.replicas:
            if rep.state == "warming" or rep.busy:
                continue
            if self.fc.colocated and self.pre.queue \
                    and rep.free_slots():
                # the single-engine interleave: prefill a refill group
                # ON the decode replica, stalling its decode (exactly
                # ServeEngine's eager refill policy)
                S, group = form_group(self.pre.queue,
                                      min(rep.free_slots(),
                                          self.fc.decode.slots),
                                      self.fc.decode.page_size,
                                      self.mixed)
                if group:
                    done_t, results = self.pre.start_group(
                        None, S, group, self._now)
                    rep.busy = True
                    rep.busy_until = done_t
                    self._inflight_prefills += 1
                    self._push(done_t, "prefill_done",
                               (None, rep, S, results))
                    continue
            if rep.active:
                self._start_decode(rep)
        if not self.fc.colocated:
            for prep in self.pre.replicas:
                if prep.state != "active" or prep.busy \
                        or not self.pre.queue:
                    continue
                S, group = form_group(self.pre.queue,
                                      self.fc.prefill.slots,
                                      self.fc.prefill.page_size,
                                      self.mixed)
                if not group:
                    break
                with get_tracer().span("fleet/prefill", cat="fleet",
                                       bucket=S, group=len(group),
                                       replica=prep.id):
                    done_t, results = self.pre.start_group(
                        prep, S, group, self._now)
                self._inflight_prefills += 1
                self._push(done_t, "prefill_done",
                           (prep, None, S, results))

    def _start_decode(self, rep):
        step_s, e_j = self.dec.account.decode_step()
        self.dec.energy_j += e_j
        self.dec.steps += 1
        self.dec.busy_s += step_s
        with get_tracer().span("fleet/decode", cat="fleet",
                               replica=rep.id, active=rep.n_active()):
            rep.start_step(self._now, step_s)
        self._push(rep.busy_until, "decode_done", rep)

    def _adopt_ready(self):
        while self._xfer and self._xfer[0][0] <= self._now:
            self._ready.append(heapq.heappop(self._xfer)[2])
        while self._ready:
            bundle = self._ready[0]
            # bin-pack: fullest adoptable replica first keeps decode
            # occupancy (and therefore J/token) honest
            cands = [r for r in self.dec.replicas
                     if r.can_adopt(bundle)]
            if not cands:
                break               # FCFS: the head waits for capacity
            rep = max(cands, key=lambda r: (r.n_active(), -r.id))
            rep.adopt(bundle)
            self._ready.popleft()

    # --- event handlers --------------------------------------------------

    def _handle(self, kind: str, payload):
        if kind == "prefill_done":
            self._on_prefill_done(*payload)
        elif kind == "decode_done":
            self._on_decode_done(payload)
        elif kind == "bundle_ready":
            pass                        # a wake-up; dispatch adopts
        elif kind == "replica_ready":
            _pool, rep = payload
            if rep.state == "warming":
                rep.state = "active"
        elif kind == "tick":
            self._on_tick()

    def _on_prefill_done(self, prep, colo_rep, S, results):
        self._inflight_prefills -= 1
        step_rep = prep if prep is not None else colo_rep
        if step_rep is not None:
            step_rep.window_busy_s += \
                self.pre.account.prefill_step(S)[0]
            step_rep.busy = False
        for req, bundle, first_tok in results:
            if first_tok:
                req.t_first_s = self._now
                if isinstance(req, FleetRequest):
                    req.n_out = max(req.n_out, 1)
            if bundle is None:
                # finished AT prefill (exact length, <=1 new token)
                req.done = True
                req.t_done_s = self._now
                self.finished.append(req)
                continue
            self.channel.send(bundle, self._now)
            if self.fc.colocated:
                colo_rep.adopt(bundle)
            else:
                self._xseq += 1
                heapq.heappush(self._xfer,
                               (bundle.ready_s, self._xseq, bundle))
                self._push(bundle.ready_s, "bundle_ready", None)
        if prep is not None and prep.state == "draining":
            self.pre.retire(prep, self._now)

    def _on_decode_done(self, rep):
        step_s, _ = self.dec.account.decode_step()
        rep.window_busy_s += step_s
        cohort = len(rep.stepping)   # one token per stepping request
        done = rep.finish_step(self._now)
        self.dec.tokens += cohort
        self.finished.extend(done)
        get_metrics().counter(
            "fleet_decode_tokens_total",
            "tokens produced by fleet decode steps").inc(cohort)
        if rep.state == "draining" and not rep.active:
            self.dec.retire(rep, self._now)

    def _on_tick(self):
        dt = max(self._now - self._last_tick, 1e-9)
        self._last_tick = self._now
        pre_item_s = self.pre.account.prefill_step(
            self._mean_bucket)[0] / max(self.fc.prefill.slots, 1)
        dec_step_s = self.dec.account.decode_step()[0]
        dec_item_s = dec_step_s * max(self._mean_new, 1.0) \
            / max(self.fc.decode.slots, 1)
        plans = []
        if not self.fc.colocated:
            plans.append((self.pre, self.pre_scaler,
                          self.fc.prefill_policy,
                          len(self.pre.queue), pre_item_s))
        dec_depth = len(self._ready) + len(self._xfer) \
            + (len(self.pre.queue) if self.fc.colocated else 0)
        plans.append((self.dec, self.dec_scaler, self.fc.decode_policy,
                      dec_depth, dec_item_s))
        for pool, scaler, policy, depth, item_s in plans:
            n_act = pool.n_active()
            busy = sum(r.window_busy_s for r in pool.replicas)
            util = min(busy / (dt * max(n_act, 1)), 1.0)
            for r in pool.replicas:
                r.window_busy_s = 0.0
            act = scaler.evaluate(self._now, PoolStats(
                queue_depth=depth, n_active=n_act,
                n_warming=pool.n_warming(),
                service_s_per_item=item_s, busy_fraction=util))
            if act:
                self._execute_scale(pool, scaler, policy, act)
        mx = get_metrics()
        mx.gauge("fleet_prefill_replicas",
                 "active prefill replicas").set(self.pre.n_active())
        mx.gauge("fleet_decode_replicas",
                 "active decode replicas").set(self.dec.n_active())
        mx.gauge("fleet_prefill_queue_depth",
                 "requests waiting for a prefill slot").set(
                     len(self.pre.queue))
        mx.gauge("fleet_decode_queue_depth",
                 "KV bundles waiting for a decode slot").set(
                     len(self._ready) + len(self._xfer))
        if self._has_work() or self._arrivals or self._over_min():
            self._push(self._now + self.fc.decode_policy.tick_s,
                       "tick", None)

    def _execute_scale(self, pool, scaler, policy: AutoscalePolicy,
                       action: str):
        ev = scaler.events[-1]
        with get_tracer().span("fleet/scale", cat="fleet",
                               pool=ev.pool, action=action,
                               replicas=ev.replicas,
                               reason=ev.reason):
            if action == "up":
                rep = pool.add_replica(self._now, policy.spinup_s)
                self._push(rep.ready_s, "replica_ready", (ev.pool, rep))
            elif pool is self.dec:
                victim = self.dec.drain_victim()
                if victim is not None:
                    victim.state = "draining"
                    if not victim.active and not victim.busy:
                        self.dec.retire(victim, self._now)
            else:
                idle = [r for r in pool.replicas
                        if r.state == "active" and not r.busy]
                if idle:
                    pool.retire(idle[-1], self._now)
                else:
                    busy = [r for r in pool.replicas
                            if r.state == "active"]
                    if busy:
                        busy[-1].state = "draining"

    # --- reporting -------------------------------------------------------

    def _report(self, trace, stats) -> dict:
        fc = self.fc
        tracker = SLOTracker(slo_ttft_ms=fc.slo_ms)
        tracker.observe_all(self.finished)
        slo = tracker.report()
        tokens = max(slo.get("generated_tokens", 0), 1)
        migr_pred, mean_padded_pred = \
            self._transfer_prediction_stats(trace)
        xfer_meas = self.channel.measured()
        xfer_pred = self.channel.predicted(migr_pred, mean_padded_pred)
        ratio_wire = (xfer_meas["transfer_wire_bytes"]
                      / xfer_pred["transfer_wire_bytes"]
                      if xfer_pred["transfer_wire_bytes"] else 0.0)
        # a replica that is up but not stepping burns static power B on
        # its devices: THIS is what scale-down saves, and what keeps an
        # over-provisioned fleet from looking free
        end_s = self._now
        self.pre.close_uptime(end_s)
        self.dec.close_uptime(end_s)
        pre_idle = FRONTIER_B_W * max(
            self.pre.device_s
            - self.fc.prefill.devices * self.pre.busy_s, 0.0)
        # colocated: prefill steps ran ON decode replicas, so their
        # busy time offsets decode idle (their step energy is already
        # billed in the prefill pool's compute account)
        dec_busy_s = self.dec.busy_s + (
            self.pre.busy_s if fc.colocated else 0.0)
        dec_idle = FRONTIER_B_W * max(
            self.dec.device_s
            - self.fc.decode.devices * dec_busy_s, 0.0)
        j_pre = (self.pre.energy_j + pre_idle) / tokens
        j_dec = (self.dec.energy_j + dec_idle) / tokens
        j_xfer = self.channel.energy_j() / tokens
        events = (self.pre_scaler.events + self.dec_scaler.events)
        events.sort(key=lambda e: e.t_s)
        report = {
            "mode": "executed" if fc.executed else "modeled",
            "colocated": fc.colocated,
            "fleet": fc.as_dict(),
            "slo": slo,
            "requests": {"trace": len(trace),
                         "finished": len(self.finished),
                         "rejected": len(self.rejected)},
            "pools": {
                "prefill": {
                    "config": fc.prefill.name,
                    "steps": self.pre.steps,
                    "steps_by_bucket": dict(self.pre.steps_by_bucket),
                    "compute_j": self.pre.energy_j,
                    "idle_j": pre_idle,
                    "busy_s": self.pre.busy_s,
                    "device_s": self.pre.device_s,
                    "replicas_final": len(self.pre.replicas),
                    "replicas_retired": self.pre.retired,
                    "j_per_token": j_pre,
                },
                "decode": {
                    "config": fc.decode.name,
                    "steps": self.dec.steps,
                    "compute_j": self.dec.energy_j,
                    "idle_j": dec_idle,
                    "busy_s": dec_busy_s,
                    "device_s": self.dec.device_s,
                    "tokens": self.dec.tokens,
                    "replicas_final": len(self.dec.replicas),
                    "replicas_peak": self.dec.replica_peak,
                    "replicas_retired": self.dec.retired,
                    "j_per_token": j_dec,
                },
            },
            "transfer": {
                "measured": xfer_meas,
                "predicted": xfer_pred,
                "ratio_wire_bytes": ratio_wire,
                "ratio_migrations": (
                    xfer_meas["migrations"] / migr_pred
                    if migr_pred else 0.0),
            },
            "scale_events": [e.as_dict() for e in events],
            "scale_ups": sum(e.action == "up" for e in events),
            "scale_downs": sum(e.action == "down" for e in events),
            "j_per_token": {"prefill": j_pre, "decode": j_dec,
                            "transfer": j_xfer,
                            "fleet": j_pre + j_dec + j_xfer},
        }
        if self.ledger is not None:
            self._record(report, stats)
        return report

    def _pool_energy_rows(self, pool, phase: str) -> tuple:
        """(measured, predicted) per-step energy dicts for one pool:
        predicted from the calibrated serve prediction, measured from
        the counted steps when the account prices them."""
        acct = pool.account
        dp = acct.sc.dp
        steps = max(pool.steps, 1)
        if phase == "prefill":
            pred_e = sum(
                acct.predicted_prefill(S)["energy_j_per_iter"] * dp * n
                for S, n in pool.steps_by_bucket.items())
            meas_e = sum(
                acct.measured_prefill(S)["energy_j_per_iter"] * dp * n
                for S, n in pool.steps_by_bucket.items()) \
                if acct.price_counted else None
        else:
            pred_e = acct.predicted_decode()["energy_j_per_iter"] \
                * dp * pool.steps
            meas_e = (acct.measured_decode()["energy_j_per_iter"]
                      * dp * pool.steps) if acct.price_counted else None
        predicted = {"energy_j_per_iter": pred_e / steps,
                     "energy_j": pred_e, "iterations": pool.steps}
        measured = None
        if meas_e is not None:
            measured = {"energy_j_per_iter": meas_e / steps,
                        "energy_j": meas_e, "iterations": pool.steps}
        return measured, predicted

    def _record(self, report: dict, stats: dict):
        from repro_torch.telemetry.ledger import LedgerEntry
        fc = self.fc
        arch = fc.decode.arch
        tag = "baseline" if fc.colocated else "fleet"
        if not fc.colocated:
            self.ledger.record(LedgerEntry(
                name=f"fleet_transfer_{arch}", suite="fleet",
                kind="transfer", arch=arch,
                impl=f"{fc.prefill.impl}->{fc.decode.impl}",
                p=fc.decode.tp,
                measured=report["transfer"]["measured"],
                predicted=report["transfer"]["predicted"],
                extra={"ratio_wire_bytes":
                       report["transfer"]["ratio_wire_bytes"]}))
        for pool, phase, sc in ((self.pre, "prefill", fc.prefill),
                                (self.dec, "decode", fc.decode)):
            if not pool.steps:
                continue
            measured, predicted = self._pool_energy_rows(pool, phase)
            self.ledger.record(LedgerEntry(
                name=f"{tag}_{phase}_{sc.name}", suite="fleet",
                kind=phase, arch=arch, impl=sc.impl, p=sc.tp,
                measured=measured, predicted=predicted,
                extra={"pool": report["pools"][phase]}))
        self.ledger.record(LedgerEntry(
            name=f"{tag}_summary_{arch}", suite="fleet",
            kind="analytic", arch=arch,
            impl=f"{fc.prefill.impl}+{fc.decode.impl}",
            p=fc.decode.tp,
            extra={"slo": report["slo"],
                   "j_per_token": report["j_per_token"],
                   "requests": report["requests"],
                   "scale_events": report["scale_events"],
                   "transfer_ratio":
                       report["transfer"]["ratio_wire_bytes"],
                   "trace": stats}))
