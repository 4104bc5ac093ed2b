"""Fleet pools: the prefill and decode runner pools (the reference's
``serve/fleet/runners.py``).

Each pool serves one phase of the disaggregated pipeline on its own
``ServeConfig`` (family x mesh x slots, picked per phase by predicted
joules per token, see ``fleet.router.plan_pools``) and runs in one of
two modes:

  * **modeled** (default): no tensors move; step durations come from the
    calibrated ``serve_step_prediction`` (the modeled accelerator's
    alpha + beta seconds) and step energies from the same account, or,
    with ``price_counted``, from one counted step of the pool's own step
    functions.  This is what makes million-request replays tractable:
    the discrete-event loop advances a virtual clock through predicted
    step times in pure Python.
  * **executed**: real ``ServeEngine``s on this rank's device: the
    prefill pool runs ``forward_prefill`` on the pool's weights for a
    group and takes each request's cache rows out of it for migration
    (a device-to-device copy); every decode replica is a
    ``ServeEngine`` (sharing the pool's weights) that ``adopt``s
    migrated pages.  Tokens are real; the *clock* is still the modeled
    accelerator in both modes, so SLO numbers are comparable and the
    executed mode exists to prove token-exactness across the migration
    and to run the kernels under the fleet, not to time the card.  On a
    dp x tp mesh every rank runs the same pools on its shard of the
    weights: a prefill group's rows are gathered over dp, so each rank
    holds every request's rows of its tp shard, and the migration is
    rank-local plus ``adopt``'s tp relayout.

Step energy is billed at the full batch shape regardless of slot
occupancy, the same honesty rule as the single-engine serving path: a
half-empty decode step costs what the full step costs, and the fleet's
J/token surfaces the occupancy gap instead of hiding it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.energy import H100_PEAK_FLOPS_FP32
from repro_torch.planner.calibration import Calibration
from repro_torch.serve.fleet.transfer import KVBundle
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.router import ServeConfig
from repro_torch.serve.scheduler import bucket_of


class _TokenCount:
    """``len()``-only stand-in for a modeled request's output tokens
    (the SLO tracker and goodput weighting only ever take ``len``)."""

    __slots__ = ("n",)

    def __init__(self, n: int = 0):
        self.n = n

    def __len__(self) -> int:
        return self.n


@dataclass
class FleetRequest:
    """A modeled request: lengths and stamps, no token arrays."""
    req_id: int
    prompt_len: int
    max_new_tokens: int
    arrival_s: float = 0.0
    deadline_ms: float = 0.0
    padded_len: int = 0
    pos: int = 0
    n_out: int = 0
    done: bool = False
    error: Optional[str] = None
    t_submit_s: Optional[float] = None
    t_first_s: Optional[float] = None
    t_done_s: Optional[float] = None
    _slot: int = field(default=-1, repr=False)

    @property
    def out_tokens(self) -> _TokenCount:
        return _TokenCount(self.n_out)


def req_prompt_len(req) -> int:
    """Prompt length of a modeled OR executed request."""
    if isinstance(req, FleetRequest):
        return req.prompt_len
    return len(req.prompt)


def form_group(queue: List, slots: int, page_size: int,
               mixed: bool) -> tuple:
    """FCFS head-bucket group formation (the scheduler's policy,
    restated over either request flavor): the queue head picks the
    padded bucket, up to ``slots`` requests sharing it join.  Mutates
    ``queue``; returns ``(padded_len, group)``."""
    if not queue or slots <= 0:
        return 0, []

    def padded(r):
        s = req_prompt_len(r)
        return bucket_of(s, page_size) if mixed else s
    head = padded(queue[0])
    group = []
    for r in queue:
        if padded(r) == head:
            group.append(r)
            if len(group) == slots:
                break
    taken = set(id(r) for r in group)
    queue[:] = [r for r in queue if id(r) not in taken]
    return head, group


# ---------------------------------------------------------------------------
# per-pool step pricing
# ---------------------------------------------------------------------------

class PoolAccount:
    """Step times and energies for one pool's ``ServeConfig``.

    Durations are always the modeled accelerator (calibrated
    ``serve_step_prediction`` alpha + beta at ``peak_flops``, as
    ``serve/router.py: price_config`` prices).  Energies default to the
    same prediction.  ``price_counted`` is the reference's ``price_hlo``:
    the reference lowers the pool's step functions once per bucket and
    prices their compiled HLO; the port cannot lower, and prices one
    counted step instead (``telemetry/counted.py: count_step``, priced
    by ``measured_energy_fields``, as ``run_config`` does), run once per
    bucket on the executed pool's engine (``engine``, set by the pool).
    ``cfg`` is the model config the pool serves (default
    ``sc.model_config()``; a depth cut)."""

    def __init__(self, sc: ServeConfig, calib: Calibration, *, cfg=None,
                 price_counted: bool = False,
                 peak_flops: float = H100_PEAK_FLOPS_FP32):
        self.sc = sc
        self.calib = calib
        self.cfg = cfg or sc.model_config()
        a_s, b_s, _nu = calib.scales_for(sc.strategy_kind)
        self.alpha_scale, self.beta_scale = a_s, b_s
        self.price_counted = price_counted
        self.peak_flops = peak_flops
        self.engine = None            # the executed pool's step functions
        self._pred_pre: Dict[int, dict] = {}
        self._pred_dec: Optional[dict] = None
        self._counted_pre: Dict[int, dict] = {}
        self._counted_dec: Optional[dict] = None

    # --- predictions -----------------------------------------------------

    def _prediction(self, rows: int, **kw) -> dict:
        from repro_torch.telemetry.predict import serve_step_prediction
        sc = self.sc
        return serve_step_prediction(
            self.cfg, sc.tp, rows, dp=sc.dp,
            fits=self.calib.collective_fits, alpha_scale=self.alpha_scale,
            beta_scale=self.beta_scale, peak_flops=self.peak_flops, **kw)

    def predicted_prefill(self, S: int) -> dict:
        if S not in self._pred_pre:
            sc = self.sc
            self._pred_pre[S] = self._prediction(
                sc.slots * S, phase="prefill", ctx_tokens=float(S),
                sequences=sc.slots)
        return self._pred_pre[S]

    def predicted_decode(self) -> dict:
        if self._pred_dec is None:
            sc = self.sc
            self._pred_dec = self._prediction(
                sc.slots, phase="decode", ctx_tokens=float(sc.max_len))
        return self._pred_dec

    # --- counted steps ---------------------------------------------------

    def _counted(self, fn, *args) -> dict:
        from repro_torch.telemetry.counted import count_step
        from repro_torch.telemetry.predict import measured_energy_fields
        costs, _ = count_step(fn, *args, device=self.engine.device)
        return measured_energy_fields(costs, self.sc.tp,
                                      fits=self.calib.collective_fits,
                                      peak_flops=self.peak_flops)

    def measured_prefill(self, S: int) -> dict:
        if S not in self._counted_pre:
            import torch
            eng = self.engine
            zeros = torch.zeros((len(eng.rows), S), dtype=torch.long,
                                device=eng.device)
            self._counted_pre[S] = self._counted(eng.prefill_fn, zeros)
        return self._counted_pre[S]

    def measured_decode(self) -> dict:
        if self._counted_dec is None:
            import torch
            eng = self.engine
            zeros = torch.zeros((len(eng.rows),), dtype=torch.long,
                                device=eng.device)
            self._counted_dec = self._counted(
                eng.decode_fn, eng._zero_cache(), zeros[:, None], zeros)
        return self._counted_dec

    # --- step cost -------------------------------------------------------

    def prefill_step(self, S: int) -> tuple:
        """(step_s, energy_j) of one GLOBAL prefill step at bucket S
        (all dp groups; slots*dp prompts)."""
        pred = self.predicted_prefill(S)
        step_s = pred["alpha_s"] + pred["beta_s"]
        src = self.measured_prefill(S) if self.price_counted else pred
        return step_s, src["energy_j_per_iter"] * self.sc.dp

    def decode_step(self) -> tuple:
        """(step_s, energy_j) of one GLOBAL decode step (slots*dp
        token rows at the full batch shape)."""
        pred = self.predicted_decode()
        step_s = pred["alpha_s"] + pred["beta_s"]
        src = self.measured_decode() if self.price_counted else pred
        return step_s, src["energy_j_per_iter"] * self.sc.dp


# ---------------------------------------------------------------------------
# replicas
# ---------------------------------------------------------------------------

@dataclass
class Replica:
    """Shared replica lifecycle state (both pools)."""
    id: int
    state: str = "warming"        # warming | active | draining
    spawn_s: float = 0.0          # when the replica started burning
    ready_s: float = 0.0
    busy: bool = False
    busy_until: float = 0.0
    window_busy_s: float = 0.0    # busy time since the last policy tick
    steps: int = 0


class DecodeReplica(Replica):
    """One decode engine: page table + active requests (modeled), or a
    real ``ServeEngine`` sharing the pool's weights (executed)."""

    def __init__(self, rid: int, sc: ServeConfig, engine=None):
        super().__init__(rid)
        self.sc = sc
        self.engine = engine
        self.pages = engine.pages if engine is not None else \
            PagedKVCache(sc.slots, sc.max_len, sc.page_size)
        self.active: List = []        # requests resident in slots
        self.stepping: List = []      # cohort of the in-flight step
        self._free_slots = list(range(sc.slots))

    def n_active(self) -> int:
        return len(self.active)

    def free_slots(self) -> int:
        return self.sc.slots - len(self.active)

    # --- adoption --------------------------------------------------------

    def can_adopt(self, bundle: KVBundle) -> bool:
        if self.state != "active" or not self.free_slots():
            return False
        req = bundle.req
        return self.pages.can_admit(req_prompt_len(req),
                                    req.max_new_tokens,
                                    bundle.prefill_len)

    def adopt(self, bundle: KVBundle):
        req = bundle.req
        if self.engine is not None:
            self.engine.adopt(req, bundle.cache_rows,
                              prefill_len=bundle.prefill_len,
                              pos=bundle.pos, last_tok=bundle.last_tok)
            bundle.cache_rows = None      # the engine's cache holds them
        else:
            slot = self._free_slots.pop(0)
            self.pages.alloc(slot, bundle.prefill_len)
            req._slot = slot
            req.pos = bundle.pos
        self.active.append(req)

    # --- one decode step -------------------------------------------------

    def start_step(self, now_s: float, step_s: float):
        """Snapshot the stepping cohort; executed replicas run the real
        engine NOW with its virtual clock pinned to the completion time
        so finish stamps land on the fleet clock."""
        self.busy = True
        self.busy_until = now_s + step_s
        self.stepping = list(self.active)
        if self.engine is not None:
            self.engine.now_s = now_s + step_s
            self.engine.step()

    def finish_step(self, now_s: float) -> List:
        """Apply the step's effects at its (virtual) completion time;
        returns the requests that finished."""
        self.busy = False
        self.steps += 1
        done = []
        if self.engine is not None:
            # the engine already advanced state/pages and stamped
            # t_first/t_done on the pinned clock: just collect
            done = [r for r in self.stepping if r.done]
        else:
            for req in self.stepping:
                wrote = req.pos
                req.pos += 1
                self.pages.advance(req._slot, wrote)
                req.n_out += 1
                if req.t_first_s is None:
                    req.t_first_s = now_s
                if (req.n_out >= req.max_new_tokens
                        or req.pos >= self.sc.max_len - 1):
                    req.done = True
                    req.t_done_s = now_s
                    self.pages.free(req._slot)
                    self._free_slots.append(req._slot)
                    self._free_slots.sort()
                    done.append(req)
        finished = set(id(r) for r in done)
        self.active = [r for r in self.active
                       if id(r) not in finished]
        self.stepping = []
        return done


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------

def _pool_engine(account: PoolAccount, params, axes, device):
    """A ``ServeEngine`` of the pool's config on this rank, its clock
    the fleet's (``clock_scale = 0``)."""
    from repro_torch.serve.engine import ServeEngine
    sc = account.sc
    eng = ServeEngine(account.cfg, params, slots=sc.slots,
                      max_len=sc.max_len, page_size=sc.page_size, axes=axes,
                      device=device)
    eng.clock_scale = 0.0          # the fleet clock is authoritative
    return eng


class _Pool:
    """Replica bookkeeping both pools share."""

    def n_active(self) -> int:
        return sum(r.state == "active" for r in self.replicas)

    def n_warming(self) -> int:
        return sum(r.state == "warming" for r in self.replicas)

    def retire(self, rep: Replica, now_s: float = 0.0):
        self.replicas.remove(rep)
        self.retired += 1
        self.device_s += self.sc.devices * max(now_s - rep.spawn_s, 0.0)

    def close_uptime(self, end_s: float):
        """Bill the remaining replicas' uptime at the end of a run."""
        for rep in self.replicas:
            self.device_s += self.sc.devices * \
                max(end_s - rep.spawn_s, 0.0)
            rep.spawn_s = end_s


class PrefillPool(_Pool):
    """Stateless prefill replicas: each runs one length-bucketed group
    per step and hands every surviving request to the transfer channel
    as a ``KVBundle``.  Executed, ``params`` are this rank's weights of
    the pool's config on ``axes`` (its dp x tp mesh) and ``device``."""

    def __init__(self, sc: ServeConfig, account: PoolAccount, *,
                 executed: bool = False, n_init: int = 1, params=None,
                 axes=None, device=None):
        self.sc = sc
        self.account = account
        self.executed = executed
        self.queue: List = []
        self.replicas: List[Replica] = []
        self.retired = 0
        self._next_id = 0
        self.energy_j = 0.0           # compute (stepped) joules
        self.steps = 0
        self.steps_by_bucket: Dict[int, int] = {}
        self.prompt_tokens = 0
        self.busy_s = 0.0             # replica-seconds spent stepping
        self.device_s = 0.0           # device-seconds powered (uptime)
        self.engine = None
        if executed:
            # one engine for the pool's step functions: its prefill_fn
            # (``forward_prefill`` with the engine's stubs) runs every
            # replica's groups
            self.engine = _pool_engine(account, params, axes, device)
            account.engine = self.engine
        for _ in range(n_init):   # 0 = colocated (no prefill replicas)
            rep = self.add_replica(0.0, 0.0)
            rep.state = "active"

    @property
    def mixed_lengths(self) -> bool:
        from repro_torch.serve.engine import RECURRENT_FAMILIES
        return self.account.cfg.family not in RECURRENT_FAMILIES

    def add_replica(self, now_s: float, spinup_s: float) -> Replica:
        rep = Replica(self._next_id, spawn_s=now_s,
                      ready_s=now_s + spinup_s)
        self._next_id += 1
        self.replicas.append(rep)
        return rep

    # --- one prefill step ------------------------------------------------

    def start_group(self, rep: Optional[Replica], S: int, group: List,
                    now_s: float) -> tuple:
        """Begin one batched prefill; returns ``(done_t, results)``
        where each result is ``(req, bundle_or_None, first_tok_done)``
        applied by the router at ``done_t``."""
        step_s, e_j = self.account.prefill_step(S)
        if rep is not None:        # colocated: the decode replica hosts
            rep.busy = True        # the step; the router marks it busy
            rep.busy_until = now_s + step_s
            rep.steps += 1
        self.steps += 1
        self.steps_by_bucket[S] = self.steps_by_bucket.get(S, 0) + 1
        self.energy_j += e_j
        self.busy_s += step_s
        self.prompt_tokens += sum(req_prompt_len(r) for r in group)
        if self.executed:
            results = self._execute_group(S, group)
        else:
            results = []
            for req in group:
                exact = req.prompt_len == S
                if exact and req.max_new_tokens <= 1:
                    results.append((req, None, True))
                else:
                    pos = S if exact else req.prompt_len - 1
                    results.append((req, KVBundle(
                        req=req, prefill_len=S, pos=pos, last_tok=0),
                        exact))
        return now_s + step_s, results

    def _execute_group(self, S: int, group: List) -> List:
        """Real batched prefill on this rank: the pool's prefill
        function on the group's prompts (padded to ``S``), each
        request's cache rows taken out for migration (a copy on the
        device), and the first token sampled for exact-length prompts
        (the engine's replay-last-token contract, mirrored here so
        adoption reproduces ``_prefill_group`` state exactly).  At
        dp > 1 the ranks' rows and logits are all-gathered over dp, so
        every rank holds every request's rows of its tp shard.  A
        bundle's ``wire_bytes`` are the request's global rows: this
        rank's rows summed over its tp group, whose ranks each hold an
        equal shard of every leaf (sequence positions, SSD channels or
        heads)."""
        import torch
        from repro_torch.parallel.params import tree_leaves, tree_map
        from repro_torch.serve.sampling import Sampler
        eng = self.engine
        slots = self.sc.slots
        toks = np.zeros((slots, S), np.int32)
        for i, req in enumerate(group):
            toks[i, :len(req.prompt)] = req.prompt
        # metered by the engine's StepMeter; its clock is the fleet's
        logits, fresh = eng._timed(eng.prefill_meter, eng.prefill_fn,
                                   eng._tensor(toks))
        dp = eng.axes.dp_comm.unrecorded()
        if dp.size > 1:
            # rows are dim 0 of the logits, dim 1 of a cache leaf
            logits = torch.cat(dp.all_gather(logits).unbind(0), 0)
            fresh = tree_map(
                lambda t: torch.cat(dp.all_gather(t).unbind(0), 1), fresh)
        logits = logits.float().cpu().numpy()
        results = []
        for i, req in enumerate(group):
            rows = tree_map(lambda f: f[:, i:i + 1].clone(), fresh)
            wire = float(eng.axes.tp * sum(
                t.numel() * t.element_size()
                for _, t in tree_leaves(rows)))
            s = len(req.prompt)
            if req._sampler is None:
                req._sampler = Sampler(req.sampling,
                                       self.account.cfg.vocab_size)
            if s == S:
                nxt = req._sampler(logits[i, 0])
                req.out_tokens.append(nxt)
                if nxt == req.eos_id or req.max_new_tokens <= 1:
                    results.append((req, None, True))
                    continue
                bundle = KVBundle(req=req, prefill_len=S, pos=s,
                                  last_tok=int(nxt), cache_rows=rows,
                                  wire_bytes=wire)
                results.append((req, bundle, True))
            else:
                bundle = KVBundle(req=req, prefill_len=S, pos=s - 1,
                                  last_tok=int(req.prompt[s - 1]),
                                  cache_rows=rows, wire_bytes=wire)
                results.append((req, bundle, False))
        return results


class DecodePool(_Pool):
    """Elastic decode replicas; executed replicas are ``ServeEngine``s
    sharing the pool's weights (``params``, this rank's on ``axes`` and
    ``device``)."""

    def __init__(self, sc: ServeConfig, account: PoolAccount, *,
                 executed: bool = False, n_init: int = 1, params=None,
                 axes=None, device=None):
        self.sc = sc
        self.account = account
        self.executed = executed
        self.replicas: List[DecodeReplica] = []
        self.retired = 0
        self.replica_peak = 0
        self._next_id = 0
        self.energy_j = 0.0           # compute (stepped) joules
        self.steps = 0
        self.tokens = 0
        self.busy_s = 0.0             # replica-seconds spent stepping
        self.device_s = 0.0           # device-seconds powered (uptime)
        self._engine_args = (params, axes, device)
        for _ in range(max(n_init, 1)):   # decode always has >= 1
            rep = self.add_replica(0.0, 0.0)
            rep.state = "active"

    def add_replica(self, now_s: float,
                    spinup_s: float) -> DecodeReplica:
        engine = None
        if self.executed:
            engine = _pool_engine(self.account, *self._engine_args)
            if self.account.engine is None:
                self.account.engine = engine
        rep = DecodeReplica(self._next_id, self.sc, engine)
        rep.spawn_s = now_s
        rep.ready_s = now_s + spinup_s
        self._next_id += 1
        self.replicas.append(rep)
        self.replica_peak = max(self.replica_peak, len(self.replicas))
        return rep

    def drain_victim(self) -> Optional[DecodeReplica]:
        """Least-loaded active replica (idle preferred): draining never
        drops tokens, it just stops adopting."""
        cands = [r for r in self.replicas if r.state == "active"]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.n_active(), r.id))
