"""Elastic fault-tolerant training with energy-aware re-planning: the
port of the reference's ``train/elastic.py`` on the paper-FFN subject,
with one world of ranks per phase, as ``torchrun`` restarts a world when
its membership changes.

The parent process keeps the reference's loop state: a
``SimulatedCluster`` of N hosts heartbeating on a virtual clock, the
``RestartPolicy``, the planner, the checkpoint index and the recovery
account.  The cluster runs on the virtual clock, so the parent plays
each step's events ahead in the reference's order (the kill, ``advance``,
``tick``, ``check``) until the step at which the monitor detects a loss,
and then runs the steps before it: a phase spawns ``plan.devices`` ranks
(``launch/mesh.py: spawn``) for the steps ``[start, detect)``.  The
ranks train the metered step toward the target loss (stopping early
when they reach it), checkpoint asynchronously on the cadence (each rank
its own blocks, ``train/checkpoint.py``) or when rank 0's straggler
detector asks for it (``train/trainer.py: rank0_decision``), flush
before they return, and return their losses, step times and saves.

On a detected loss the parent asks the policy, RE-SOLVES dp x tp x k for
the surviving devices (``solve_plan``: ``enumerate_plans`` -> HBM filter
-> ``score_plans`` -> sorted by total energy; tensor plans pin to the
whole surviving budget, phantom plans may downsize) and restores the
latest complete checkpoint: a same-class re-plan restores exactly
(global arrays, cut for the new mesh by the ranks); a class change, the
paper's downsize from tensor onto a phantom plan on fewer devices,
re-factors each layer's dense equivalent through the truncated-SVD
phantom initialiser (``core/lowrank.py: svd_phantom_init``), and the
optimizer's moments restart at zero.  Every recovery is priced
(``telemetry/predict.py: recovery_account``) and the run lands in the
ledger (kind ``elastic``).

``compile_s`` of a phase is the spawn, the step's build and a warm-up
step on a throwaway copy of the state, so it stays out of the first
resumed step's time.  The reference's static audit of a re-plan lowers
HLO and is not ported: ``solve_plan(audit=True)`` raises (ROADMAP.md
queue 1, item 8 part 4).  The elastic plans run ``kernel_backend="xla"``,
the plain torch core, as the reference's run XLA's.

Observability, as the reference's: the parent's ``elastic/run``,
``elastic/plan``, ``elastic/replan`` and ``elastic/restore`` spans, the
``elastic/detect`` instant, ``elastic_host_failures_total`` and
``elastic_recoveries_total``; in the ranks (merged under their pids,
``obs/ranks.py``) an ``elastic/step`` span a step and the train
metrics, and rank 0's ``elastic/compile`` span a phase, which opens at
the parent's spawn so that it times what ``compile_s`` counts.  The
energy-drift ``watchdog`` lives in the parent across phases: each
phase's rank 0 gets its state, observes its steps and hands the state
back, so ``watchdog.trips`` is the run's; its anomaly rows reach the
ledger with the phase's straggler events.  A step in
``cfg.slow_steps`` sleeps ``base x (slow_factor - 1)`` inside the
metered window on every rank (after a ``torch.cuda.synchronize`` on the
card, so the meter's CUDA events bracket it), ``base`` being rank 0's
``watchdog.reference_s()``.  A step's seconds come from ``step_clock``
(``train/trainer.py: metered_seconds`` unless a test injects one).

``python -m repro_torch.launch.train --elastic --kill-at-step N`` drives
this loop from the command line.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import PHANTOM_KINDS
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.planner import (DEFAULT_HBM_BYTES, Constraints,
                                 PlanCandidate, enumerate_plans,
                                 filter_feasible, score_plans)
from repro_torch.telemetry import LedgerEntry, StepMeter, recovery_account
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import (FaultScript, RestartPolicy,
                                     SimulatedCluster, StragglerDetector,
                                     note_step_time)
from repro_torch.train.trainer import (metered_seconds, rank0_decision,
                                      rank0_value)

AUDIT_TODO = "ROADMAP.md queue 1, item 8 part 4"
PHASE_TIMEOUT_S = 1800.0     # a phase's ranks, before they are killed


# ---------------------------------------------------------------------------
# configuration & results
# ---------------------------------------------------------------------------

@dataclass
class ElasticConfig:
    """One elastic training run (paper-FFN teacher-matching subject).
    ``hbm_gb`` defaults to the H100's 80 GB (the reference's 16 is a TPU
    v5e's) and ``audit_replan`` to off: the gate is not ported."""
    workdir: str                    # checkpoint + heartbeat directories
    devices: int = 8                # full-fleet device budget
    hosts: int = 4                  # simulated hosts (devices % hosts == 0)
    width: int = 256                # FFN width n (fixed across re-plans)
    depth: int = 2                  # layers L
    batch: int = 64                 # global rows per step
    target_loss: float = 0.05
    max_steps: int = 300
    checkpoint_every: int = 10
    keep_checkpoints: int = 3
    strategies: Tuple[str, ...] = ("tensor_col", "phantom")
    initial_strategy: Optional[str] = None   # pin phase-0 family
    ks: Tuple[int, ...] = (4, 8, 16)
    pps: Tuple[int, ...] = (1,)
    hbm_gb: float = DEFAULT_HBM_BYTES / 2 ** 30
    lr: float = 3e-3
    seed: int = 0
    max_restarts: int = 4
    heartbeat_timeout_s: float = 2.5   # virtual seconds
    virtual_dt: float = 1.0            # virtual seconds per step
    audit_replan: bool = False         # the static audit gate
    straggler_window: int = 50
    straggler_threshold: float = 4.0
    # watchdog fixtures: sleep inside the metered call at these steps so
    # the step runs ~slow_factor x its healthy wall time (the injected
    # anomaly the energy-drift watchdog must trip on)
    slow_steps: Tuple[int, ...] = ()
    slow_factor: float = 6.0


@dataclass
class ElasticResult:
    reached_target: bool
    aborted: bool
    final_loss: float
    final_step: int
    phases: List[dict]
    recoveries: List[dict]
    account: dict
    plan_names: List[str] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {"reached_target": self.reached_target,
                "aborted": self.aborted, "final_loss": self.final_loss,
                "final_step": self.final_step, "phases": self.phases,
                "recoveries": self.recoveries, "account": self.account,
                "plan_names": self.plan_names}


# ---------------------------------------------------------------------------
# energy-aware re-planning
# ---------------------------------------------------------------------------

def plan_from_dict(d: dict) -> PlanCandidate:
    """Rebuild the checkpoint-meta plan record (``PlanCandidate.
    as_dict``): a restore needs the class it converts FROM."""
    return PlanCandidate(
        dp=int(d["dp"]), tp=int(d["tp"]), strategy=d["strategy"],
        width=int(d["width"]), depth=int(d["depth"]),
        batch=int(d["batch"]), k=int(d.get("k", 0)),
        pp=int(d.get("pp", 1)), site=d.get("site", "ffn_layer"),
        microbatches=int(d.get("microbatches", 1)))


def solve_plan(device_budget: int, cfg: ElasticConfig, calib, *,
               strategies: Optional[Sequence[str]] = None,
               audit: Optional[bool] = None):
    """Re-solve dp x tp x pp x k for ``device_budget`` devices: tensor
    plans pin to the FULL budget, phantom plans may downsize; candidates
    are filtered for HBM fit and priced with the calibrated model, and
    the cheapest in total energy (then by name) wins.  Returns
    ``(ScoredPlan, audit_results)``; raises RuntimeError when no plan
    fits.  The static audit (``audit`` or ``cfg.audit_replan``) is not
    ported and raises."""
    audit = cfg.audit_replan if audit is None else audit
    if audit:
        raise NotImplementedError(
            f"solve_plan(audit=True): the static audit of a re-plan lowers "
            f"the step to HLO in the reference; its torch counterpart is "
            f"not ported ({AUDIT_TODO})")
    candidates = enumerate_plans(
        device_budget, width=cfg.width, depth=cfg.depth, batch=cfg.batch,
        strategies=tuple(strategies or cfg.strategies), ks=cfg.ks,
        pps=cfg.pps)
    feasible, _rej = filter_feasible(candidates, Constraints(
        max_devices=device_budget,
        hbm_bytes_per_device=cfg.hbm_gb * 2 ** 30))
    if not feasible:
        raise RuntimeError(
            f"no feasible plan for {device_budget} device(s) "
            f"(width={cfg.width}, strategies={cfg.strategies})")
    scored = score_plans(feasible, calib, iterations=float(cfg.max_steps))
    scored.sort(key=lambda s: (s.energy_j_total, s.plan.name))
    return scored[0], {}


# ---------------------------------------------------------------------------
# cross-mesh / cross-class parameter conversion
# ---------------------------------------------------------------------------

def _plan_class(plan: PlanCandidate) -> tuple:
    """The model class a plan trains: the phantom family depends on
    (k, tp) (paper Table I), the dense family on nothing of the mesh."""
    if plan.strategy in PHANTOM_KINDS:
        return ("phantom", plan.k, plan.tp)
    return ("dense",)


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    root: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = arr
    return root


def _to_flat_layers(plan: PlanCandidate, tree: dict) -> Dict[str, np.ndarray]:
    """A host tree as flat [L, ...] stacks: the pipelined layout
    {"stages": [S, L/S, ...]} is a reshape of {"layers": [L, ...]}."""
    if plan.pp > 1:
        st = tree["stages"]
        return {k: np.asarray(v).reshape((plan.depth,) + v.shape[2:])
                for k, v in st.items()}
    return {k: np.asarray(v) for k, v in tree["layers"].items()}


def _from_flat_layers(plan: PlanCandidate,
                      flat: Dict[str, np.ndarray]) -> dict:
    if plan.pp > 1:
        S, L_loc = plan.pp, plan.depth // plan.pp
        return {"stages": {k: v.reshape((S, L_loc) + v.shape[1:])
                           for k, v in flat.items()}}
    return {"layers": dict(flat)}


def convert_ffn_params(plan_old: PlanCandidate, plan_new: PlanCandidate,
                       host_params: dict, host_opt: Optional[dict] = None):
    """Convert a GLOBAL host parameter tree (numpy) between plans.

    Same model class: exact (a reshape; dp and pp only re-shard).  A
    class change: each layer's dense equivalent, used as is (-> tensor)
    or re-factored by truncated SVD (-> phantom, the paper's downsize).
    Returns ``(params, opt_or_None, distilled)``; the optimizer tree
    survives the exact path only."""
    if plan_old.width != plan_new.width or plan_old.depth != plan_new.depth:
        raise ValueError("elastic re-plans keep the task fixed: width/"
                         f"depth changed {plan_old.name}->{plan_new.name}")
    flat_p = _to_flat_layers(plan_old, host_params)
    if _plan_class(plan_old) == _plan_class(plan_new):
        new_p = _from_flat_layers(plan_new, flat_p)
        new_opt = None
        if host_opt is not None:
            new_opt = {moment: _from_flat_layers(
                plan_new, _to_flat_layers(plan_old, sub))
                for moment, sub in host_opt.items()}
        return new_p, new_opt, False
    L = plan_old.depth
    n = plan_old.width
    dense: List[Tuple[np.ndarray, np.ndarray]] = []
    for layer in range(L):
        b = (np.asarray(flat_p["b"][layer]) if "b" in flat_p
             else np.zeros(n, np.float32))
        if plan_old.strategy in PHANTOM_KINDS:
            from repro_torch.core.phantom import phantom_dense_equivalent
            W = phantom_dense_equivalent({
                k: torch.from_numpy(np.array(flat_p[k][layer]))
                for k in ("L", "C", "D")}).numpy()
        else:
            W = np.asarray(flat_p["w"][layer])
        dense.append((W, b))
    if plan_new.strategy in PHANTOM_KINDS:
        from repro_torch.core.lowrank import svd_phantom_init
        cols = {k: [] for k in ("L", "C", "D")}
        bs = []
        for W, b in dense:
            fac = svd_phantom_init(W, plan_new.tp, plan_new.k)
            for k in cols:
                cols[k].append(fac[k].numpy().astype(np.float32))
            bs.append(np.asarray(b, np.float32))
        flat_new = {k: np.stack(v) for k, v in cols.items()}
        flat_new["b"] = np.stack(bs)
    else:
        flat_new = {
            "w": np.stack([W for W, _ in dense]).astype(np.float32),
            "b": np.stack([b for _, b in dense]).astype(np.float32)}
    return _from_flat_layers(plan_new, flat_new), None, True


def place_host_tree(host_tree: dict, decls, axes, device):
    """This rank's shards of a GLOBAL host tree (numpy) on ``device``,
    each leaf cut by its decl's spec (``shard_params``: the reference's
    ``device_put`` with each decl's sharding)."""
    from repro_torch.parallel.params import shard_params, tree_map
    local = shard_params(tree_map(torch.from_numpy, host_tree), decls, axes)
    return tree_map(lambda t: t.to(device), local)


# ---------------------------------------------------------------------------
# one phase's ranks
# ---------------------------------------------------------------------------

class _Phase:
    """Bookkeeping for one plan the run executed on."""

    def __init__(self, scored, start_step: int, replayed: int,
                 compile_s: float, restart: bool):
        self.scored = scored
        self.plan = scored.plan
        self.start_step = start_step
        self.steps = 0
        self.replayed = replayed
        self.compile_s = compile_s
        self.restart = restart
        self.ckpt_io_s = 0.0
        self.ckpt_io_bytes = 0.0
        self.wall_s = 0.0

    def close(self, ranks: List[dict]):
        """The phase's measured steps, checkpoint IO and wall time from
        its ranks' results (rank 0's write seconds run to each commit;
        the bytes are every rank's blocks)."""
        r0 = ranks[0]
        self.steps = r0["final_step"] - self.start_step
        self.ckpt_io_s = r0["io"]["io_seconds"]
        self.ckpt_io_bytes = float(sum(r["io"]["io_bytes"] for r in ranks))
        self.wall_s = r0["wall_s"]

    def as_dict(self) -> dict:
        return {"plan": self.plan.name, "strategy": self.plan.strategy,
                "mesh": [self.plan.dp, self.plan.tp, self.plan.pp],
                "k": self.plan.k, "devices": self.plan.devices,
                "start_step": self.start_step, "steps": self.steps,
                "replayed_steps": self.replayed,
                "energy_j_per_iter": self.scored.energy_j_per_iter,
                "compile_s": self.compile_s, "restart": self.restart,
                "ckpt_io_s": self.ckpt_io_s,
                "ckpt_io_bytes": self.ckpt_io_bytes,
                "wall_s": self.wall_s}


def _build_runtime(plan: PlanCandidate, cfg: ElasticConfig, axes, device,
                   params_host=None, opt_host=None) -> dict:
    """The step and this rank's placed state for one plan, the step
    warmed on a throwaway copy of the state (the optimizer updates in
    place), so the build lands in ``compile_s``, not in the first
    resumed step's time or the straggler detector."""
    from repro_torch.core.ffn import init_ffn, local_batch, \
        make_ffn_train_step
    from repro_torch.data.synthetic import TeacherDataset
    from repro_torch.optim import AdamW
    from repro_torch.parallel.params import tree_map

    mcfg = plan.model_config()
    opt = AdamW(cfg.lr, weight_decay=0.0)
    step_fn, decls, opt_decls = make_ffn_train_step(mcfg, axes, opt,
                                                    cfg.batch)
    if params_host is None:
        params, opt_state = init_ffn(mcfg, axes, opt, seed=cfg.seed,
                                     device=device)
    else:
        params = place_host_tree(params_host, decls, axes, device)
        opt_state = (place_host_tree(opt_host, opt_decls, axes, device)
                     if opt_host is not None else opt.init(params))
    ds = TeacherDataset(cfg.width, cfg.batch, seed=cfg.seed, device=device)
    dummy = tree_map(torch.clone, params)
    x, y = ds(0)
    step_fn(dummy, opt.init(dummy), 0, local_batch(x, axes),
            local_batch(y, axes))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"step_fn": step_fn, "decls": decls, "opt_decls": opt_decls,
            "opt": opt, "params": params, "opt_state": opt_state,
            "dataset": ds}


def _slowed(step_fn, delay_s: float, device, *args):
    """``step_fn(*args)``, then ``delay_s`` of sleep once its device work
    is done: the injected anomaly, inside the caller's metered window."""
    out = step_fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    time.sleep(delay_s)
    return out


def _elastic_rank(axes, device, job: dict) -> dict:
    """One rank of a phase: build and warm the plan's step, then train
    the steps ``[job["start"], job["stop"])``, stopping at the target
    loss; checkpoint on the cadence or on rank 0's straggler decision,
    and flush before returning.  Returns the losses, step times, saved
    steps, checkpoint IO and, from rank 0, the straggler detector, the
    watchdog's state and their ledger events."""
    from repro_torch.core.ffn import local_batch
    from repro_torch.telemetry import Ledger

    cfg, plan = job["cfg"], job["plan"]
    tracer, mx = get_tracer(), get_metrics()
    lead = axes.rank == 0
    # the phase's compile runs from the parent's spawn to the warm step
    compile_span = (tracer.begin("elastic/compile", cat="elastic",
                                 plan=plan.name)
                    if lead and tracer.enabled else None)
    if compile_span is not None:
        compile_span.ts_us = (job["t_spawn"] - tracer.origin) * 1e6
    rt = _build_runtime(plan, cfg, axes, device, job["params_host"],
                        job["opt_host"])
    if compile_span is not None:
        tracer.end(compile_span)
    ready = time.perf_counter()
    mgr = CheckpointManager(job["ckpt_dir"], keep=cfg.keep_checkpoints,
                            axes=axes)
    meter = StepMeter(f"elastic_ffn{cfg.width}", warmup=0, device=device)
    detector, policy = job["detector"], job["policy"]
    ledger = Ledger(run="elastic_rank0")
    wd, step_clock = job["watchdog"], job["step_clock"]
    if wd is not None:
        wd.rank = axes.rank
        wd.ledger = ledger if lead else None
    params, opt_state = rt["params"], rt["opt_state"]
    losses, saved = [], []
    step, reached = job["start"], False
    try:
        while step < job["stop"]:
            x, y = rt["dataset"](step)
            step_fn, injected = rt["step_fn"], 0.0
            if step in cfg.slow_steps:
                base = wd.reference_s() if lead and wd is not None \
                    else None
                if lead and not base:
                    base = meter.median_us() * 1e-6 or 0.02
                injected = rank0_value(base or 0.0, axes, device) * max(
                    cfg.slow_factor - 1.0, 0.0)
                step_fn = functools.partial(_slowed, step_fn, injected,
                                            device)
            run_metered = functools.partial(
                meter.call, step_fn, params, opt_state, step,
                local_batch(x, axes), local_batch(y, axes))
            with tracer.span("elastic/step", cat="train", step=step,
                             plan=plan.name,
                             replay=step < job["replay_until"]):
                if wd is not None and wd.capture_pending():
                    params, opt_state, loss = wd.capture(run_metered)
                else:
                    params, opt_state, loss = run_metered()
            losses.append(float(loss))
            step += 1
            dt_s = step_clock(step - 1, meter.times_us[-1] / 1e6, injected)
            mx.counter("train_steps_total",
                       "executed training steps").inc(suite="elastic")
            mx.histogram("train_step_seconds",
                         "metered train step wall seconds").observe(
                             dt_s, suite="elastic")
            mx.gauge("train_loss", "last observed training loss").set(
                losses[-1], suite="elastic")
            if wd is not None:
                if lead:
                    # step already advanced: the anomaly row must name
                    # the step that actually ran
                    wd.observe(step - 1, dt_s)
                if wd.profile_dir:
                    wd.set_capture_pending(rank0_value(
                        wd.capture_pending(), axes, device))
            decision = None
            if lead:
                decision = note_step_time(
                    detector, policy, step, dt_s, ledger,
                    name="elastic_straggler", arch=f"ffn{cfg.width}",
                    impl=plan.strategy, p=plan.tp)
            if rank0_decision(decision, axes, device) == "checkpoint" \
                    or step % cfg.checkpoint_every == 0:
                mgr.save_async(step, params, opt_state,
                               meta={"plan": plan.as_dict()},
                               decls=rt["decls"], opt_decls=rt["opt_decls"])
                saved.append(step)
            if losses[-1] <= cfg.target_loss:
                reached = True
                break
    finally:
        mgr.flush(raise_errors=False)
    mgr.flush()
    out = {"rank": axes.rank, "losses": losses, "final_step": step,
           "reached": reached, "saved": saved, "io": mgr.io_stats(),
           "ready": ready, "wall_s": time.perf_counter() - ready,
           "step_us": meter.times_us}
    if lead:
        if wd is not None:
            wd.ledger = None
        out.update(detector=detector, events=ledger.entries, watchdog=wd)
    return out


# ---------------------------------------------------------------------------
# the failure loop
# ---------------------------------------------------------------------------

def _play_ahead(cluster, fault_script, fired: set, handled: set, step: int,
                cfg: ElasticConfig):
    """The cluster's events from ``step`` on, in the reference's order a
    step (the scripted kills, ``advance``, ``tick``, ``check``), up to
    the step at which the monitor sees a newly dead host (or
    ``max_steps``).  Returns ``(stop, new_dead, kills)``."""
    kills = []
    while step < cfg.max_steps:
        for host in fault_script.hosts_at(step):
            if (step, host) in fired:
                continue    # a rewind replays the step; the host is dead
            fired.add((step, host))
            cluster.kill(host)
            kills.append((step, host))
        cluster.advance(cfg.virtual_dt)
        cluster.tick(step)
        new_dead = [h for h in cluster.check() if h not in handled]
        if new_dead:
            return step, new_dead, kills
        step += 1
    return step, [], kills


def run_elastic(cfg: ElasticConfig, *, ledger=None,
                fault_script: Optional[FaultScript] = None,
                calibration=None, watchdog=None, log_fn=print,
                device=None, rank_fn=_elastic_rank,
                step_clock=metered_seconds) -> ElasticResult:
    """Train to ``cfg.target_loss`` through scripted host losses, each
    phase's ranks on ``device`` (the card unless the caller asks for the
    CPU).  Detection -> policy -> re-plan -> restore / convert ->
    resume; ``ElasticResult.account`` is the priced recovery account
    (also recorded in ``ledger``, kind ``elastic``).  ``watchdog`` (an
    ``EnergyDriftWatchdog``) watches every phase's steps;
    ``step_clock(step, metered_s, injected_s)`` gives a step's seconds
    (picklable: it reaches the ranks).  ``rank_fn`` is the phase's rank
    body (a test substitutes a wrapper of ``_elastic_rank``)."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.parallel.axes import resolve_device
    from repro_torch.planner.calibration import calibrate_from_ledger

    os.makedirs(cfg.workdir, exist_ok=True)
    if cfg.devices % cfg.hosts:
        raise ValueError(f"{cfg.devices} devices do not divide over "
                         f"{cfg.hosts} hosts")
    dev = resolve_device(device)
    devices_per_host = cfg.devices // cfg.hosts
    calib = calibration or calibrate_from_ledger()
    cluster = SimulatedCluster(os.path.join(cfg.workdir, "hb"),
                               hosts=cfg.hosts,
                               timeout_s=cfg.heartbeat_timeout_s,
                               virtual=True)
    ckpt_dir = os.path.join(cfg.workdir, "ckpt")
    mgr = CheckpointManager(ckpt_dir, keep=cfg.keep_checkpoints)
    policy = RestartPolicy(max_restarts=cfg.max_restarts)
    detector = StragglerDetector(window=cfg.straggler_window,
                                 threshold=cfg.straggler_threshold)
    meter = StepMeter(f"elastic_ffn{cfg.width}", warmup=1, device="cpu")
    fault_script = fault_script or FaultScript()
    tracer = get_tracer()
    metrics = get_metrics()

    run_span = tracer.begin("elastic/run", cat="elastic",
                            devices=cfg.devices, width=cfg.width)
    with tracer.span("elastic/plan", cat="elastic",
                     devices=cfg.devices) as sp:
        scored, _ = solve_plan(
            cfg.devices, cfg, calib,
            strategies=((cfg.initial_strategy,) if cfg.initial_strategy
                        else None))
        sp.annotate(plan=scored.plan.name)
    log_fn(f"[elastic] initial plan {scored.plan.name} "
           f"({scored.plan.devices} devices)")
    phases: List[_Phase] = []
    recoveries: List[dict] = []
    handled_dead: set = set()
    fired: set = set()
    step = 0
    loss = float("nan")
    losses: List[float] = []
    reached = aborted = False
    replay_until = 0               # steps below this re-run lost work
    nxt = dict(scored=scored, replayed=0, restart=False, params_host=None,
               opt_host=None)
    while True:
        start = step
        stop, new_dead, kills = _play_ahead(cluster, fault_script, fired,
                                            handled_dead, step, cfg)
        plan = nxt["scored"].plan
        t_spawn = time.perf_counter()
        ranks = spawn(rank_fn, plan.dp, plan.tp, dev, pp=plan.pp,
                      timeout_s=PHASE_TIMEOUT_S, args=(dict(
                          cfg=cfg, plan=plan, start=start, stop=stop,
                          params_host=nxt["params_host"],
                          opt_host=nxt["opt_host"], ckpt_dir=ckpt_dir,
                          detector=detector, policy=policy,
                          t_spawn=t_spawn, replay_until=replay_until,
                          watchdog=(None if watchdog is None else
                                    dataclasses.replace(watchdog,
                                                        ledger=None)),
                          step_clock=step_clock),))
        r0 = ranks[0]
        phase = _Phase(nxt["scored"], start, nxt["replayed"],
                       r0["ready"] - t_spawn, nxt["restart"])
        phase.close(ranks)
        phases.append(phase)
        detector = r0["detector"]
        if watchdog is not None:
            for f in dataclasses.fields(watchdog):
                if f.name != "ledger":
                    setattr(watchdog, f.name, getattr(r0["watchdog"],
                                                      f.name))
        for event in r0["events"]:
            if ledger is not None:
                ledger.record(event)
        losses += r0["losses"]
        meter.times_us += r0["step_us"]
        step = r0["final_step"]
        if r0["losses"]:
            loss = r0["losses"][-1]
        for s, host in kills:
            if s < step or (s == stop and not r0["reached"]):
                log_fn(f"[elastic] step {s}: host {host} lost")
        if r0["reached"]:
            reached = True
            break
        if not new_dead:
            break                       # max_steps
        handled_dead.update(new_dead)
        tracer.instant("elastic/detect", cat="elastic", step=step,
                       dead_hosts=sorted(new_dead))
        metrics.counter(
            "elastic_host_failures_total",
            "hosts declared dead by the heartbeat monitor").inc(
                len(new_dead))
        decision = policy.on_host_failure(new_dead, None)
        survivors = cfg.hosts - len(handled_dead)
        alive = devices_per_host * survivors
        if decision == "abort" or alive < 1:
            log_fn(f"[elastic] step {step}: "
                   f"{decision if alive else 'no survivors'}"
                   f" ({len(handled_dead)}/{cfg.hosts} hosts dead)")
            aborted = True
            break
        with tracer.span("elastic/replan", cat="elastic",
                         alive_devices=alive) as sp:
            t_replan = time.perf_counter()
            new_scored, _ = solve_plan(alive, cfg, calib)
            replan_s = time.perf_counter() - t_replan
            sp.annotate(plan=new_scored.plan.name)
        with tracer.span("elastic/restore", cat="elastic") as sp:
            t_restore = time.perf_counter()
            latest = mgr.latest_step()
            params_host = opt_host = None
            distilled = False
            restored_step = 0
            if latest is not None:
                index, flat = mgr.load_host(latest)
                restored_step = int(index["step"])
                nested = _nest(flat)
                meta_plan = index.get("meta", {}).get("plan")
                plan_old = (plan_from_dict(meta_plan) if meta_plan
                            else phases[-1].plan)
                params_host, opt_host, distilled = convert_ffn_params(
                    plan_old, new_scored.plan, nested.get("params", {}),
                    nested.get("opt") or None)
                mgr.invalidate_after(restored_step)
            restore_s = time.perf_counter() - t_restore
            sp.annotate(distilled=distilled, restored_step=restored_step)
        replayed = max(step - restored_step, 0)
        recoveries.append({
            "detect_step": step, "restored_step": restored_step,
            "dead_hosts": sorted(handled_dead),
            "devices_before": plan.devices,
            "devices_after": new_scored.plan.devices,
            "plan_before": plan.name,
            "plan_after": new_scored.plan.name,
            "replayed_steps": replayed, "distilled": distilled,
            "from_scratch": latest is None,
            "restore_s": restore_s, "replan_s": replan_s,
            "decision": decision,
            "audit_ok": bool(new_scored.notes.get("audit_ok",
                                                  not cfg.audit_replan)),
        })
        log_fn(f"[elastic] step {step}: re-planned onto "
               f"{new_scored.plan.name} ({new_scored.plan.devices} of "
               f"{alive} surviving devices), restored "
               f"step {restored_step}"
               + (" [distilled]" if distilled else "")
               + f", replaying {replayed} step(s)")
        metrics.counter(
            "elastic_recoveries_total",
            "elastic re-plan/restore/resume cycles").inc(
                distilled=str(distilled).lower())
        nxt = dict(scored=new_scored, replayed=replayed, restart=True,
                   params_host=params_host, opt_host=opt_host)
        replay_until = step
        step = restored_step

    phase_dicts = [p.as_dict() for p in phases]
    account = recovery_account(phase_dicts, recoveries)
    account["target_loss"] = cfg.target_loss
    account["reached_target"] = reached
    result = ElasticResult(
        reached_target=reached, aborted=aborted, final_loss=loss,
        final_step=step, phases=phase_dicts, recoveries=recoveries,
        account=account, plan_names=[p.plan.name for p in phases],
        losses=losses)
    entry = None
    if ledger is not None:
        last = phases[-1].plan
        entry = ledger.record(LedgerEntry(
            name=f"elastic_ffn{cfg.width}", suite="elastic",
            kind="elastic", arch=f"ffn{cfg.width}x{cfg.depth}",
            impl=last.strategy, p=last.tp,
            measured=dict(meter.summary(), final_loss=loss,
                          steps=step, wall_s=account["wall_s"]),
            predicted={"energy_j_total": account["energy_j_total"],
                       "energy_j_useful": account["energy_j_useful"],
                       "energy_j_replay": account["energy_j_replay"]},
            extra={"recovery": account, "phases": phase_dicts,
                   "recoveries": recoveries,
                   "plans": [p.plan.name for p in phases],
                   "reached_target": reached, "aborted": aborted,
                   "target_loss": cfg.target_loss,
                   "straggler_flags": len(detector.flagged)}))
        ledger.flush()
    if entry is not None:
        run_span.link_ledger(entry)
    run_span.annotate(final_step=step, reached_target=reached,
                      recoveries=len(recoveries))
    tracer.end(run_span)
    log_fn(f"[elastic] done: step {step} loss {loss:.4f} "
           f"target {'REACHED' if reached else 'missed'}, "
           f"{len(recoveries)} recovery(ies), replay ratio "
           f"{account['replay_overhead_ratio']:.3f}")
    return result
