"""Training step builder and training loop for the LM families: the
port's counterpart of the reference's ``train/trainer.py``, on any
pp x dp x tp mesh of ranks.

``make_train_step`` builds one rank's step: forward and backward
(``models/model.py: forward_train``, gradient accumulation over
microbatches; at pp > 1 ``forward_train_pipeline``, the 1F1B pipeline
over the microbatches), the spec-aware gradient sums
(``parallel/grads.py``), the global gradient norm, clipping and the
optimizer, as the reference's ``shard_map``'d step does with explicit
collectives.

Memory.  The reference donates parameters and optimizer state, so XLA
updates them in place; here the optimizer updates them in place
(``optim/optimizers.py``).  The gradients go into one buffer per
parameter, allocated once a step: each layer's slice of a stacked
parameter is a leaf of its own whose ``.grad`` is the same slice of the
buffer, so autograd adds each layer's gradient into it in place.
Differentiating the stacked tensor instead would scatter every layer's
gradient into a zero tensor of the whole stack.

``Trainer`` is the loop around the step: data, a ``StepMeter`` on every
step, the ``[trainer]`` log line, ``record_to(ledger)``, which records
the metered steps as a ledger entry, asynchronous checkpoints every
``checkpoint_every`` steps (``train/checkpoint.py``: each rank writes
its own blocks of the global arrays) and ``restore_or_init``, and the
straggler hook (``train/fault.py: note_step_time``) whose checkpoint-now
decision rank 0 takes for every rank.  The reference's observability:
the ``train/run`` span and a ``train/step`` span a step, the
``train_steps_total``, ``train_step_seconds`` and ``train_loss``
metrics, and the energy-drift watchdog (``obs/watchdog.py``), which
rank 0 feeds and whose armed profiler capture every rank takes on the
next step (``rank0_value``).  A step's seconds, for the metrics, the
watchdog and the straggler hook, come from ``step_clock`` (default
``metered_seconds``: the ``StepMeter``'s time); a test injects a
virtual one.

``pilot_ffn_run`` is the planner's quality measurement
(``planner/isoloss.py``): one rank's share of a small paper-FFN run on
the Gaussian-teacher data, its loss trajectory and the first step at the
target loss.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (STACKS, forward_train,
                                      forward_train_pipeline, model_decls)
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.parallel.axes import MeshAxes, resolve_device
from repro_torch.parallel.grads import _spec_axes, reduce_grads
from repro_torch.parallel.params import (materialize_shards_in_turn,
                                         tree_leaves, tree_map)
from repro_torch.telemetry import LedgerEntry, StepMeter
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import note_step_time
from repro_torch.train.pipeline import batch_axis, split_batch_microbatches

AUX_LOSS_WEIGHT = 0.01
NORM_CHUNK = 1 << 28   # a larger leaf's sum of squares goes in chunks


def _global_norm(grads, decls, axes: MeshAxes):
    """The global gradient norm: each leaf's sum of squares weighted so
    that every element counts once over the ranks that hold it, summed
    over all ranks.  A leaf of more than ``NORM_CHUNK`` elements is
    summed in chunks, so that its float32 copy stays a chunk."""
    dflat = dict(tree_leaves(decls))
    total = None
    for path, g in tree_leaves(grads):
        ax = _spec_axes(dflat[path].spec)
        repl = 1
        for name, size in (("dp", axes.dp), ("tp", axes.tp),
                           ("pp", axes.pp)):
            if name not in ax:
                repl *= size
        sq = None
        for part in g.reshape(-1).split(NORM_CHUNK):
            gf = part.float()
            d = torch.dot(gf, gf)
            sq = d if sq is None else sq + d
        sq = sq / repl
        total = sq if total is None else total + sq
    return torch.sqrt(axes.world_comm.all_reduce(total))


def local_rows(batch, axes: MeshAxes):
    """This rank's rows of a global batch, each leaf cut on its batch
    axis (``train/pipeline.py: batch_axis``; the reference's input specs
    shard ``positions`` as ``P(None, "dp", None)``, every other leaf on
    its first dim)."""
    def cut(key, x):
        if isinstance(x, dict):
            return {k: cut(k, v) for k, v in x.items()}
        b = x.shape[batch_axis(key)] // axes.dp
        return x.narrow(batch_axis(key), axes.dp_rank * b, b)
    return cut(None, batch)


def _grad_leaves(params, grads, pp: int = 1):
    """A tree like ``params`` whose leaves are fresh autograd leaves over
    the same storage, each with ``.grad`` preset to its part of
    ``grads``; each stack of layers (``models/model.py: STACKS``)
    becomes a list of per-layer trees (at ``pp`` > 1 the layers of the
    stage's local ``[1, G/pp, ...]`` stack)."""
    def leaf(t, g):
        x = t.detach().requires_grad_(True)
        x.grad = g
        return x

    def zip_map(fn, a, b):
        if isinstance(a, dict):
            return {k: zip_map(fn, a[k], b[k]) for k in a}
        return fn(a, b)

    out = {k: zip_map(leaf, params[k], grads[k]) for k in params
           if k not in STACKS}
    for key in STACKS:
        if key not in params:
            continue
        layers_p, layers_g = params[key], grads[key]
        if pp > 1:
            layers_p, layers_g = (tree_map(lambda t: t[0], x)
                                  for x in (layers_p, layers_g))
        n = tree_leaves(layers_p)[0][1].shape[0]
        out[key] = [zip_map(lambda t, g, i=i: leaf(t[i], g[i]),
                            layers_p, layers_g)
                    for i in range(n)]
    return out


def make_train_step(cfg: ModelConfig, axes: MeshAxes, optimizer, *,
                    microbatches: int = 1, grad_clip: float = 1.0,
                    device=None):
    """Returns (step_fn, decls, opt_decls), called inside a rank.

    step_fn(params, opt_state, step, batch) -> (params, opt_state,
    {"loss", "grad_norm"}) on this rank's parameters and its rows of the
    batch ({"tokens", "labels"} [B/dp, S], moved to ``device``, the card
    unless the caller asks for the CPU).  The objective is the
    reference's: the rank's summed token loss over the valid tokens of
    all dp ranks, divided by tp; ``loss`` is the cross-entropy summed
    over dp over the same count.  With ``microbatches`` > 1 the
    gradients (and the reported loss) are the mean over the microbatches
    of the batch rows, each normalised by its own token count.  At
    pp > 1 the step is the reference's pipelined one instead: the
    ``microbatches`` feed the 1F1B schedule, and each one's summed token
    loss is divided by the global count of valid tokens over all of
    them and all dp ranks (the objective of ``microbatches`` = 1).  The
    parameters and the optimizer state are updated in place."""
    dev = resolve_device(device)
    decls = model_decls(cfg, axes)
    opt_decls = optimizer.state_decls(decls)
    M = max(microbatches, 1)
    pipelined = axes.pp > 1

    def loss_fn(p, batch):
        sum_loss, n_valid, aux = forward_train(cfg, axes, p, batch)
        nv_g = axes.dp_comm.all_reduce(n_valid).float().clamp_min(1.0)
        obj = (sum_loss / nv_g + AUX_LOSS_WEIGHT * aux / axes.dp) / axes.tp
        ce = axes.dp_comm.all_reduce(sum_loss) / nv_g
        return obj, ce

    def pipeline_loss(p, batch):
        """The reference's ``loss_fn_pipeline``, forward and backward;
        returns the reported cross-entropy.  The valid tokens (every
        token is valid) are counted from the labels before the schedule
        starts.  Each stage's MoE balance loss, summed over the M
        microbatches, enters divided by dp x M, as in the reference."""
        n_valid = torch.tensor(batch["labels"].numel(), device=dev)
        nv_g = axes.dp_comm.all_reduce(n_valid).float().clamp_min(1.0)
        sum_loss, _ = forward_train_pipeline(
            cfg, axes, p, batch, M, lambda sl: sl / nv_g / axes.tp,
            aux_weight=AUX_LOSS_WEIGHT / (axes.dp * M * axes.tp))
        return axes.pp_comm.all_reduce(
            axes.dp_comm.all_reduce(sum_loss)) / nv_g

    def step_fn(params, opt_state, step, batch):
        batch = tree_map(lambda x: x.to(dev), batch)
        grads = tree_map(torch.zeros_like, params)
        leaves = _grad_leaves(params, grads, axes.pp)
        if pipelined:
            ce = pipeline_loss(leaves, batch)
        elif M == 1:
            obj, ce = loss_fn(leaves, batch)
            obj.backward()
        else:
            mb = split_batch_microbatches(batch, M)
            ce = 0.0
            for i in range(M):
                obj, ce_i = loss_fn(leaves, tree_map(lambda x: x[i], mb))
                obj.backward()
                ce = ce + ce_i
            for _, g in tree_leaves(grads):
                g.div_(M)
            ce = ce / M
        del leaves
        grads = reduce_grads(grads, decls, axes)
        gnorm = _global_norm(grads, decls, axes)
        if grad_clip > 0:
            scale = torch.clamp(grad_clip / gnorm.clamp_min(1e-9), max=1.0)
            for _, g in tree_leaves(grads):
                g.mul_(scale)
        params, opt_state = optimizer.update(grads, opt_state, params,
                                             int(step))
        return params, opt_state, {"loss": ce, "grad_norm": gnorm}

    return step_fn, decls, opt_decls


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def rank0_value(value: float, axes: MeshAxes, device) -> float:
    """Rank 0's ``value`` on every rank, over an unrecorded group (host
    bookkeeping: the step's wire count does not move).  Each rank times
    its own steps, so what rank 0 decides from its times (a straggler's
    checkpoint, the watchdog's armed capture, the slow step's delay)
    crosses the world this way."""
    world = axes.world_comm
    if world.size == 1:
        return float(value)
    t = torch.tensor([float(value) if axes.rank == 0 else 0.0],
                     dtype=torch.float64, device=device)
    return float(world.unrecorded().all_reduce(t).item())


def rank0_decision(decision: Optional[str], axes: MeshAxes,
                   device) -> Optional[str]:
    """Rank 0's straggler decision on every rank: ``"checkpoint"`` if
    rank 0 decided so, else None; a save must be taken by all ranks or
    none."""
    flag = rank0_value(decision == "checkpoint", axes, device)
    return "checkpoint" if flag > 0 else None


def metered_seconds(step: int, metered_s: float, injected_s: float) -> float:
    """The default step clock: a step's seconds are the ``StepMeter``'s,
    which hold any delay injected into the step (``injected_s``)."""
    return metered_s


@dataclass
class TrainState:
    params: object
    opt_state: object
    step: int


class Trainer:
    """The training loop of one rank: data, step, meter, log, ledger,
    checkpoints, the straggler hook and the energy-drift watchdog
    (``watchdog``: each rank its own, named for its rank's capture;
    rank 0's observes).  ``step_clock(step, metered_s, injected_s)``
    gives a step's seconds (default ``metered_seconds``)."""

    def __init__(self, cfg: ModelConfig, axes: MeshAxes, optimizer,
                 dataset, *, microbatches: int = 1, grad_clip: float = 1.0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 100, keep_checkpoints: int = 3,
                 log_every: int = 10, log_fn: Callable = print,
                 meter: Optional[StepMeter] = None, ledger=None,
                 straggler=None, restart_policy=None, watchdog=None,
                 step_clock: Callable = metered_seconds, device=None):
        self.cfg, self.axes, self.optimizer = cfg, axes, optimizer
        self.dataset = dataset
        self.log_every, self.log_fn = log_every, log_fn
        self.device = resolve_device(device)
        self.meter = meter or StepMeter(f"train_{cfg.name}", warmup=1,
                                        device=self.device)
        self.ledger = ledger
        self.straggler = straggler            # StragglerDetector | None
        self.restart_policy = restart_policy  # RestartPolicy | None
        self.watchdog = watchdog              # EnergyDriftWatchdog | None
        if watchdog is not None:
            watchdog.rank = axes.rank
        self.step_clock = step_clock
        self.checkpoint_every = checkpoint_every
        self.history: list = []      # {"loss", "grad_norm"} of every step
        self._ledger_window = 0
        self.step_fn, self.decls, self.opt_decls = make_train_step(
            cfg, axes, optimizer, microbatches=microbatches,
            grad_clip=grad_clip, device=self.device)
        self.checkpoints = (CheckpointManager(checkpoint_dir,
                                              keep=keep_checkpoints,
                                              axes=axes)
                            if checkpoint_dir else None)

    def init_state(self, seed: int = 0) -> TrainState:
        """This rank's shards of random global parameters, drawn leaf by
        leaf on the trainer's device from a generator seeded ``seed`` on
        every rank (a host draw of phi3-mini's 15 GB would add minutes to
        every run): the same global weights at any pp x tp on one card
        type (a pipe-sharded stack draws the values of the unsharded
        one), one global leaf at a time beside the shards.  Ranks that
        share a card (gloo through the host) draw in turn, each returning
        the global leaf's memory to the card before the next starts:
        otherwise each would hold a global leaf at once (jamba's expert
        leaf is 6.4 GB in bf16).  The optimizer's zero state."""
        params = materialize_shards_in_turn(self.decls, self.axes, seed,
                                            self.device)
        return TrainState(params, self.optimizer.init(params), 0)

    def restore_or_init(self, seed: int = 0) -> TrainState:
        """This rank's state from the latest readable checkpoint in
        ``checkpoint_dir``, cut for its mesh; else ``init_state``."""
        if self.checkpoints is not None:
            restored = self.checkpoints.restore_latest(
                self.decls, self.opt_decls, self.axes, self.device)
            if restored is not None:
                self.log_fn(f"[trainer] restored step {restored.step}")
                return restored
        return self.init_state(seed)

    def save_async(self, state: TrainState):
        """Queue a checkpoint of ``state`` (copied to the host now)."""
        self.checkpoints.save_async(
            state.step, state.params, state.opt_state, decls=self.decls,
            opt_decls=self.opt_decls,
            per_rank=self.optimizer.per_rank_state)

    def run(self, state: TrainState, num_steps: int) -> TrainState:
        """Steps from ``state.step`` up to ``num_steps``; a checkpoint
        every ``checkpoint_every`` steps or on the restart policy's
        ``"checkpoint"`` decision, every queued save flushed on the way
        out, a failed step's too."""
        params, opt_state, step = state.params, state.opt_state, state.step
        impl = "phantom" if self.cfg.uses_phantom_sites() else "dense"
        wd = self.watchdog
        tracer = get_tracer()
        mx = get_metrics()
        steps_c = mx.counter("train_steps_total",
                             "executed training steps")
        step_h = mx.histogram("train_step_seconds",
                              "metered train step wall seconds")
        loss_g = mx.gauge("train_loss", "last observed training loss")
        run_span = tracer.begin("train/run", cat="train",
                                arch=self.cfg.name, impl=impl,
                                start_step=step, num_steps=num_steps)
        window = []
        try:
            while step < num_steps:
                batch = local_rows(self.dataset(step), self.axes)
                with tracer.span("train/step", cat="train", step=step,
                                 arch=self.cfg.name):
                    if wd is not None and wd.capture_pending():
                        params, opt_state, metrics = wd.capture(
                            self.meter.call, self.step_fn, params,
                            opt_state, step, batch)
                    else:
                        params, opt_state, metrics = self.meter.call(
                            self.step_fn, params, opt_state, step, batch)
                step += 1
                m = {k: float(v) for k, v in metrics.items()}
                self.history.append(m)
                window.append(m)
                dt_s = self.step_clock(
                    step - 1, self.meter.times_us[-1] * 1e-6, 0.0)
                steps_c.inc(suite="trainer")
                step_h.observe(dt_s, suite="trainer")
                loss_g.set(m["loss"], suite="trainer")
                if wd is not None:
                    if self.axes.rank == 0:
                        # step already advanced: name the step that ran
                        wd.observe(step - 1, dt_s)
                    if wd.profile_dir:
                        wd.set_capture_pending(rank0_value(
                            wd.capture_pending(), self.axes, self.device))
                decision = note_step_time(
                    self.straggler, self.restart_policy, step, dt_s,
                    self.ledger, name=f"straggler_{self.cfg.name}",
                    arch=self.cfg.name, impl=impl, p=self.axes.tp)
                if self.straggler is not None:
                    decision = rank0_decision(decision, self.axes,
                                              self.device)
                if step % self.log_every == 0:
                    recent = self.meter.times_us[-self.log_every:]
                    dt_ms = sum(recent) / len(recent) / 1e3
                    loss = sum(w["loss"] for w in window) / len(window)
                    gnorm = sum(w["grad_norm"] for w in window) / len(
                        window)
                    self.log_fn(f"[trainer] step {step} loss {loss:.4f} "
                                f"gnorm {gnorm:.3f} {dt_ms:.0f} ms/it")
                    window = []
                if self.checkpoints is not None and (
                        step % self.checkpoint_every == 0
                        or decision == "checkpoint"):
                    self.save_async(TrainState(params, opt_state, step))
        finally:
            # a failed step must not abandon a queued save; the error in
            # flight takes precedence over the writer's
            if self.checkpoints is not None:
                self.checkpoints.flush(raise_errors=False)
            if self.ledger is not None:
                self.ledger.flush()
        if self.checkpoints is not None:
            self.checkpoints.flush()
        if self.ledger is not None:
            # link BEFORE end(): the event dict is copied at end time
            run_span.link_ledger(self.record_to(self.ledger))
        tracer.end(run_span.annotate(final_step=step))
        return TrainState(params, opt_state, step)

    def record_to(self, ledger, predicted=None, name=None,
                  measured_extra=None) -> LedgerEntry:
        """Record this trainer's metered steps in ``ledger`` and reset the
        meter, so repeated ``run()`` calls record disjoint windows."""
        measured = self.meter.summary()
        if measured_extra:
            measured.update(measured_extra)
        impl = "phantom" if self.cfg.uses_phantom_sites() else "dense"
        entry = ledger.record(LedgerEntry(
            name=name or f"train_{self.cfg.name}", suite="trainer",
            kind="train", arch=self.cfg.name, impl=impl, p=self.axes.tp,
            measured=measured, predicted=predicted,
            extra={"window": self._ledger_window, "pp": self.axes.pp,
                   "dp": self.axes.dp}))
        self.meter.reset(warm=True)
        self._ledger_window += 1
        return entry


# ---------------------------------------------------------------------------
# pilot runs (the planner's iso-loss measurements)
# ---------------------------------------------------------------------------

@dataclass
class PilotResult:
    """One small training run the planner fits loss curves from."""
    name: str
    strategy: str                  # projection kind at the planned site
    width: int
    tp: int
    k: int
    steps_run: int
    final_loss: float
    losses: List[float]            # per-step loss trajectory
    target_loss: Optional[float] = None
    iters_to_target: Optional[int] = None   # None = censored (never hit)
    wall_us_median: float = 0.0

    def as_dict(self) -> dict:
        return {"name": self.name, "strategy": self.strategy,
                "width": self.width, "tp": self.tp, "k": self.k,
                "steps_run": self.steps_run, "final_loss": self.final_loss,
                "target_loss": self.target_loss,
                "iters_to_target": self.iters_to_target,
                "wall_us_median": self.wall_us_median}


def pilot_ffn_run(cfg: ModelConfig, axes: MeshAxes, device, *, steps: int,
                  batch: int, target_loss: Optional[float] = None,
                  lr: float = 3e-3, seed: int = 0,
                  stop_at_target: bool = False):
    """One rank's pilot: train the paper FFN ``cfg`` on the
    Gaussian-teacher data (AdamW at ``lr``, weight decay 0, weights and
    teacher from ``seed``) and record the loss trajectory.

    Runs ``steps`` iterations, recording the FIRST step whose global loss
    is at or below ``target_loss`` (the measured ν the iso-loss frontier
    prices plans with) while continuing to the full budget, so the final
    loss is comparable across pilots (``stop_at_target=True`` stops
    there, when only ν is wanted).  Every step is metered (``StepMeter``,
    warm-up 1).  Returns ``(PilotResult, meter summary)``, the same on
    every rank but the times; the caller records the ledger row."""
    from repro_torch.core.ffn import (ffn_strategy, init_ffn, local_batch,
                                      make_ffn_train_step)
    from repro_torch.data.synthetic import TeacherDataset
    from repro_torch.optim import AdamW

    device = resolve_device(device)
    st = ffn_strategy(cfg, axes.tp)
    opt = AdamW(lr, weight_decay=0.0)
    step_fn, _, _ = make_ffn_train_step(cfg, axes, opt, batch)
    params, opt_state = init_ffn(cfg, axes, opt, seed, device)
    ds = TeacherDataset(cfg.ffn_width, batch, seed, device)
    meter = StepMeter(f"pilot_{cfg.name}", warmup=1, device=device)

    losses: List[float] = []
    iters_to_target = None
    pilot_span = get_tracer().begin(
        "plan/pilot", cat="plan", arch=cfg.name, strategy=st.kind,
        width=cfg.ffn_width, tp=axes.tp, k=getattr(st, "k", 0))
    for s in range(steps):
        x, y = ds(s)
        params, opt_state, loss = meter.call(
            step_fn, params, opt_state, s, local_batch(x, axes),
            local_batch(y, axes))
        losses.append(float(loss))
        if target_loss is not None and iters_to_target is None \
                and losses[-1] <= target_loss:
            iters_to_target = s + 1
            if stop_at_target:
                break
    get_metrics().counter("plan_pilot_steps_total",
                          "training steps spent in planner pilots").inc(
                              len(losses), arch=cfg.name)
    res = PilotResult(
        name=f"pilot_{cfg.name}", strategy=st.kind, width=cfg.ffn_width,
        tp=axes.tp, k=getattr(st, "k", 0), steps_run=len(losses),
        final_loss=losses[-1] if losses else float("nan"), losses=losses,
        target_loss=target_loss, iters_to_target=iters_to_target,
        wall_us_median=meter.median_us())
    get_tracer().end(pilot_span.annotate(
        steps_run=res.steps_run, final_loss=res.final_loss,
        iters_to_target=iters_to_target))
    return res, meter.summary()
