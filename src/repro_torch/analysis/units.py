"""Audit units: one executed entry point and its predicted account.

The reference's unit is one jitted entry point lowered WITHOUT running
it: its optimized HLO, ``cost_analysis()`` and ``memory_analysis()``, and
its closed jaxpr.  PyTorch compiles nothing, so the port's unit is one
step of the entry point RUN on the ranks of its mesh, counted while it
runs:

  * ``logs`` (for the reference's ``hlo_text``): each rank's
    ``parallel/axes.py: record_collectives`` log of the step, the
    collectives its ``Group``s issued; ``measured_buckets`` is their mean
    per rank (the ranks of a pipeline's stages issue different sends);
  * ``costs`` (a ``telemetry/counted.py: MeasuredCosts``, for the
    reference's ``CompiledCosts``): rank 0's flops through
    ``FlopCounterMode`` and its collectives; ``costs.memory`` holds the
    largest rank's ``argument_bytes`` (the step's parameters and inputs)
    and ``step_bytes`` (on the card the growth of
    ``torch.cuda.max_memory_allocated`` over the step, after a warm-up
    step has allocated the libraries' workspaces; on the CPU the peak of
    the live bytes a dispatch mode tracks, ``LiveBytes``);
  * ``upcasts`` (for the reference's ``jaxpr``): the bf16 -> float32
    casts a dispatch mode saw during the step (``StepMode``), or None
    when nothing was recorded.

The predicted account, the mesh sizes, the static args and the
tolerances are the reference's.  Builders carry the reference's names,
sizes and predictions:

  * ``ffn_train_unit`` (the paper-FFN fwd+bwd probe step);
  * ``kernel_unit`` (the same with ``kernel_backend="pallas"``: on the
    card the hand-written phantom kernels, their launches and the
    shared memory of the plans they took in ``meta``);
  * ``pipeline_unit`` (the 1F1B pipelined probe step);
  * ``serve_units`` (one prefill and one decode of the serving engine);
  * ``plan_unit`` (one planner candidate);
  * ``build_default_units`` (the ``audit --all`` set).

Each runs one step on ranks of its mesh: a ``RankPool`` of the mesh's
size when the caller passes one, else new ranks (``launch/mesh.py``),
on ``device``, the card unless the caller asks for the CPU.

One account differs from the reference's on purpose: the pipeline's.
The reference's SPMD wavefront computes in the bubbles and permutes at
every tick (``pipeline_ffn_step_events(executed=True)``); the port's
1F1B idles in them (``executed=False``), and each stage sends only to
the neighbours it has, so the per-rank mean of its permutes is
``(S - 1) / S`` of that account's ``2M`` (``telemetry/probe.py``).
``pipeline_unit`` predicts what the port runs.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.parallel.axes import IssuedCollective
from repro_torch.telemetry.counted import MeasuredCosts

# below this per-rank message size (paper float units) a bucket mismatch
# is bookkeeping, not energy: loss scalars, masks and the tiny gathers
SMALL_M_FLOATS = 4096.0

# the phantom kernels' wrappers, whose launches a kernel unit counts
KERNELS = ("phantom_fused_matmul", "matmul_nt", "matmul_tn")


@dataclass(frozen=True)
class PricedCollective:
    """One predicted collective bucket: ``count`` occurrences of a
    ``kind`` collective moving ``m_floats`` per-rank floats each
    (CommEvent units) over a mesh axis of size ``group``."""
    kind: str          # paper kind: all_gather | all_reduce | ...
    m_floats: float
    group: int
    count: float = 1.0

    @property
    def total_m_floats(self) -> float:
        return self.m_floats * self.count


@dataclass
class AuditUnit:
    """One executed entry point, ready for the program rules."""

    name: str                   # e.g. "ffn_train/audit-ffn-tensor/dp1tp8"
    kind: str                   # ffn_train | kernel | pipeline | serve_*
                                # | plan
    logs: List[List[IssuedCollective]] = field(default_factory=list)
    costs: MeasuredCosts = field(default_factory=MeasuredCosts)
    upcasts: Optional[List[dict]] = None
    predicted: List[PricedCollective] = field(default_factory=list)
    axes: Dict[str, int] = field(default_factory=dict)  # tp/dp/pp sizes
    compute_dtype: str = "float32"
    static_args: Dict[str, object] = field(default_factory=dict)
    # strict units pin the measured/predicted account (the probes, whose
    # wire ratio pins at 1.00); loose units (serving: bf16 wire against
    # float units, latency-dominated small messages) report bucket errors
    # one severity lower
    strict: bool = True
    wire_rtol: float = 0.05
    small_m_floats: float = SMALL_M_FLOATS
    napkin_bytes: Optional[float] = None    # planner live-memory estimate
    meta: Dict[str, object] = field(default_factory=dict)

    def device_count(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= max(int(v), 1)
        return n

    def measured_buckets(self) -> Dict[tuple, Dict[str, float]]:
        """The logged collectives by (paper kind, group size), per rank:
        summed over the ranks' logs, then divided by their number.
        Groups of one rank issue nothing (``Group`` returns at once) and
        would be dropped, as ``predicted_buckets`` drops them."""
        out: Dict[tuple, Dict[str, float]] = {}
        for log in self.logs:
            for ev in log:
                if int(ev.group) <= 1:
                    continue
                b = out.setdefault((ev.collective, int(ev.group)),
                                   {"count": 0.0, "m_floats": 0.0})
                b["count"] += 1.0
                b["m_floats"] += ev.m_floats
        n = max(len(self.logs), 1)
        for b in out.values():
            b["count"] /= n
            b["m_floats"] /= n
        return out

    def predicted_buckets(self) -> Dict[tuple, Dict[str, float]]:
        """Predicted traffic in the same (kind, group) buckets; groups of
        one device carry no wire traffic and are dropped."""
        out: Dict[tuple, Dict[str, float]] = {}
        for pc in self.predicted:
            if pc.group <= 1 or pc.total_m_floats <= 0.0:
                continue
            key = (pc.kind, int(pc.group))
            b = out.setdefault(key, {"count": 0.0, "m_floats": 0.0})
            b["count"] += pc.count
            b["m_floats"] += pc.total_m_floats
        return out


# ---------------------------------------------------------------------------
# what a step does, seen from the dispatcher
# ---------------------------------------------------------------------------

class LiveBytes:
    """The bytes of the tensors that the dispatcher created on one device
    type and that are still alive, and their peak.  Each op's fresh
    outputs (returns without alias information: no views, no in-place
    results) add their storage's bytes; a storage's bytes leave when the
    output's Python object dies and the storage with it.  A storage
    still held elsewhere (a view, a saved tensor, a gradient the autograd
    engine keeps) waits in ``_held`` until a later allocation would pass
    the peak, when the held storages are checked again, so the peak is
    exact while the live count between peaks may run high."""

    def __init__(self, device_type: str):
        from torch.multiprocessing.reductions import StorageWeakRef
        self._ref = StorageWeakRef
        self.device_type = device_type
        self.live = 0
        self.peak = 0
        self._held: Dict[int, tuple] = {}
        self._lock = threading.Lock()

    def _died(self, ref, n: int):
        with self._lock:
            if ref.expired():
                self.live -= n
            else:
                self._held[id(ref)] = (ref, n)

    def _prune(self):
        for key, (ref, n) in list(self._held.items()):
            if ref.expired():
                del self._held[key]
                self.live -= n

    def add(self, func, out):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for ret, t in zip(func._schema.returns, outs):
            if (not isinstance(t, torch.Tensor) or ret.alias_info is not None
                    or t.device.type != self.device_type):
                continue
            st = t.untyped_storage()
            n, ref = st.nbytes(), self._ref(st)
            with self._lock:
                self.live += n
                if self.live > self.peak:
                    self._prune()
                    self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._died, ref, n)


_CASTS = ("aten::_to_copy", "aten::to", "aten::copy_")


class StepMode(TorchDispatchMode):
    """A dispatch mode over one step that records what the audit's rules
    read: every bfloat16 -> float32 cast (``aten._to_copy``,
    ``aten.to.dtype``, ``aten.copy_`` into a float32 tensor) as
    ``upcasts`` (shape and count), the plan each phantom kernel call
    takes (``kernel_plans``: its route and shared memory), and, with
    ``live`` set to a device type, the peak of live bytes there
    (``LiveBytes``)."""

    def __init__(self, live: Optional[str] = None):
        super().__init__()
        self.casts: Dict[tuple, int] = {}
        self.plans: List[dict] = []
        self.live = LiveBytes(live) if live else None

    @property
    def upcasts(self) -> List[dict]:
        out = []
        for shape, n in sorted(self.casts.items()):
            elements = 1
            for d in shape:
                elements *= int(d)
            out.append({"shape": list(shape), "elements": elements,
                        "count": n})
        return out

    def _cast(self, func, args, out):
        name = func._schema.name
        if name not in _CASTS:
            return
        src = args[1] if name == "aten::copy_" else args[0]
        dst = args[0] if name == "aten::copy_" else out
        if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                and src.dtype == torch.bfloat16
                and dst.dtype == torch.float32):
            shape = tuple(dst.shape)
            self.casts[shape] = self.casts.get(shape, 0) + 1

    def _plan(self, func, args):
        from repro_torch.kernels import phantom_fused as pf
        name = func._schema.name
        if not name.startswith("repro_torch::") or \
                args[0].device.type not in ("cpu", "cuda"):
            return
        if name == "repro_torch::phantom_fused_matmul":
            plan, product = pf.forward_plan(*args[:4]), "forward"
        elif name == "repro_torch::matmul_nt":
            plan = pf.dgrad_plan(args[0], *[t for t in args[1:3]
                                            if t is not None])
            product = "dgrad"
        elif name == "repro_torch::matmul_tn":
            a, b = args[0], args[1]
            a2 = args[2] if len(args) > 2 else None
            plan, product = pf.tn_plan(a, b, a2), "wgrad"
        else:
            return
        rec = {"product": product, "kernel": plan.kernel,
               "smem_bytes": int(plan.smem_bytes),
               "esize": int(args[0].element_size())}
        if hasattr(plan, "bm"):
            rec.update(bm=plan.bm, bn=plan.bn, bk=plan.bk,
                       stages=plan.stages, dgrad=plan.dgrad)
        if rec not in self.plans:
            self.plans.append(rec)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._plan(func, args)
        out = func(*args, **kwargs)
        self._cast(func, args, out)
        if self.live is not None:
            self.live.add(func, out)
        return out


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict, list or tuple."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def kernel_launches() -> Dict[str, int]:
    from repro_torch.kernels import phantom_fused as pf
    return {name: getattr(pf, name).launches for name in KERNELS}


def measure_step(fn, *args, device) -> dict:
    """Run ``fn(*args)`` once, after one warm-up call (which allocates
    the libraries' workspaces), under the counters: the issued
    collectives, the flops, the casts, the phantom kernels' plans and
    launches, the argument bytes and the step's own bytes (module
    docstring).  Returns picklable values."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.parallel.axes import record_collectives
    from repro_torch.telemetry.counted import collective_costs
    on_card = device.type == "cuda"
    fn(*args)
    if on_card:
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    mode = StepMode(live=None if on_card else device.type)
    counter = FlopCounterMode(display=False)
    launched = kernel_launches()
    with record_collectives() as log, counter, mode:
        out = fn(*args)
    if on_card:
        torch.cuda.synchronize(device)
        step_bytes = torch.cuda.max_memory_allocated(device) - before
    else:
        step_bytes = mode.live.peak
    del out
    return {
        "events": [(e.collective, e.m_floats, e.group, e.issued_as)
                   for e in log.events],
        "flops": float(counter.get_total_flops()),
        "collectives": collective_costs(log.events),
        "memory": {"argument_bytes": tensor_bytes(args),
                   "step_bytes": int(step_bytes)},
        "upcasts": mode.upcasts,
        "kernel_plans": mode.plans,
        "launches": {k: v - launched[k]
                     for k, v in kernel_launches().items()},
    }


# ---------------------------------------------------------------------------
# the rank bodies
# ---------------------------------------------------------------------------

def _probe_rank(axes, device, cfg, global_batch: int, seed: int = 0):
    """One paper-FFN probe step (``telemetry/probe.py``) on this rank,
    measured."""
    from repro_torch.telemetry.probe import make_ffn_probe_step, probe_inputs
    probe, decls = make_ffn_probe_step(cfg, axes, global_batch)
    params, x, y = probe_inputs(cfg, axes, decls, global_batch, seed, device)
    return measure_step(probe, params, x, y, device=device)


def _serve_rank(axes, device, sc, seed: int = 0):
    """One prefill of ``sc.slots`` x ``sc.page_size`` tokens (the
    smallest bucket) and one decode step of this rank's engine,
    measured, as ``serve/router.py: run_config`` measures them."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.router import serve_params
    cfg = sc.model_config()
    eng = ServeEngine(cfg, serve_params(cfg, axes, seed, device),
                      slots=sc.slots, max_len=sc.max_len,
                      page_size=sc.page_size, axes=axes, device=device)
    n = len(eng.rows)
    zeros = torch.zeros((n, sc.page_size), dtype=torch.long, device=device)
    return {
        "prefill": measure_step(eng.prefill_fn, zeros, device=device),
        "decode": measure_step(eng.decode_fn, eng._zero_cache(),
                               zeros[:, :1], zeros[:, 0], device=device),
    }


def _mesh(mesh) -> tuple:
    """(dp, tp, pp) of a ``(dp, tp)`` or ``(dp, tp, pp)`` mesh, the
    arguments of ``launch/mesh.py: make_local_mesh``."""
    dp, tp, *rest = mesh
    return int(dp), int(tp), int(rest[0]) if rest else 1


def _run(fn, mesh, args, pool, device):
    """``fn(axes, device, *args)`` on every rank of ``mesh``: ``pool``'s
    ranks when it has as many, else new ranks."""
    from repro_torch.launch.mesh import spawn
    dp, tp, pp = _mesh(mesh)
    if pool is not None and pool.world == dp * tp * pp:
        return pool.run(fn, dp, tp, args, pp=pp)
    return spawn(fn, dp, tp, device, args=args, pp=pp)


def _measured(ranks: List[dict]) -> dict:
    """The unit's measured fields from every rank's ``measure_step``."""
    logs = [[IssuedCollective(*e) for e in r["events"]] for r in ranks]
    r0 = ranks[0]
    memory = {k: max(r["memory"][k] for r in ranks)
              for k in r0["memory"]}
    costs = MeasuredCosts(
        flops=r0["flops"],
        collective_wire_bytes=sum(c["wire_bytes"]
                                  for c in r0["collectives"].values()),
        collective_m_floats=sum(c["m_floats"]
                                for c in r0["collectives"].values()),
        collectives=r0["collectives"], memory=memory)
    upcasts, seen = [], set()
    for r in ranks:
        for u in r["upcasts"]:
            if tuple(u["shape"]) not in seen:
                seen.add(tuple(u["shape"]))
                upcasts.append(u)
    plans = []
    for r in ranks:
        plans += [p for p in r["kernel_plans"] if p not in plans]
    return {"logs": logs, "costs": costs, "upcasts": upcasts,
            "plans": plans, "launches": r0["launches"]}


def _loss_psum(devices: int) -> PricedCollective:
    # the probes' scalar loss psum over ALL mesh axes
    return PricedCollective("all_reduce", 1.0, devices, 1.0)


def _ffn_predicted(cfg, dp: int, tp: int, global_batch: int, events):
    """The FFN probes' account: the layer events at the per-dp-shard
    rows on the model axis, the gradient psum over dp (one per W and b
    of each layer), the loss psum over all ranks."""
    from repro_torch.core.ffn import ffn_strategy
    st = ffn_strategy(cfg, tp)
    L = cfg.num_layers
    predicted = [PricedCollective(ev.collective, ev.m_floats, tp, reps)
                 for ev, reps in events]
    if dp > 1:
        m_grads = L * st.param_count() / max(tp, 1)
        predicted.append(PricedCollective(
            "all_reduce", m_grads / (2 * L), dp, 2.0 * L))
    predicted.append(_loss_psum(dp * tp))
    return st, predicted


def ffn_train_unit(cfg, mesh, global_batch: int, *, pool=None,
                   device=None) -> AuditUnit:
    """The paper-FFN fwd+bwd probe step (``telemetry/probe.py``): the
    entry point whose ledger wire ratio pins at 1.00.  ``mesh`` is
    ``(dp, tp)``."""
    from repro_torch.parallel.axes import resolve_device
    dp, tp, _ = _mesh(mesh)
    m = _measured(_run(_probe_rank, (dp, tp), (cfg, global_batch), pool,
                       resolve_device(device)))
    rows_local = global_batch / max(dp, 1)
    from repro_torch.core.ffn import ffn_strategy
    st, predicted = _ffn_predicted(
        cfg, dp, tp, global_batch,
        [(ev, cfg.num_layers)
         for ev in ffn_strategy(cfg, tp).comm_events(rows_local)])
    return AuditUnit(
        name=f"ffn_train/{cfg.name}/dp{dp}tp{tp}",
        kind="ffn_train", logs=m["logs"], costs=m["costs"],
        upcasts=m["upcasts"], predicted=predicted,
        axes={"dp": dp, "tp": tp, "pp": 1}, compute_dtype="float32",
        static_args={"cfg": cfg, "strategy_spec": cfg.projection_spec(
            "ffn_layer")},
        strict=True, wire_rtol=0.05,
        meta={"strategy": st.kind, "global_batch": global_batch})


def kernel_unit(cfg, mesh, global_batch: int, *, pool=None,
                device=None) -> AuditUnit:
    """The phantom FFN probe with ``kernel_backend="pallas"``: on the
    card the hand-written phantom kernels (``kernels/ops.py:
    phantom_fused_linear``), on the CPU their plain versions.  Predicted
    from ``telemetry/predict.py: fused_kernel_step_events``, which equals
    the plain path's account by construction: the kernels fuse GEMMs,
    never collectives, and this unit shows that nothing went unpriced
    when the math moved into them.  ``meta`` holds rank 0's launches of
    each kernel in the step (``launches_<name>``, ``kernel_launches`` in
    all) and the plans its calls took (``kernel_plans``, what the
    ``kernel-smem`` rule checks)."""
    from repro_torch.kernels.phantom_fused import SMEM_BUDGET_BYTES
    from repro_torch.parallel.axes import resolve_device
    from repro_torch.telemetry.predict import fused_kernel_step_events
    dp, tp, _ = _mesh(mesh)
    m = _measured(_run(_probe_rank, (dp, tp), (cfg, global_batch), pool,
                       resolve_device(device)))
    rows_local = global_batch / max(dp, 1)
    st, predicted = _ffn_predicted(
        cfg, dp, tp, global_batch,
        fused_kernel_step_events(cfg, tp, rows_local))
    spec = cfg.projection_spec("ffn_layer")
    return AuditUnit(
        name=f"kernel/{cfg.name}/dp{dp}tp{tp}",
        kind="kernel", logs=m["logs"], costs=m["costs"],
        upcasts=m["upcasts"], predicted=predicted,
        axes={"dp": dp, "tp": tp, "pp": 1}, compute_dtype="float32",
        static_args={"cfg": cfg, "strategy_spec": spec},
        strict=True, wire_rtol=0.05,
        meta={"strategy": st.kind, "global_batch": global_batch,
              "kernel_backend": spec.kernel_backend,
              "kernel_plans": m["plans"],
              "kernel_smem_budget": SMEM_BUDGET_BYTES,
              "kernel_smem_bytes": max((p["smem_bytes"] for p in m["plans"]),
                                       default=0),
              "kernel_launches": sum(m["launches"].values()),
              **{f"launches_{k}": v for k, v in m["launches"].items()}})


def pipeline_unit(cfg, mesh, global_batch: int, *, pool=None,
                  device=None) -> AuditUnit:
    """The 1F1B pipelined paper-FFN probe step on ``(dp, tp, pp)``:
    predicted with ``pipeline_ffn_step_events(executed=False)``, its
    permutes at their per-rank mean (the module's docstring says why
    this differs from the reference's account)."""
    from repro_torch.parallel.axes import resolve_device
    from repro_torch.telemetry.predict import pipeline_ffn_step_events
    dp, tp, pp = _mesh(mesh)
    m = _measured(_run(_probe_rank, (dp, tp, pp), (cfg, global_batch),
                       pool, resolve_device(device)))
    acct = pipeline_ffn_step_events(cfg, pp, tp, dp, global_batch,
                                    executed=False)
    sends = (pp - 1) / pp       # the stages' mean share of 2M sends
    predicted = [PricedCollective(
        ev.collective, ev.m_floats, g,
        n * sends if ev.collective == "collective_permute" else n)
        for ev, g, n in acct["events"]]
    predicted.append(_loss_psum(dp * tp * pp))
    return AuditUnit(
        name=f"pipeline/{cfg.name}/pp{pp}dp{dp}tp{tp}",
        kind="pipeline", logs=m["logs"], costs=m["costs"],
        upcasts=m["upcasts"], predicted=predicted,
        axes={"dp": dp, "tp": tp, "pp": pp}, compute_dtype="float32",
        static_args={"cfg": cfg, "pipeline": cfg.pipeline},
        strict=True, wire_rtol=0.05,
        meta={"strategy": acct["strategy"].kind,
              "microbatches": acct["schedule"].microbatches,
              "ticks": acct["schedule"].num_ticks,
              "global_batch": global_batch})


def serve_units(sc, mesh=None, *, pool=None, device=None) -> List[AuditUnit]:
    """The serving engine's prefill and decode for one ``ServeConfig``,
    run the way ``serve/router.py: run_config`` measures them (one
    prefill at the smallest bucket, one decode step), priced by
    ``serve_step_events`` (the account ``serve_step_prediction`` sums).

    Serving units are LOOSE, as the reference's: bf16 messages count
    half a float and the latency-priced small messages put exact bucket
    matching out of reach; the energy-ratio band for this path is
    [0.5, 2.0], and the unit's tolerances mirror it."""
    from repro_torch.parallel.axes import resolve_device
    from repro_torch.telemetry.predict import serve_step_events
    cfg = sc.model_config()
    mesh = mesh or (sc.dp, sc.tp)
    ranks = _run(_serve_rank, mesh, (sc,), pool, resolve_device(device))
    S = sc.page_size
    units = []
    for phase, rows in (("prefill", sc.slots * S), ("decode", sc.slots)):
        m = _measured([r[phase] for r in ranks])
        events = serve_step_events(cfg, sc.tp, rows, phase,
                                   sequences=sc.slots, dp=sc.dp)
        predicted = [PricedCollective(ev.collective, ev.m_floats, sc.tp, n)
                     for ev, n in events]
        units.append(AuditUnit(
            name=f"serve_{phase}/{sc.name}",
            kind=f"serve_{phase}", logs=m["logs"], costs=m["costs"],
            upcasts=m["upcasts"], predicted=predicted,
            axes={"dp": sc.dp, "tp": sc.tp, "pp": 1},
            compute_dtype=cfg.dtype,
            static_args={"cfg": cfg, "serve_config": sc},
            strict=False, wire_rtol=0.75,
            small_m_floats=4.0 * SMALL_M_FLOATS,
            meta={"rows": rows, "phase": phase, "slots": sc.slots,
                  "prefill_len": S}))
    return units


def plan_splits(plan) -> None:
    """Raises ``ValueError`` where a planner candidate's parameters do not
    split over its own (dp, tp, pp) mesh: the candidate's own failure,
    found on meta before any rank starts, as the reference's fails to
    lower."""
    from repro_torch.core.ffn import ffn_decls
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import meta_shards
    axes = MeshAxes(tp=plan.tp, dp=plan.dp, pp=plan.pp)
    meta_shards(ffn_decls(plan.model_config(), axes), axes)


def plan_unit(plan, mesh=None, *, pool=None, device=None) -> AuditUnit:
    """One planner candidate: its probe step on ranks of the candidate's
    own (dp, tp, pp) mesh (``pool``'s when it has as many), with the
    planner's napkin estimate of its live bytes.  A candidate whose
    parameters do not split over its mesh raises ``ValueError`` here
    (``plan_splits``), before any rank starts."""
    from repro_torch.planner.constraints import hbm_bytes_estimate
    plan_splits(plan)
    cfg = plan.model_config()
    mesh = mesh or (plan.dp, plan.tp, plan.pp)
    if plan.pp > 1:
        unit = pipeline_unit(cfg, mesh, plan.batch, pool=pool, device=device)
    else:
        unit = ffn_train_unit(cfg, mesh[:2], plan.batch, pool=pool,
                              device=device)
    unit.name = f"plan/{plan.name}"
    unit.kind = "plan"
    unit.napkin_bytes = float(hbm_bytes_estimate(plan))
    unit.meta["plan"] = plan.name
    return unit


class RankPools:
    """One ``launch/mesh.py: RankPool`` per world size, started on first
    use (``get``) and closed together when the ``with`` block that owns
    them ends: a call that audits several meshes of one size starts their
    ranks once.  An entry point owns them (``caller_or_own``); the layers
    below take them and never start or close them.  ``given`` pools (the
    caller's) are used and left open.  A job that fails kills its pool's
    ranks; the next ``get`` of that size starts new ones."""

    def __init__(self, device=None, given=(), timeout_s: float = 3600.0):
        self.device = device
        self.timeout_s = timeout_s
        self._given = {p.world: p for p in given if p is not None}
        self._own: Dict[int, object] = {}

    def get(self, world: int):
        from repro_torch.launch.mesh import RankPool
        if world in self._given and self._given[world].alive:
            return self._given[world]
        if world not in self._own or not self._own[world].alive:
            self._own[world] = RankPool(1, world, self.device,
                                        timeout_s=self.timeout_s)
        return self._own[world]

    def __enter__(self) -> "RankPools":
        return self

    def __exit__(self, exc_type, exc, tb):
        for pool in self._own.values():
            pool.close(kill=exc_type is not None)
        self._own.clear()
        return False


def caller_or_own(pools: Optional[RankPools], device,
                  timeout_s: float = 3600.0):
    """An entry point's worlds: the caller's ``pools`` (left open), else
    ``RankPools`` of its own, closed when its ``with`` block ends."""
    if pools is not None:
        return contextlib.nullcontext(pools)
    return RankPools(device, timeout_s=timeout_s)


def build_default_units(pools: RankPools, *, arch: str = "qwen2.5-14b",
                        device=None) -> List[AuditUnit]:
    """The ``audit --all`` set, the reference's: tensor and phantom FFN
    train probes (tp 8 and dp 2 x tp 4), the phantom probe through the
    kernels (tp 8), the 1F1B pipeline probe (pp 2 x dp 2 x tp 2) and a
    serving engine's prefill and decode (tensor and phantom, dp 1 x tp
    4), on ``device``: ``pools``' worlds of 8 ranks and 4.

    The train probes run at width 1024 (not the width-128 smoke size):
    the audited per-layer messages must clear the small-message noise
    floor, or every accounting error would demote to info."""
    from repro_torch.configs.base import (dense_projection_map, get_config,
                                          phantom_projection_map)
    from repro_torch.serve.router import ServeConfig

    base = get_config("paper-ffn-4k", smoke=True).replace(
        d_model=1024, ffn_width=1024)
    dense = base.replace(name="audit-ffn-tensor",
                         projections=dense_projection_map())
    phantom = base.replace(
        name="audit-ffn-phantom",
        projections=phantom_projection_map(8, ffn_layer=True))
    pallas = base.replace(
        name="audit-ffn-pallas",
        projections=phantom_projection_map(8, ffn_layer=True,
                                           kernel_backend="pallas"))
    pipe = phantom.replace(
        name="audit-ffn-pipe",
        pipeline=phantom.pipeline.__class__(stages=2), microbatches=4)
    eight = pools.get(8)
    kw = dict(pool=eight, device=device)
    units = [ffn_train_unit(dense, (1, 8), 64, **kw),
             ffn_train_unit(phantom, (1, 8), 64, **kw),
             ffn_train_unit(phantom, (2, 4), 64, **kw),
             kernel_unit(pallas, (1, 8), 64, **kw),
             pipeline_unit(pipe, (2, 2, 2), 64, **kw)]
    four = pools.get(4)
    for impl in ("tensor", "phantom"):
        sc = ServeConfig(arch=arch, impl=impl, dp=1, tp=4, slots=4,
                         max_len=64, page_size=16)
        units.extend(serve_units(sc, pool=four, device=device))
    return units
