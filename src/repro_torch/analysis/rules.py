"""Program rules: checks over one executed entry point (an ``AuditUnit``),
the port of the JAX package's ``analysis/rules.py``.

Every rule is a pure function ``rule(unit) -> List[Finding]`` registered
in ``PROGRAM_RULES``; ``run_rules`` applies them all.  Rules read what a
unit recorded (the ranks' collective logs, the casts and kernel plans a
dispatch mode saw, the memory figures, the config objects), never the
entry point, so seeded-violation fixtures can feed synthetic records and
prove each rule fires (``tests/test_torch_audit_rules.py``).

Where the reference reads what XLA lowered, the port reads what ran:
  * R1 ``collective-accounting`` and R4 ``recompilation-hazard`` are the
    reference's;
  * R2 ``sharding-hygiene`` checks group legality on the logged
    collectives, and the step's own live bytes (its arguments plus what
    the step allocated, ``units.py``) against the planner's napkin
    estimate;
  * R3 ``dtype-drift`` reads the bf16 -> float32 casts a dispatch mode
    recorded over the step (``units.py: StepMode``), where the reference
    walks the jaxpr's ``convert_element_type``;
  * R5 ``kernel-smem`` checks the shared memory of the plans the phantom
    kernels' calls took against one H100 block's budget
    (``kernels/phantom_fused.py: SMEM_BUDGET_BYTES``), where the
    reference's ``kernel-vmem`` checks a TPU core's VMEM.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List

from repro_torch.analysis.findings import ERROR, INFO, WARNING, Finding
from repro_torch.analysis.units import AuditUnit

# dtype-drift: bf16 -> f32 casts below this many elements are scalar
# bookkeeping (loss terms, norms), not a path-wide upcast
DTYPE_DRIFT_MIN_ELEMENTS = 65_536
# sharding-hygiene: a step's live memory may exceed the napkin estimate
# by temporaries; past this factor something is replicated
MEMORY_BLOWUP_FACTOR = 8.0


def _demote(severity: str, strict: bool) -> str:
    """Loose units (serving) report one level below strict units."""
    if strict:
        return severity
    return {ERROR: WARNING, WARNING: INFO}.get(severity, INFO)


# ---------------------------------------------------------------------------
# R1: collective accounting
# ---------------------------------------------------------------------------

def rule_collective_accounting(unit: AuditUnit) -> List[Finding]:
    """Every logged collective must match a predicted ``CommEvent``
    bucket by (kind, mesh-axis size) and per-rank message floats, and
    vice versa.  Unpriced measured traffic and predicted-but-never-
    issued (phantom) traffic are errors; mismatches under
    ``small_m_floats`` are the latency-priced noise floor (scalar loss
    psums, the tiny gathers) and report as info."""
    out: List[Finding] = []
    measured = unit.measured_buckets()
    predicted = unit.predicted_buckets()
    for key in sorted(set(measured) | set(predicted)):
        kind, group = key
        skey = f"{kind}@g{group}"
        m = measured.get(key)
        p = predicted.get(key)
        if p is None:
            sev = INFO if m["m_floats"] < unit.small_m_floats \
                else _demote(ERROR, unit.strict)
            out.append(Finding(
                "collective-accounting", sev, unit.name,
                f"unpriced collective: the executed step issues {kind} "
                f"over a group of {group} ({m['count']:g} ops, "
                f"{m['m_floats']:.0f} floats/rank) but no CommEvent "
                f"prices it", key=skey,
                detail={"measured": m, "predicted": None}))
            continue
        if m is None:
            sev = INFO if p["m_floats"] < unit.small_m_floats \
                else _demote(ERROR, unit.strict)
            out.append(Finding(
                "collective-accounting", sev, unit.name,
                f"phantom prediction: the account prices {kind} over a "
                f"group of {group} ({p['m_floats']:.0f} floats/rank) "
                f"but the executed step never issues it", key=skey,
                detail={"measured": None, "predicted": p}))
            continue
        hi = max(m["m_floats"], p["m_floats"])
        rel = abs(m["m_floats"] - p["m_floats"]) / hi if hi else 0.0
        if rel > unit.wire_rtol:
            sev = INFO if hi < unit.small_m_floats \
                else _demote(ERROR, unit.strict)
            out.append(Finding(
                "collective-accounting", sev, unit.name,
                f"mispriced collective: {kind} over a group of {group} "
                f"moves {m['m_floats']:.0f} floats/rank issued vs "
                f"{p['m_floats']:.0f} predicted "
                f"(rel {rel:.2f} > rtol {unit.wire_rtol})",
                key=f"{skey}:bytes",
                detail={"measured": m, "predicted": p, "rel": rel}))
        elif m["count"] != p["count"]:
            out.append(Finding(
                "collective-accounting", INFO, unit.name,
                f"{kind} over a group of {group}: {m['count']:g} "
                f"issued ops vs {p['count']:g} predicted events "
                f"(bytes agree: fusion/splitting only)",
                key=f"{skey}:count",
                detail={"measured": m, "predicted": p}))
    return out


# ---------------------------------------------------------------------------
# R2: sharding hygiene
# ---------------------------------------------------------------------------

def rule_sharding_hygiene(unit: AuditUnit) -> List[Finding]:
    """Collectives must run over mesh-axis-shaped groups (a group size
    that is no product of the unit's axes means a reshard the
    ``ProjectionSpec`` never implied), and the step's live memory (its
    arguments plus what it allocated) must stay within
    ``MEMORY_BLOWUP_FACTOR`` of the planner's napkin estimate (past that
    something is replicated)."""
    out: List[Finding] = []
    sizes = [max(int(v), 1) for v in unit.axes.values()]
    legal = {1}
    for s in sizes:
        legal |= {g * s for g in list(legal)}
    for (kind, group), m in sorted(unit.measured_buckets().items()):
        if group not in legal:
            out.append(Finding(
                "sharding-hygiene", _demote(WARNING, unit.strict),
                unit.name,
                f"{kind} over a group of {group}, which is no product "
                f"of the mesh axes {unit.axes}: a reshard the "
                f"ProjectionSpec does not imply", key=f"group{group}",
                detail={"kind": kind, "group": group,
                        "axes": dict(unit.axes), "measured": m}))
    if unit.napkin_bytes:
        mem = unit.costs.memory or {}
        live = sum(float(mem.get(f) or 0.0)
                   for f in ("argument_bytes", "step_bytes"))
        if live > MEMORY_BLOWUP_FACTOR * unit.napkin_bytes:
            out.append(Finding(
                "sharding-hygiene", _demote(WARNING, unit.strict),
                unit.name,
                f"live memory blowup: the step holds "
                f"{live / 2**20:.1f} MiB vs the planner napkin estimate "
                f"{unit.napkin_bytes / 2**20:.1f} MiB "
                f"(> {MEMORY_BLOWUP_FACTOR:.0f}x: replication?)",
                key="memory-blowup",
                detail={"live_bytes": live,
                        "napkin_bytes": unit.napkin_bytes}))
    return out


# ---------------------------------------------------------------------------
# R3: dtype drift
# ---------------------------------------------------------------------------

def rule_dtype_drift(unit: AuditUnit) -> List[Finding]:
    """In bf16 compute paths, a large bf16 -> f32 cast means some
    operator runs (and moves memory) at double width: drift the energy
    account never priced.  Scalar and small casts (losses, norm
    statistics) are exempt below ``DTYPE_DRIFT_MIN_ELEMENTS``."""
    if unit.upcasts is None or "bf" not in str(unit.compute_dtype):
        return []
    out: List[Finding] = []
    seen = set()
    for cast in unit.upcasts:
        shape = tuple(int(d) for d in cast["shape"])
        n = 1
        for d in shape:
            n *= d
        if n < DTYPE_DRIFT_MIN_ELEMENTS:
            continue
        key = f"upcast{shape}"
        if key in seen:
            continue
        seen.add(key)
        out.append(Finding(
            "dtype-drift", WARNING, unit.name,
            f"f32 upcast inside a bf16 path: cast bf16 -> f32 of "
            f"shape {shape} ({n} elements)", key=key,
            detail={"shape": list(shape), "elements": n,
                    "count": cast.get("count", 1)}))
    return out


# ---------------------------------------------------------------------------
# R4: recompilation hazards
# ---------------------------------------------------------------------------

def rule_recompilation_hazard(unit: AuditUnit) -> List[Finding]:
    """The config objects an entry point is built from must be hashable
    AND hash-stable under copy (frozen dataclasses are; anything carrying
    a list, dict or array is not): an unstable one makes every cache
    keyed on it (the kernels' plans, the telemetry's) miss forever."""
    out: List[Finding] = []
    for name, obj in unit.static_args.items():
        try:
            h = hash(obj)
        except TypeError as e:
            out.append(Finding(
                "recompilation-hazard", ERROR, unit.name,
                f"unhashable static arg {name!r} "
                f"({type(obj).__name__}): {e}", key=name,
                detail={"type": type(obj).__name__}))
            continue
        try:
            clone = copy.deepcopy(obj)
        except Exception:
            continue
        if hash(clone) != h or clone != obj:
            out.append(Finding(
                "recompilation-hazard", ERROR, unit.name,
                f"hash-unstable static arg {name!r} "
                f"({type(obj).__name__}): an equal copy hashes "
                f"differently, so caches keyed on it always miss",
                key=name, detail={"type": type(obj).__name__}))
    return out


# ---------------------------------------------------------------------------
# R5: the kernels' shared memory
# ---------------------------------------------------------------------------

def plan_smem_bytes(plan: dict) -> int:
    """The shared memory one block of ``plan``'s kernel needs, from the
    port's own accounting (``kernels/phantom_fused.py``): the wgmma
    kernels' ``wg_smem_bytes`` (raises ``KernelConfigError`` past the
    budget), the wgrad's ``wgrad_smem_bytes``, ``splitk_kernel``'s
    ``kernel_smem_bytes``."""
    from repro_torch.kernels import phantom_fused as pf
    kernel = plan["kernel"]
    if kernel == "tn_kernel":
        return pf.wgrad_smem_bytes(plan["esize"])
    if kernel == "wgmma_wgrad_kernel":
        return pf.wg_smem_bytes(*pf.WG_WGRAD_SHAPE,
                                stages=pf.WG_RING[pf.WG_WGRAD_SHAPE])
    if kernel.startswith("wgmma"):
        return pf.wg_smem_bytes(plan["bm"], plan["bn"], plan["bk"],
                                plan["stages"])
    return pf.kernel_smem_bytes(plan["dgrad"], plan["esize"], plan["bm"],
                                plan["bn"], plan["bk"], plan["stages"])


def rule_kernel_smem(unit: AuditUnit) -> List[Finding]:
    """Units whose step ran the phantom kernels (``meta.kernel_plans``,
    one entry per plan their calls took) must fit one H100 block's
    shared memory: the static form of the wrappers' ``KernelConfigError``
    guard, so an audit sweep flags an impossible tile plan before a
    launch fails on the card."""
    from repro_torch.kernels.phantom_fused import (SMEM_BUDGET_BYTES,
                                                   KernelConfigError)
    plans = (unit.meta or {}).get("kernel_plans") or []
    budget = (unit.meta or {}).get("kernel_smem_budget", SMEM_BUDGET_BYTES)
    out: List[Finding] = []
    for plan in plans:
        try:
            need = plan_smem_bytes(plan)
            why = ""
        except KernelConfigError as e:
            need, why = None, f": {e}"
        if need is not None and need <= budget:
            continue
        key = f"kernel-smem:{plan['product']}:{plan['kernel']}"
        tiles = {k: plan[k] for k in ("bm", "bn", "bk", "stages")
                 if k in plan}
        out.append(Finding(
            "kernel-smem", _demote(ERROR, unit.strict), unit.name,
            f"{plan['kernel']} ({plan['product']}) plan {tiles}"
            f" needs {'more than ' if need is None else ''}"
            f"{budget if need is None else need} B of shared memory, "
            f"over the {budget} B an H100 block may use{why}",
            key=key, detail={"plan": dict(plan), "need_bytes": need,
                             "budget_bytes": budget}))
    return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

PROGRAM_RULES: Dict[str, Callable[[AuditUnit], List[Finding]]] = {
    "collective-accounting": rule_collective_accounting,
    "sharding-hygiene": rule_sharding_hygiene,
    "dtype-drift": rule_dtype_drift,
    "recompilation-hazard": rule_recompilation_hazard,
    "kernel-smem": rule_kernel_smem,
}


def run_rules(unit: AuditUnit) -> List[Finding]:
    out: List[Finding] = []
    for rule in PROGRAM_RULES.values():
        out.extend(rule(unit))
    return out


def rule_catalog() -> List[dict]:
    """Every rule (program and source) with its severity and rationale."""
    from repro_torch.analysis.lint import SOURCE_RULES
    cat = [
        {"id": "collective-accounting", "severity": ERROR,
         "kind": "program",
         "rationale": "every collective the step issues must match a "
                      "predicted CommEvent by kind, mesh axis and bytes, "
                      "and vice versa; unpriced traffic is unpriced "
                      "energy"},
        {"id": "sharding-hygiene", "severity": WARNING,
         "kind": "program",
         "rationale": "collectives over non-mesh-axis groups are "
                      "resharding the ProjectionSpec never implied; "
                      "live memory far past the planner napkin estimate "
                      "is accidental replication"},
        {"id": "dtype-drift", "severity": WARNING, "kind": "program",
         "rationale": "large bf16->f32 casts inside bf16 paths run "
                      "operators at double width the energy account "
                      "never priced"},
        {"id": "recompilation-hazard", "severity": ERROR,
         "kind": "program",
         "rationale": "unhashable or hash-unstable entry-point configs "
                      "defeat every cache keyed on them"},
        {"id": "kernel-smem", "severity": ERROR, "kind": "program",
         "rationale": "a phantom-kernel plan whose shared memory passes "
                      "one H100 block's budget cannot launch; catch the "
                      "impossible tile plan statically"},
    ]
    cat += [{"id": rid, "severity": sev, "kind": "source",
             "rationale": why} for rid, (sev, why, _) in
            SOURCE_RULES.items()]
    return cat
