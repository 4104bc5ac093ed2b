"""Production-mesh dry run: the port's counterpart of the reference's
``python -m repro.launch.dryrun``.

For one (architecture x input shape x mesh) cell this runs ONE step of
the real entry point (the train step, fwd + bwd + optimizer, for
``train_*`` shapes; the serving prefill for ``prefill_*``; one decode
token against a ``seq_len`` cache for the others) for rank 0 of the
production mesh, 16 x 16 (dp x tp; ``--multi-pod``: 2 x 16 x 16, dp 32),
the paper's 256 GPUs, without the mesh and without memory: rank 0's
shards of the decls are tensors on ``torch.device("meta")`` (shapes and
dtypes, no data), and its process groups are ``parallel/axes.py:
DryGroup``s that log each collective's logical shape and return a meta
tensor of the result's.  The reference lowers and compiles the step
against ``ShapeDtypeStruct``s and reads XLA's analyses; torch compiles
nothing, so the step is counted as it runs:

  * ``flops_per_device``: ``FlopCounterMode`` (the kernels are
    dispatcher operators with flop formulas, so it counts them too);
  * ``collective_wire_bytes_per_device`` and ``collectives``: the
    ``record_collectives`` log, priced as the ledger prices it
    (``telemetry/counted.py: collective_costs``);
  * ``memory``: ``argument_bytes`` (the rank's parameters, optimizer
    state, cache and batch; ``param_bytes`` and ``optimizer_bytes`` of
    them), ``temp_bytes`` (the peak of the live bytes the step
    allocated, from a dispatch-mode tracker, ``analysis/units.py:
    LiveBytes``) and their sum, ``peak_bytes``;
  * ``hbm_bytes_per_device``: the eager, unfused sum of each dispatched
    op's operand and result bytes (views excluded): what the ops would
    move if none were fused (``hbm_method``);
  * the three roofline terms (``core/energy.py: roofline_terms``) at the
    H100's peak for the config's compute dtype.

The port has no ``scan_layers``: its counts are already per layer, so
``--cost-fix`` recounts the cell directly (``cost_method: "counted"``)
where the reference extrapolates from one and two layer groups.  A cell
whose step cannot run on meta (a host sync, a data-dependent shape)
is recorded as failed with its reason, as the reference prints ``FAIL``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k \
      --multi-pod
  python -m repro_torch.launch.dryrun --all       # every cell, subprocesses

Records go under ``build/dryrun/`` (``--out-dir``; ``--out`` names one).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.analysis.units import StepMode, tensor_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
DEFAULT_OUT_DIR = os.path.join(ROOT, "build", "dryrun")
META = torch.device("meta")


def make_cfg(arch: str, impl: str, variant: str | None = None,
             extra: dict | None = None):
    """The cell's config: ``--set`` overrides (``phantom.*`` through
    ``with_phantom_overrides``), then ``--impl dense`` or ``--variant``."""
    from repro_torch.configs.base import get_config
    extra = dict(extra or {})
    nested = {k.split(".", 1)[1]: extra.pop(k)
              for k in list(extra) if k.startswith("phantom.")}
    cfg = get_config(arch, **extra)
    if nested:
        from repro_torch.configs.base import with_phantom_overrides
        cfg = with_phantom_overrides(cfg, **nested)
    if impl == "dense":
        from repro_torch.configs.base import dense_projection_map
        cfg = cfg.replace(projections=dense_projection_map())
    elif variant:
        from repro_torch.configs.base import with_phantom_overrides
        cfg = with_phantom_overrides(cfg, variant=variant)
    return cfg


def dry_axes(dp: int, tp: int):
    """Rank 0's ``MeshAxes`` of a dp x tp mesh, every group a
    ``DryGroup``."""
    from repro_torch.parallel.axes import DryGroup, MeshAxes

    def group(n):
        return DryGroup(size=n, rank=0, ranks=tuple(range(n)))
    return MeshAxes(tp=tp, dp=dp, tp_group=group(tp), dp_group=group(dp),
                    world_group=group(dp * tp))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class DryMode(StepMode):
    """The dry step's dispatch mode: ``analysis/units.py: StepMode``
    tracking the meta device's live bytes, plus the eager, unfused HBM
    bytes: every op's tensor operands and results, but for ops that
    only view their input."""

    def __init__(self):
        super().__init__(live="meta")
        self.hbm_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        rets = func._schema.returns
        if rets and all(r.alias_info is not None
                        and not r.alias_info.is_write for r in rets):
            return out          # a view moves nothing
        for t in (*_tensors(args), *_tensors(kwargs or {}), *_tensors(out)):
            self.hbm_bytes += t.numel() * t.element_size()
        return out


def dry_step(cfg, kind: str, global_batch: int, seq_len: int, dp: int,
             tp: int) -> dict:
    """One step of ``cfg``'s entry point for ``kind`` (train, prefill or
    decode) on rank 0 of a dp x tp mesh, on meta, counted (module
    docstring).  A batch that does not split over dp is replicated, as
    the reference's batch spec leaves it (every dp rank computes the
    same rows)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.model import model_decls
    from repro_torch.parallel.axes import record_collectives
    from repro_torch.parallel.params import meta_shards
    from repro_torch.serve.engine import _add_modality_stubs
    from repro_torch.telemetry.counted import collective_costs

    replicated = global_batch % dp != 0
    axes = dry_axes(1 if replicated else dp, tp)
    B = global_batch if replicated else global_batch // dp
    t0 = time.perf_counter()
    params = meta_shards(model_decls(cfg, axes), axes)
    opt_state = {}
    if kind == "train":
        from repro_torch.optim import make_optimizer
        from repro_torch.train.trainer import make_train_step
        opt = make_optimizer(cfg.optimizer, 3e-4, weight_decay=0.1)
        step_fn, _, _ = make_train_step(cfg, axes, opt, device=META,
                                        microbatches=cfg.microbatches)
        opt_state = opt.init(params)
        batch = _add_modality_stubs(cfg, {
            k: torch.empty((B, seq_len), dtype=torch.long, device=META)
            for k in ("tokens", "labels")}, B, seq_len)
        args = (params, opt_state, 0, batch)
        fn = step_fn
    else:
        from repro_torch.models.model import (forward_decode,
                                              forward_prefill,
                                              rank_cache_decls,
                                              serving_params)
        params = serving_params(cfg, params, META)
        if kind == "prefill":
            batch = _add_modality_stubs(cfg, {"tokens": torch.empty(
                (B, seq_len), dtype=torch.long, device=META)}, B, seq_len)
            args = (cfg, axes, params, batch)
            fn = torch.no_grad()(forward_prefill)
        else:
            cache = meta_shards(rank_cache_decls(
                cfg, axes, B * axes.dp, seq_len), axes)
            toks = torch.empty((B, 1), dtype=torch.long, device=META)
            pos = torch.empty((B,), dtype=torch.long, device=META)
            args = (cfg, axes, params, cache, toks, pos)
            fn = torch.no_grad()(forward_decode)
    build_s = time.perf_counter() - t0
    arg_bytes = tensor_bytes(args)

    t1 = time.perf_counter()
    mode = DryMode()
    counter = FlopCounterMode(display=False)
    with record_collectives() as log, counter, mode:
        out = fn(*args)
    del out
    run_s = time.perf_counter() - t1
    per_op = collective_costs(log.events)
    return {
        "flops_per_device": float(counter.get_total_flops()),
        "hbm_bytes_per_device": float(mode.hbm_bytes),
        "hbm_method": "eager-unfused: the sum of every dispatched op's "
                      "operand and result bytes, views excluded",
        "collective_wire_bytes_per_device": sum(
            r["wire_bytes"] for r in per_op.values()),
        "collectives": per_op,
        "events": [(e.collective, e.m_floats, e.group) for e in log.events],
        "memory": {"argument_bytes": arg_bytes,
                   "param_bytes": tensor_bytes(params),
                   "optimizer_bytes": tensor_bytes(opt_state),
                   "temp_bytes": mode.live.peak,
                   "peak_bytes": arg_bytes + mode.live.peak,
                   "method": "dispatch-mode tracker of live meta bytes"},
        "upcasts": mode.upcasts,
        "batch_per_rank": B, "batch_replicated_over_dp": replicated,
        "timings": {"build_s": build_s, "run_s": run_s},
    }


def _mesh(multi_pod: bool) -> dict:
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def analyze(cfg, shape_name: str, impl: str, multi_pod: bool = False,
            mesh: dict | None = None) -> dict:
    """The cell's record (the reference's keys): the dry step of
    ``cfg`` at ``shape_name`` on the production mesh (or ``mesh``, a
    ``{"data": dp, "model": tp}`` dict)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.energy import (H100_PEAK_FLOPS_BF16,
                                         H100_PEAK_FLOPS_FP32,
                                         roofline_terms)
    from repro_torch.models.model import count_params

    mesh = mesh or _mesh(multi_pod)
    tp = mesh["model"]
    dp = mesh["data"] * mesh.get("pod", 1)
    shape = SHAPES[shape_name]
    step = dry_step(cfg, shape.kind, shape.global_batch, shape.seq_len,
                    dp, tp)
    peak = (H100_PEAK_FLOPS_BF16 if cfg.dtype == "bfloat16"
            else H100_PEAK_FLOPS_FP32)
    flops = step["flops_per_device"]
    rt = roofline_terms(flops, step["hbm_bytes_per_device"],
                        step["collective_wire_bytes_per_device"],
                        peak_flops=peak)
    n_active = count_params(cfg, active_only=True, tp=tp)
    n_total = count_params(cfg, active_only=False, tp=tp)
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train"
                                   else 1)
    mf = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    n_dev = dp * tp
    model_flops_per_dev = mf / n_dev
    rec = {
        "arch": cfg.name, "shape": shape_name, "impl": impl,
        "mesh": dict(mesh), "devices": int(n_dev),
        "roofline": {
            "compute_s": rt.compute_s, "memory_s": rt.memory_s,
            "collective_s": rt.collective_s, "dominant": rt.dominant,
            "step_s": rt.step_s,
            "fraction": rt.fraction_of_roofline(),
            "peak_flops": peak,
        },
        "params_total": n_total, "params_active": n_active,
        "model_flops_per_device": model_flops_per_dev,
        "useful_flops_ratio": (model_flops_per_dev / flops) if flops else 0,
    }
    rec.update({k: v for k, v in step.items() if k != "events"})
    return rec


def parse_sets(pairs):
    """--set key=value (typed) -> cfg override dict."""
    out = {}
    for pair in pairs or []:
        k, v = pair.split("=", 1)
        if v in ("true", "True"):
            out[k] = True
        elif v in ("false", "False"):
            out[k] = False
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


def _write(rec: dict, path: str | None):
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {path}")


def cost_fix(arch, shape_name, impl, json_path, variant=None,
             overrides=None, multi_pod=False):
    """Recount a cell and rewrite its JSON (``cost_method: "counted"``):
    the port's counts are already per layer, where the reference's
    extrapolate scan bodies from one and two layer groups."""
    rec = {}
    if os.path.exists(json_path):
        with open(json_path) as f:
            rec = json.load(f)
    cfg = make_cfg(arch, impl, variant, extra=overrides)
    rec.update(analyze(cfg, shape_name, impl, multi_pod,
                       mesh=rec.get("mesh")))
    rec["overrides"] = overrides or {}
    rec["cost_method"] = "counted"
    _write(rec, json_path)
    print(f"fixed {json_path}: frac={rec['roofline']['fraction']:.3f} "
          f"dom={rec['roofline']['dominant']}")
    return rec


def run_cell(arch, shape, multi_pod, impl, variant=None, out_path=None,
             overrides=None):
    """One cell: its record printed (memory, flops, roofline) and written
    to ``out_path``.  A step that cannot run on meta is recorded as
    failed, with its reason, and re-raised."""
    t0 = time.perf_counter()
    try:
        cfg = make_cfg(arch, impl, variant, extra=overrides)
        rec = analyze(cfg, shape, impl, multi_pod)
    except Exception as e:
        _write({"arch": arch, "shape": shape, "impl": impl,
                "mesh": _mesh(multi_pod), "failed": f"{type(e).__name__}: "
                f"{e}", "traceback": traceback.format_exc()}, out_path)
        raise
    rec["timings"]["wall_s"] = time.perf_counter() - t0
    print(json.dumps(rec["memory"]))
    print({"flops": rec["flops_per_device"],
           "bytes accessed": rec["hbm_bytes_per_device"]})
    print(json.dumps(rec["roofline"], indent=None))
    _write(rec, out_path)
    return rec


SKIP = {
    # long_500k needs sub-quadratic attention: full-attention archs skip;
    # mamba2 and jamba run it
    ("granite-moe-3b-a800m", "long_500k"),
    ("olmoe-1b-7b", "long_500k"),
    ("seamless-m4t-large-v2", "long_500k"),
    ("chatglm3-6b", "long_500k"),
    ("qwen2.5-14b", "long_500k"),
    ("stablelm-3b", "long_500k"),
    ("phi3-mini-3.8b", "long_500k"),
    ("qwen2-vl-72b", "long_500k"),
}


def run_all(out_dir: str, impls=("dense", "phantom"), multi_pods=(False,),
            archs=None, shapes=None, timeout: int = 3600):
    """Every cell, each in a subprocess (a cell's meta tensors and
    trackers go with its process); cells already written are kept."""
    from repro_torch.configs.base import ARCH_IDS, SHAPES
    os.makedirs(out_dir, exist_ok=True)
    archs = archs or ARCH_IDS
    shapes = shapes or list(SHAPES)
    results = []
    for arch in archs:
        for shape in shapes:
            for impl in impls:
                for mp in multi_pods:
                    tag = f"{arch}_{shape}_{impl}_{'mp' if mp else 'sp'}"
                    out = os.path.join(out_dir, tag + ".json")
                    if (arch, shape) in SKIP:
                        with open(out, "w") as f:
                            json.dump({"arch": arch, "shape": shape,
                                       "impl": impl, "skipped":
                                       "full-attention arch at 500k"}, f)
                        print(f"SKIP {tag}")
                        continue
                    if os.path.exists(out):
                        print(f"CACHED {tag}")
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape,
                           "--impl", impl, "--out", out]
                    if mp:
                        cmd.append("--multi-pod")
                    print(f"RUN {tag}", flush=True)
                    env = dict(os.environ)
                    env["PYTHONPATH"] = (os.path.join(ROOT, "src")
                                         + os.pathsep
                                         + env.get("PYTHONPATH", ""))
                    r = subprocess.run(cmd, capture_output=True, text=True,
                                       timeout=timeout, env=env)
                    if r.returncode != 0:
                        print(f"FAIL {tag}\n{r.stdout[-2000:]}"
                              f"\n{r.stderr[-2000:]}")
                    else:
                        print(r.stdout.strip().splitlines()[-1])
                    results.append((tag, r.returncode))
    return results


def build_parser():
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--shape", default="train_4k",
                    choices=["train_4k", "prefill_32k", "decode_32k",
                             "long_500k"])
    ap.add_argument("--impl", default="phantom",
                    choices=["dense", "phantom"])
    ap.add_argument("--variant", default=None,
                    choices=[None, "faithful", "fused", "ring"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR)
    ap.add_argument("--cost-fix", default=None,
                    help="path to a cell JSON to rewrite with the cell's "
                         "counted costs")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    overrides = parse_sets(getattr(args, "set"))
    if args.cost_fix:
        cost_fix(args.arch, args.shape, args.impl, args.cost_fix,
                 args.variant, overrides=overrides,
                 multi_pod=args.multi_pod)
        return 0
    if args.all:
        run_all(args.out_dir)
        return 0
    run_cell(args.arch, args.shape, args.multi_pod, args.impl,
             args.variant, args.out, overrides=overrides)
    return 0


if __name__ == "__main__":
    sys.exit(main())
