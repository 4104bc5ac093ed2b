"""Train an LM of the dense, MoE, SSM or hybrid family, or run the
elastic paper-FFN runtime (``--elastic``): the port's counterpart of the
reference's ``python -m repro.launch.train``.  Like the reference's, the
LM path feeds
``LMDataset`` batches of tokens and labels only, so it cannot train the
vision-language and encoder-decoder families (qwen2-vl-72b needs M-RoPE
``positions``, seamless-m4t-large-v2 the encoder's ``frames``): for
those it raises (ROADMAP.md queue 3); ``make_trainer`` takes a dataset
that carries them.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke \\
        --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --smoke \\
        --device cpu --tp 2                 # 2 gloo ranks
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi3-mini-3.8b --full --kernel-backend auto --tp 4 \\
        --batch 4 --seq 512 --steps 5       # on the card
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen2.5-14b --device cpu --tp 2   # ring attention
    PYTHONPATH=src python -m repro_torch.launch.train --smoke \\
        --device cpu --pp 2 --tp 2 --microbatches 2   # 1F1B, 4 ranks
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch olmoe-1b-7b --device cpu --tp 2 --steps 2   # MoE
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mamba2-370m --device cpu --tp 2 --steps 2   # SSM
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch jamba-1.5-large-398b --smoke --device cpu --tp 2   # hybrid

builds ``Trainer(cfg, axes, make_optimizer(cfg.optimizer,
warmup_cosine(3e-4, 20, steps), weight_decay=0.1), LMDataset(...))``
and runs ``--steps`` steps on ``--batch`` sequences of ``--seq``
tokens, logging the ``[trainer]`` line.  Weights are random, drawn on
the device from ``--seed``, each rank keeping its shards.  ``--pp`` x
``--dp`` x ``--tp`` above 1 spawns that many ranks (``launch/mesh.py:
spawn``, rank ``(s * dp + d) * tp + t``), each on its rows of the batch
and its shards of the model: ``--impl phantom`` (the default) keeps the
residual stream feature-sharded (``fp``), ``--impl dense`` runs the
Megatron sequence-parallel baseline (``sp``).  A config with
``attn_shard="ring"`` (qwen2.5-14b, granite-moe-3b-a800m), or a ``--tp``
that does not divide the heads, runs ring attention.  The MoE configs
(olmoe-1b-7b: experts over all-to-all; granite-moe-3b-a800m: each
expert's d_ff sharded) add their balance loss to the objective;
mamba2-370m runs its SSD blocks, their in and out projections phantom
(``fp``) or dense (``sp``); jamba-1.5-large-398b its superblocks of
attention, SSD, MLP and MoE blocks, with Adafactor, FSDP and bf16
parameters as its config sets them.  FSDP has no flag, as in the
reference: a config that sets ``fsdp=True`` brings it.  ``--microbatches``
is the launcher's (default 1), not the config's ``microbatches``.
``--pp`` above 1 cuts the layers into that many stages and runs the
1F1B pipeline over ``--microbatches`` microbatches.  The run is on the
card unless ``--device cpu`` is given; ``--smoke`` (the default) takes
the config's reduced geometry, ``--full`` the published one.
``--ckpt-dir DIR`` gives the trainer a checkpoint directory at its
default cadence of 100 steps: the run resumes from the latest
checkpoint there (``[trainer] restored step N``) and saves on the way
(each rank its own blocks of the global arrays).

``--elastic`` runs the elastic fault-tolerant paper-FFN runtime instead
(``train/elastic.py: run_elastic``): a simulated cluster of ``--hosts``
hosts over ``--devices`` devices, asynchronous checkpoints every
``--ckpt-every`` steps, heartbeat failure detection and energy-aware
re-planning of dp x tp x k over the survivors, each phase's ranks on
the card unless ``--device cpu`` is given; ``--kill-at-step N
[--kill-host hostK]`` injects a host loss:

    PYTHONPATH=src python -m repro_torch.launch.train --elastic \
        --device cpu --kill-at-step 25

It must survive the loss, restore and reach ``--target-loss``; the exit
code says whether it did.  The re-plan's static audit gate is off (its
torch counterpart is ROADMAP.md queue 1, item 8 part 4), and the run
says so.  The report and its ledger go under ``build/`` (a repo-root
path raises: the reference's ``BENCH_report.json`` is there).  The run
is watched by the energy-drift watchdog (``obs/watchdog.py``), which
prints its ``[obs] watchdog:`` line; ``--slow-step N`` (repeatable)
injects a step ``--slow-factor`` times slower for it to trip on, and
its profiler capture goes to ``--profile-dir`` (default
``<workdir>/profile`` when a slow step is given).

Observability on either path: ``--trace-out PATH`` writes the run's
Chrome trace (every rank's spans under its own pid, one clock origin:
open it in https://ui.perfetto.dev), ``--metrics-out PATH`` its metrics
(Prometheus text, or one JSONL snapshot appended for a ``.jsonl``
path; rank 0's counts), and on the LM path ``--profile-dir DIR`` gives
every rank's trainer a watchdog whose trip captures the next step with
``torch.profiler`` (``DIR/rank{r}.json``):

    PYTHONPATH=src python -m repro_torch.launch.train --smoke \
        --device cpu --tp 2 --steps 4 --trace-out build/trace.json \
        --metrics-out build/metrics.prom
    PYTHONPATH=src python -m repro_torch.launch.obs summary \
        --trace build/trace.json

``--plan PATH`` applies the winning plan of a plan report
(``launch/plan.py``; ``--plan auto`` reads ``build/PLAN_report.json``,
running a quick calibrated no-pilot planning pass over the ``--dp`` x
``--tp`` device budget into it when there is none): the winner's
projection spec becomes the config's default projection for every site,
and the mesh becomes the winner's (dp, tp, pp), which ``--dp`` x
``--tp`` x ``--pp`` must cover; ``--kernel-backend`` then applies on
top:

    PYTHONPATH=src python -m repro_torch.launch.plan --device cpu \\
        --width 512 --ks 4,8 --pilot-steps 80 --target-loss 0.25
    PYTHONPATH=src python -m repro_torch.launch.train --smoke \\
        --device cpu --plan build/PLAN_report.json --tp 2 --steps 2

``--overlap`` (ROADMAP.md queue 1, item 8 part 4) raises.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.configs.base import (PROJECTION_SITES, dense_projection_map,
                                      get_config, with_kernel_backend)
from repro_torch.data.synthetic import LMDataset
from repro_torch.kernels import build
from repro_torch.kernels.ops import KERNEL_BACKENDS, resolve_kernel_backend
from repro_torch.launch.mesh import spawn
from repro_torch.launch.obs import add_obs_args, obs_session
from repro_torch.models.model import count_params
from repro_torch.obs import EnergyDriftWatchdog
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.parallel.axes import MeshAxes, resolve_device
from repro_torch.train.trainer import Trainer

TIMEOUT_S = 3600.0     # a multi-rank run, before its ranks are killed
OPERATIONS_TODO = "ROADMAP.md queue 1, item 8"
DEFAULT_ELASTIC_REPORT = "elastic_report.json"     # under build/
# the families whose batches need more than LMDataset's tokens and labels
STUBBED_FAMILIES = ("vlm", "encdec")


def require_lm_batches(cfg):
    """Raise for a config whose batches ``LMDataset`` cannot make."""
    if cfg.family in STUBBED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family trains on batches with "
            f"its frontend's stubs (positions, vision_embeds or frames), "
            f"which LMDataset does not make; the reference's launcher has "
            f"the same gap (ROADMAP.md queue 3).  Train it through "
            f"make_trainer(..., dataset=...) with such batches")


class _Parser(argparse.ArgumentParser):
    """``--steps`` and ``--batch`` default by path, as the reference's
    launcher's do: 100 and 8 for the LM, 300 and 32 with ``--elastic``."""

    def parse_args(self, args=None, namespace=None):
        out = super().parse_args(args, namespace)
        if out.steps is None:
            out.steps = 300 if out.elastic else 100
        if out.batch is None:
            out.batch = 32 if out.elastic else 8
        return out


def build_parser():
    ap = _Parser(prog="repro_torch.launch.train",
                 description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--impl", default="phantom",
                    choices=["dense", "phantom"])
    ap.add_argument("--steps", type=int, default=None,
                    help="train steps (default 100; 300 with --elastic)")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default 8; 32 with --elastic)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--kernel-backend", default=None,
                    choices=KERNEL_BACKENDS,
                    help="the attention core's backend (default: the "
                         "config's per-site specs)")
    ap.add_argument("--seed", type=int, default=0, help="weight seed")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from and save checkpoints here")
    el = ap.add_argument_group("elastic fault-tolerant paper-FFN runtime")
    el.add_argument("--elastic", action="store_true")
    el.add_argument("--devices", type=int, default=8,
                    help="total device budget")
    el.add_argument("--hosts", type=int, default=4,
                    help="simulated hosts (devices %% hosts == 0)")
    el.add_argument("--kill-at-step", type=int, action="append",
                    default=None, metavar="N",
                    help="inject a host loss at step N (repeatable)")
    el.add_argument("--kill-host", action="append", default=None,
                    metavar="HOST",
                    help="which host dies at the matching --kill-at-step "
                         "(default hostH, the last first)")
    el.add_argument("--target-loss", type=float, default=0.12,
                    help="stop when the teacher loss reaches this")
    el.add_argument("--width", type=int, default=64,
                    help="paper-FFN width")
    el.add_argument("--depth", type=int, default=2,
                    help="paper-FFN depth")
    el.add_argument("--ckpt-every", type=int, default=10,
                    help="checkpoint cadence (steps)")
    el.add_argument("--workdir", default=None,
                    help="checkpoint and heartbeat directory (default: a "
                         "temporary directory)")
    el.add_argument("--report-out", default=None,
                    help="the ledger report (default build/"
                         f"{DEFAULT_ELASTIC_REPORT}; the repo root "
                         "raises)")
    ap.add_argument("--plan", default=None, metavar="auto|PATH",
                    help="apply the winning plan of a plan report "
                         "(auto: build/PLAN_report.json, planned without "
                         "pilots when absent)")
    add_obs_args(ap)
    ap.add_argument("--slow-step", type=int, action="append",
                    default=None, metavar="N",
                    help="[elastic] inject a watchdog-visible slow step "
                         "at step N (repeatable)")
    ap.add_argument("--slow-factor", type=float, default=6.0,
                    help="[elastic] slowdown factor for --slow-step")
    ap.add_argument("--profile-dir", default=None,
                    help="watchdog torch.profiler capture dir (default: "
                         "<workdir>/profile when --slow-step is given)")
    todo = ap.add_argument_group(f"not ported ({OPERATIONS_TODO}): "
                                 "these raise")
    todo.add_argument("--overlap", default=None)
    return ap


def refuse_unported(args):
    """Raise for a flag of the reference's launcher whose part of
    ROADMAP.md queue 1 item 8 is not ported."""
    if args.overlap is not None:
        raise NotImplementedError(
            f"--overlap is not ported yet ({OPERATIONS_TODO} part 4: the "
            f"overlap of queue 2 item 8)")


def _apply_plan(args, cfg):
    """Resolve ``--plan`` (auto | path) to a winner and apply it: returns
    the config with the winner's projections and its (dp, tp, pp)."""
    import repro_torch.launch.plan as plan_cli
    from repro_torch.configs.base import (PHANTOM_KINDS, ProjectionMap,
                                          ProjectionSpec)
    from repro_torch.planner import load_plan_report

    path = plan_cli.DEFAULT_OUT if args.plan == "auto" else args.plan
    if os.path.exists(path):
        report = load_plan_report(path)
        print(f"[plan] loaded {path}")
    elif args.plan == "auto":
        pargs = plan_cli.build_parser().parse_args(
            ["--devices", str(args.dp * args.tp), "--no-pilots",
             "--out", path])
        report = plan_cli.plan(pargs)
        print("[plan] no report found: ran a no-pilot planning pass")
    else:
        raise FileNotFoundError(f"--plan {args.plan}: no such report")
    winner = report.get("winner")
    if not winner:
        raise ValueError(f"{path}: empty frontier, no winning plan")
    p = winner["plan"]
    budget = args.dp * args.tp * max(args.pp, 1)
    if p["devices"] > budget:
        # training a smaller mesh than the winner's would train another
        # configuration than the one just announced
        raise ValueError(
            f"winning plan {p['name']} needs {p['devices']} devices but "
            f"--dp {args.dp} x --tp {args.tp} x --pp {args.pp} only "
            f"provisioned {budget}; re-run with --dp/--tp/--pp covering "
            f"the plan's mesh ({p['dp']}x{p['tp']}x{p.get('pp', 1)}pp)")
    spec = p.get("projection_spec", {})
    kind = spec.get("kind", p.get("strategy", "tensor"))
    if kind in PHANTOM_KINDS:
        default = ProjectionSpec(kind=kind, k=int(spec.get("k", 64)),
                                 variant=spec.get("variant", "fused"))
        applied = f"{kind} k={default.k}"
    else:
        # any tensor-family winner means "dense TP": the planner scored
        # one square FFN site, while an architecture mixes input-side
        # (column) and output-side (row) projections; the ``tensor``
        # pseudo-kind resolves each site to its natural dense sharding
        default = ProjectionSpec(kind="tensor")
        applied = f"{kind} -> site-natural dense sharding"
    cfg = cfg.replace(projections=ProjectionMap(default=default))
    pp = int(p.get("pp", 1))
    print(f"[plan] applying winner {p['name']}: projections default="
          f"{applied}, mesh {p['dp']}x{p['tp']}"
          + (f"x{pp}pp" if pp > 1 else ""))
    return cfg, p["dp"], p["tp"], pp


def train_config(args):
    """The arch's config as the flags select it; ``--plan`` also sets
    ``args.dp``, ``args.tp`` and ``args.pp`` to the winner's mesh."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.plan:
        cfg, args.dp, args.tp, args.pp = _apply_plan(args, cfg)
    elif args.impl == "dense":
        cfg = cfg.replace(projections=dense_projection_map())
    if args.kernel_backend:
        cfg = with_kernel_backend(cfg, args.kernel_backend)
    return cfg


def make_trainer(axes, device, cfg, args, dataset=None) -> Trainer:
    """One rank's ``Trainer``: the reference's optimizer and schedule,
    ``dataset`` or ``LMDataset`` batches of ``--seq`` tokens, the log on
    rank 0, and with ``--profile-dir`` the energy-drift watchdog."""
    opt = make_optimizer(cfg.optimizer, warmup_cosine(3e-4, 20, args.steps),
                         weight_decay=0.1)
    if dataset is None:
        require_lm_batches(cfg)
        dataset = LMDataset(cfg.vocab_size, args.batch, args.seq + 1,
                            device=device)
    watchdog = (EnergyDriftWatchdog(profile_dir=args.profile_dir,
                                    name=f"train_{cfg.name}",
                                    arch=cfg.name)
                if args.profile_dir else None)
    return Trainer(cfg, axes, opt, dataset, microbatches=args.microbatches,
                   checkpoint_dir=args.ckpt_dir,
                   log_every=min(10, args.steps),
                   log_fn=print if axes.rank == 0 else (lambda _m: None),
                   watchdog=watchdog, device=device)


def train_rank(axes, device, cfg, args):
    """One rank's run, from the latest checkpoint in ``--ckpt-dir`` if
    there is one; returns the per-step metrics and step times."""
    trainer = make_trainer(axes, device, cfg, args)
    trainer.run(trainer.restore_or_init(args.seed), args.steps)
    return {"history": trainer.history, "step_us": trainer.meter.times_us}


def run_elastic_cli(args) -> int:
    """The ``--elastic`` entry point: the paper-FFN elastic run with
    scripted host losses; returns the exit code (0 iff the run survived
    its faults and reached ``--target-loss``)."""
    from repro_torch.launch.serve import refuse_repo_root
    from repro_torch.telemetry import Ledger
    from repro_torch.telemetry.ledger import REPORT_DIR
    from repro_torch.train.elastic import ElasticConfig, run_elastic
    from repro_torch.train.fault import FaultScript

    report_out = args.report_out or str(REPORT_DIR / DEFAULT_ELASTIC_REPORT)
    refuse_repo_root(report_out, "--report-out")
    jsonl = os.path.join(os.path.dirname(os.path.abspath(report_out)),
                         "elastic_ledger.jsonl")
    kills = []
    names = args.kill_host or []
    for i, s in enumerate(args.kill_at_step or []):
        # unnamed kills take the highest-numbered hosts first
        kills.append((s, names[i] if i < len(names)
                      else f"host{args.hosts - 1 - i}"))
    cfg = ElasticConfig(
        workdir=args.workdir or tempfile.mkdtemp(prefix="elastic_"),
        devices=args.devices, hosts=args.hosts, width=args.width,
        depth=args.depth, batch=args.batch, target_loss=args.target_loss,
        max_steps=args.steps, checkpoint_every=args.ckpt_every,
        seed=args.seed, slow_steps=tuple(args.slow_step or ()),
        slow_factor=args.slow_factor)
    print(f"[elastic] static audit gate off: the re-plan audit is not "
          f"ported ({OPERATIONS_TODO} part 4)", flush=True)
    ledger = Ledger(run="launch.train.elastic", jsonl_path=jsonl)
    profile_dir = args.profile_dir
    if profile_dir is None and cfg.slow_steps:
        profile_dir = os.path.join(cfg.workdir, "profile")
    watchdog = EnergyDriftWatchdog(
        ledger=ledger, profile_dir=profile_dir,
        name=f"elastic_ffn{cfg.width}", arch=f"ffn{cfg.width}")
    res = run_elastic(cfg, ledger=ledger, watchdog=watchdog,
                      device=args.device,
                      fault_script=FaultScript(kills=tuple(kills)))
    ledger.write_report(report_out)
    acct = res.account
    print(f"[elastic] report -> {report_out}")
    print(f"[elastic] energy_j_total {acct['energy_j_total']:.3e} "
          f"(useful {acct['energy_j_useful']:.3e}, "
          f"replay {acct['energy_j_replay']:.3e}, "
          f"ckpt_io {acct['energy_j_ckpt_io']:.3e}, "
          f"restart {acct['energy_j_restart']:.3e}); "
          f"replay_overhead {acct['replay_overhead_ratio']:.3f}")
    wd = watchdog.summary()
    print(f"[obs] watchdog: {len(wd['trips'])} trip(s) over "
          f"{wd['observations']} observation(s)"
          + (f", profiler capture -> {wd['captures'][-1]}"
             if wd["captures"] else ""))
    if res.aborted:
        print("[elastic] FAILED: run aborted")
        return 2
    if not res.reached_target:
        print(f"[elastic] FAILED: final loss {res.final_loss:.4f} > "
              f"target {cfg.target_loss}")
        return 1
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    if args.elastic:
        with obs_session(args.trace_out, args.metrics_out,
                         meta={"run": "launch.train.elastic"}):
            return run_elastic_cli(args)
    cfg = train_config(args)
    require_lm_batches(cfg)
    device = resolve_device(args.device)
    print(f"# {cfg.name} impl={args.impl} dp={args.dp} on {device} "
          f"(tp={args.tp}, kernel_backend={args.kernel_backend or 'config'}): "
          f"{count_params(cfg, args.tp):,} params, batch {args.batch} x "
          f"seq {args.seq}", flush=True)
    if args.pp > 1:
        print(f"[train] 1F1B pipeline: pp={args.pp} stages x dp={args.dp} "
              f"x tp={args.tp}, {args.microbatches} microbatch(es)",
              flush=True)
    if device.type == "cuda" and any(
            resolve_kernel_backend(cfg.projection_spec(s).kernel_backend)
            == "pallas" for s in PROJECTION_SITES):
        build.build(build.KERNELS)   # once, before any rank loads them
    with obs_session(args.trace_out, args.metrics_out,
                     meta={"run": "launch.train", "arch": args.arch}):
        if args.pp * args.dp * args.tp == 1:
            train_rank(MeshAxes(), device, cfg, args)
        else:
            spawn(train_rank, args.dp, args.tp, device, args=(cfg, args),
                  timeout_s=TIMEOUT_S, pp=args.pp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
