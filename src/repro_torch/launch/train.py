"""Train an LM of the dense, MoE, SSM or hybrid family: the port's
counterpart of the reference's ``python -m repro.launch.train`` (its
non-elastic path without a plan).  Like the reference's, it feeds
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
``--plan``, ``--elastic`` and ``--ckpt-dir`` are ROADMAP.md queue 1,
item 8.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs.base import (PROJECTION_SITES, dense_projection_map,
                                      get_config, with_kernel_backend)
from repro_torch.data.synthetic import LMDataset
from repro_torch.kernels import build
from repro_torch.kernels.ops import KERNEL_BACKENDS, resolve_kernel_backend
from repro_torch.launch.mesh import spawn
from repro_torch.models.model import count_params
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.parallel.axes import MeshAxes, resolve_device
from repro_torch.train.trainer import Trainer

TIMEOUT_S = 3600.0     # a multi-rank run, before its ranks are killed
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


def build_parser():
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--impl", default="phantom",
                    choices=["dense", "phantom"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
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
    return ap


def train_config(args):
    """The arch's config as the flags select it."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.impl == "dense":
        cfg = cfg.replace(projections=dense_projection_map())
    if args.kernel_backend:
        cfg = with_kernel_backend(cfg, args.kernel_backend)
    return cfg


def make_trainer(axes, device, cfg, args, dataset=None) -> Trainer:
    """One rank's ``Trainer``: the reference's optimizer and schedule,
    ``dataset`` or ``LMDataset`` batches of ``--seq`` tokens, the log on
    rank 0."""
    opt = make_optimizer(cfg.optimizer, warmup_cosine(3e-4, 20, args.steps),
                         weight_decay=0.1)
    if dataset is None:
        require_lm_batches(cfg)
        dataset = LMDataset(cfg.vocab_size, args.batch, args.seq + 1,
                            device=device)
    return Trainer(cfg, axes, opt, dataset, microbatches=args.microbatches,
                   log_every=min(10, args.steps),
                   log_fn=print if axes.rank == 0 else (lambda _m: None),
                   device=device)


def train_rank(axes, device, cfg, args):
    """One rank's run; returns the per-step metrics and step times."""
    trainer = make_trainer(axes, device, cfg, args)
    trainer.run(trainer.init_state(args.seed), args.steps)
    return {"history": trainer.history, "step_us": trainer.meter.times_us}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
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
    if args.pp * args.dp * args.tp == 1:
        train_rank(MeshAxes(), device, cfg, args)
    else:
        spawn(train_rank, args.dp, args.tp, device, args=(cfg, args),
              timeout_s=TIMEOUT_S, pp=args.pp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
