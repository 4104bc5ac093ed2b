"""Serving launcher of the port: a closed batch of equal prompts through
``ServeEngine`` on one device, with the TTFT/TPOT report.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \
      --requests 8                        # on the card, full size
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --requests 8                        # MoE, on the card, full size
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --requests 8                        # SSM, exact-length groups
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch jamba-1.5-large-398b --smoke --device cpu   # hybrid
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen2-vl-72b --smoke --device cpu           # vision-language
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-large-v2 --smoke --device cpu  # encoder-decoder

The engine adds the stubbed frontends' inputs to every prefill (zero
vision embeddings and M-RoPE positions, or zero frames), as the
reference's does.

Weights are random, drawn from ``--seed``.  ``--dp``/``--tp`` above 1
raise until the collectives slice; the reference's ``--route auto``,
``--trace``, ledger and fleet modes arrive with later slices.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs.base import get_config, with_kernel_backend
from repro_torch.kernels.ops import KERNEL_BACKENDS
from repro_torch.models.model import model_decls
from repro_torch.parallel.axes import MeshAxes, resolve_device
from repro_torch.parallel.params import materialize
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import bucket_of

PROMPT_LEN = 16


def build_parser():
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="continuous-batching serving on one device")
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0,
                    help="weight and prompt seed")
    ap.add_argument("--kernel-backend", default="auto",
                    choices=KERNEL_BACKENDS)
    ap.add_argument("--device", default=None,
                    help="default: the card ('cuda'); 'cpu' runs the "
                         "plain torch path")
    return ap


def closed_batch(vocab_size: int, n: int, prompt_len: int,
                 new_tokens: int, seed: int) -> list:
    """``n`` requests of ``prompt_len`` random tokens, all arriving at 0."""
    rng = np.random.RandomState(seed)
    return [Request(prompt=rng.randint(0, vocab_size, prompt_len)
                    .astype(np.int32), max_new_tokens=new_tokens, req_id=i)
            for i in range(n)]


def _pcts(xs) -> dict:
    if not xs:
        return {}
    a = np.asarray(xs)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99))}


def slo_report(requests) -> dict:
    """TTFT, TPOT and end-to-end percentiles (ms) and output tokens per
    second, on the engine's virtual clock."""
    done = [r for r in requests if r.t_done_s is not None]
    ttft = [(r.t_first_s - r.arrival_s) * 1e3 for r in done]
    tpot = [(r.t_done_s - r.t_first_s) * 1e3 / (len(r.out_tokens) - 1)
            for r in done if len(r.out_tokens) > 1]
    e2e = [(r.t_done_s - r.arrival_s) * 1e3 for r in done]
    tokens = sum(len(r.out_tokens) for r in done)
    span = (max(r.t_done_s for r in done)
            - min(r.arrival_s for r in done)) if done else 0.0
    return {"requests": len(done), "generated_tokens": tokens,
            "tokens_per_s": tokens / span if span > 0 else 0.0,
            "ttft_ms": _pcts(ttft), "tpot_ms": _pcts(tpot),
            "e2e_ms": _pcts(e2e)}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    axes = MeshAxes(tp=args.tp, dp=args.dp)
    device = resolve_device(args.device)
    cfg = with_kernel_backend(get_config(args.arch, smoke=args.smoke),
                              args.kernel_backend)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    eng = ServeEngine(cfg, materialize(model_decls(cfg, axes), gen, device),
                      slots=args.slots, max_len=args.max_len,
                      page_size=args.page_size, axes=axes, device=device)
    eng.warmup([bucket_of(PROMPT_LEN, args.page_size)])
    reqs = closed_batch(cfg.vocab_size, args.requests, PROMPT_LEN,
                        args.new_tokens, args.seed)
    eng.run(reqs)
    rep = slo_report(reqs)
    print(f"# served {cfg.name} on {device} "
          f"(kernel_backend={args.kernel_backend})")
    for key in ("ttft_ms", "tpot_ms", "e2e_ms"):
        pc = rep[key]
        if pc:
            print(f"{key:8s} p50={pc['p50']:9.3f}  p95={pc['p95']:9.3f}  "
                  f"p99={pc['p99']:9.3f}  (ms)")
    print(f"requests={rep['requests']} tokens={rep['generated_tokens']} "
          f"tokens/s={rep['tokens_per_s']:.1f}")
    pages = eng.pages.stats()
    print(f"pages: high_water={pages['high_water_pages']}"
          f"/{pages['total_pages']} allocs={pages['page_allocs']} "
          f"frees={pages['page_frees']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
