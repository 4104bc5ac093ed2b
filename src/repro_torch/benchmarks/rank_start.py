"""What a world of ranks costs to start: ``launch/mesh.py: spawn`` (new
ranks for every job) against one ``RankPool`` that runs the jobs in turn.

The job imports the trainer's modules, touches the device and
all-reduces once over the world: what any job of ``chip_smoke.py``'s
4-rank phases pays before its own work.  Two rounds, each of two spawns
then one pool running three jobs, so both sides run early and late in
the call:

    PYTHONPATH=src python -m repro_torch.benchmarks.rank_start --device cpu
    PYTHONPATH=src python -m repro_torch.benchmarks.rank_start   # the card

prints each spawn's wall seconds, each pool job's and the pool's in all
(its start, three jobs and its close).
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.launch.mesh import RankPool, spawn
from repro_torch.parallel.axes import resolve_device


def job(axes, device):
    """The trainer's imports, one tensor on the device, one all-reduce."""
    import torch
    import repro_torch.launch.train  # noqa: F401
    x = torch.ones(1024, device=device)
    axes.world_comm.all_reduce(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return float(x[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks.rank_start",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for rnd in range(args.rounds):
        for _ in range(2):
            t0 = time.perf_counter()
            spawn(job, 1, args.ranks, device)
            print(f"round {rnd}: spawn {time.perf_counter() - t0:.2f} s",
                  flush=True)
        t0 = time.perf_counter()
        with RankPool(1, args.ranks, device) as pool:
            for i in range(3):
                t1 = time.perf_counter()
                pool.run(job, 1, args.ranks)
                print(f"round {rnd}: pool job {i} "
                      f"{time.perf_counter() - t1:.2f} s", flush=True)
        print(f"round {rnd}: pool with 3 jobs "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
