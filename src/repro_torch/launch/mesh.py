"""Ranks and their process groups: the port's counterpart of the
reference's ``launch/mesh.py``.

The reference runs one SPMD program over a ``(pipe, data, model)`` JAX
mesh (``(data, model)`` at pp = 1).  The port starts one process per
rank with ``spawn`` and, inside each, ``make_local_mesh`` builds the
rank's ``MeshAxes``: its coordinates and the tp, dp, pp and world
process groups, rank ``r = (s * dp + d) * tp + t``.  A pp group joins
the ranks of equal ``(d, t)``, one per stage.

Backend: NCCL when every rank has a card of its own
(``torch.cuda.device_count() >= pp * dp * tp``), gloo on the CPU or when
ranks share a card (NCCL refuses two ranks on one device).  Gloo's
groups copy card tensors through the host (``parallel/axes.py: Group``),
so collective times on a shared card measure the host, not NVLink.

Every job of a ``RankPool`` runs observed (``obs/ranks.py``): each rank
traces on the parent's clock origin when the parent traces, and records
its metrics into a registry of its own; the parent merges every rank's
spans under ``pid = rank`` and adds rank 0's metrics to its own.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch

from repro_torch.obs import ranks as obs_ranks
from repro_torch.parallel.axes import Group, MeshAxes, resolve_device


def backend_for(device_type: str, world: int) -> str:
    """NCCL when each of ``world`` ranks has its own card, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def make_local_mesh(dp: int, tp: int, pp: int = 1) -> MeshAxes:
    """This rank's ``MeshAxes`` on an initialised ``pp * dp * tp`` world.
    Every rank makes every group, in the same order, as
    ``torch.distributed.new_group`` requires; a world may hold the groups
    of several meshes of its size, made one after another."""
    import torch.distributed as dist
    world = dist.get_world_size()
    if world != pp * dp * tp:
        raise ValueError(f"world size {world} != pp {pp} x dp {dp} "
                         f"x tp {tp}")
    rank = dist.get_rank()
    s, rest = divmod(rank, dp * tp)
    d, t = divmod(rest, tp)
    backend = dist.get_backend()
    via_host = backend == "gloo"

    def at(ss, dd, tt):
        return (ss * dp + dd) * tp + tt

    def group(ranks: Sequence[int], handle) -> Group:
        return Group(size=len(ranks), rank=list(ranks).index(rank),
                     handle=handle, backend=backend, via_host=via_host,
                     ranks=tuple(ranks))

    def axis_group(size, members):
        """This rank's group along an axis of ``size``; ``members`` lists
        the axis's groups, one per coordinate of the other two axes."""
        mine = Group()
        if size > 1:
            for others in members:
                h = dist.new_group(others)
                if rank in others:
                    mine = group(others, h)
        return mine

    tp_group = axis_group(tp, [[at(ss, dd, tt) for tt in range(tp)]
                               for ss in range(pp) for dd in range(dp)])
    dp_group = axis_group(dp, [[at(ss, dd, tt) for dd in range(dp)]
                               for ss in range(pp) for tt in range(tp)])
    pp_group = axis_group(pp, [[at(ss, dd, tt) for ss in range(pp)]
                               for dd in range(dp) for tt in range(tp)])
    world_group = (group(range(world), None) if world > 1 else Group())
    return MeshAxes(tp=tp, dp=dp, pp=pp, tp_rank=t, dp_rank=d, pp_rank=s,
                    tp_group=tp_group, dp_group=dp_group, pp_group=pp_group,
                    world_group=world_group)


def _rank_main(rank: int, pp: int, dp: int, tp: int, device_type: str,
               init_file: str, timeout_s: float, jobs, results) -> None:
    """One rank of a ``RankPool``: join the world once, then run each
    job the pool sends (a payload file holding ``fn``, its ``args``, the
    job's mesh shape and what its observation needs) until it sends
    None, freeing the job's card memory after each.  A failed job ends
    the rank: its world may be stuck in a collective."""
    import gc
    import torch.distributed as dist
    try:
        world = pp * dp * tp
        backend = backend_for(device_type, world)
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(1)
            device = torch.device("cpu")
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        while True:
            job = jobs.get()
            if job is None:
                break
            with open(job, "rb") as f:
                fn, args, shape, obs = pickle.load(f)
            out = obs_ranks.observed(fn, obs, make_local_mesh(*shape),
                                     device, *args)
            results.put((rank, True, out))
            del out
            gc.collect()
            if device_type == "cuda":
                torch.cuda.empty_cache()
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """``pp * dp * tp`` ranks started once (the ``spawn`` method, never
    fork: the caller may hold CUDA or JAX state) that run jobs in turn:
    ``run(fn, dp, tp, pp)`` calls ``fn(axes, device, *args)`` on every
    rank, ``axes`` a mesh of ``pp' * dp' * tp'`` = the pool's size built
    on the world for that job, and returns the results by rank.  A rank
    starts in seconds (it imports torch), so a caller that runs several
    meshes of one size pays it once; each job's card memory goes back to
    the card before the next.  ``fn`` must be importable (a module-level
    function) and return picklable values (numpy arrays, not tensors).
    On a job's first failed rank or past its timeout every rank is
    killed and the call raises, so a mismatched collective fails within
    the timeout instead of hanging.  ``fn`` and ``args`` reach the
    ranks through a file in the pool's temporary directory: through a
    rank's start-up pipe, arguments past the pipe's 64 KB would hold
    each start until the rank before it had imported torch and read
    them.  Each job's spans and rank 0's metrics join the caller's
    (``obs/ranks.py: merge``); every rank's metrics of the last job are
    ``rank_metrics``."""

    def __init__(self, dp: int, tp: int, device=None, pp: int = 1,
                 timeout_s: float = 3600.0):
        import torch.multiprocessing as mp
        dev = resolve_device(device)
        self.world = pp * dp * tp
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
        self._results = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in range(self.world)]
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, pp, dp, tp, dev.type,
                                         f"{self._tmp}/init", timeout_s,
                                         self._jobs[r], self._results))
                       for r in range(self.world)]
        self._count = 0
        self.rank_metrics: List[list] = []
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.close()
            raise

    def run(self, fn: Callable, dp: int, tp: int, args: tuple = (),
            pp: int = 1, timeout_s: float = 600.0) -> List[Any]:
        if pp * dp * tp != self.world:
            raise ValueError(f"a job of pp {pp} x dp {dp} x tp {tp} on a "
                             f"pool of {self.world} ranks")
        self._count += 1
        payload = f"{self._tmp}/job{self._count}"
        with open(payload, "wb") as f:
            pickle.dump((fn, args, (dp, tp, pp), obs_ranks.rank_spec()), f)
        for q in self._jobs:
            q.put(payload)
        out = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < self.world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{self.world - len(out)} of {self.world} ranks "
                        f"gave no result within {timeout_s:.0f} s")
                try:
                    rank, ok, result = self._results.get(
                        timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if p.exitcode is not None and r not in out]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{self._procs[dead[0]].exitcode}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{result}")
                out[rank] = result
        except BaseException:
            self.close(kill=True)
            raise
        os.remove(payload)
        seen = [out[r][1] for r in range(self.world)]
        self.rank_metrics = [s["metrics"] for s in seen]
        obs_ranks.merge(seen)
        return [out[r][0] for r in range(self.world)]

    def close(self, kill: bool = False, timeout_s: float = 60.0):
        """Stop the ranks (``kill``: at once) and remove the pool's
        files."""
        if not kill:
            for q in self._jobs:
                q.put(None)
        deadline = time.monotonic() + timeout_s
        for p in self._procs:
            if not kill and p.is_alive():
                p.join(timeout=max(deadline - time.monotonic(), 0.1))
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(kill=exc_type is not None)
        return False


def spawn(fn: Callable, dp: int, tp: int, device=None, args: tuple = (),
          timeout_s: float = 600.0, pp: int = 1) -> List[Any]:
    """Run ``fn(axes, device, *args)`` on ``pp * dp * tp`` new ranks and
    return their results, ordered by rank: one job of a ``RankPool``,
    whose ranks stop once it returns (a rank must flush what it writes
    before it returns).  ``device`` is the card unless the caller asks
    for the CPU; ``timeout_s`` bounds the ranks' start and the job."""
    with RankPool(dp, tp, device, pp=pp, timeout_s=timeout_s) as pool:
        return pool.run(fn, dp, tp, args, pp=pp, timeout_s=timeout_s)
