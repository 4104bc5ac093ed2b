"""Checkpointing: sharded, asynchronous, elastic; the port of the
reference's ``train/checkpoint.py``, with ranks as processes.

* **The reference's layout on disk.**  A step directory holds one
  ``.npy`` of the GLOBAL array per leaf (``leaf_00000.npy`` ... in the
  sorted order of the ``/``-joined tree paths) and ``index.json`` with
  the step, each path's file, global shape and dtype, and the caller's
  ``meta`` (the elastic runtime stores the executing plan there).  A
  checkpoint written by either package loads in the other.  bfloat16
  leaves, which numpy cannot hold, are stored as their 16-bit patterns
  (``int16``) under the dtype name ``bfloat16``.
* **Ranks write their own blocks, no bytes on the wire.**  Rank 0
  creates each leaf's global file (``np.lib.format.open_memmap``) and
  drops ``CREATED``; every rank writes the blocks it owns into them
  (``parallel/params.py: _block``; ``os.pwrite`` of each block's runs of
  contiguous elements), one writer per distinct block: the
  rank at coordinate 0 of every mesh axis the leaf's spec does not
  shard (dp 0 for a dp-replicated leaf), then drops a done-marker.
  Rank 0's writer waits for every marker and commits.  The commit is
  coordinated through files only: no collective runs on the writer
  thread, where it could interleave with the step's.
* **Asynchronous.**  ``save_async`` copies the rank's shards to the
  host on the caller's thread before it returns (the optimizers update
  parameters and moments in place: a queued reference would write what
  the next step left in them), then queues the write on one serial
  background writer; ``flush()`` (``wait()``) joins every queued write
  and, on every rank, its commit.  An exit hook flushes every live
  manager; a rank that ``launch/mesh.py: spawn`` kills once it returns
  must flush first (``Trainer.run`` does, in a ``finally``).
* **Atomic commits and the ``latest`` invariant.**  A save writes
  ``step_N.tmp``, places ``COMMITTED`` last, renames the directory, and
  only then moves the ``latest`` pointer, so ``latest`` always names a
  complete checkpoint.  Only rank 0 sweeps orphans, collects garbage
  (the newest ``keep``, never ``latest``'s target) and moves ``latest``.
* **Elastic restore.**  The blobs hold GLOBAL arrays, so a restore cuts
  any rank's shards on any mesh from ``np.load(..., mmap_mode="r")``:
  ranks sharing a host never hold a global tree each.
  ``restore_latest`` falls back past a corrupt checkpoint.
  ``invalidate_after`` drops an abandoned timeline.
* **State saved per rank.**  Adafactor's factored moments are means over
  a rank's local leaf (ROADMAP.md queue 3), so ``per_rank`` leaves are
  stored as ``[ranks, ...]`` with the mesh in the index; restoring them
  onto another mesh raises.
* **IO accounting.**  ``io_stats()``: this rank's write seconds (rank 0's
  run to the commit), the bytes of the blocks it wrote (summed over the
  ranks: the checkpoints' global bytes) and the saves it took part in.
  The reference's observability: a ``ckpt/save`` span on the writer
  thread (its own trace row), ``ckpt_saves_total``, ``ckpt_bytes_total``
  (this rank's blocks) and ``ckpt_write_seconds`` per save, and a
  ``ckpt/restore`` span around ``restore``.
"""
from __future__ import annotations

import atexit
import json
import os
import queue
import shutil
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import get_metrics, get_tracer
from repro_torch.parallel.params import (_block, _coords, tree_leaves,
                                         tree_unflatten)

_LATEST = "latest"
_CREATED = "CREATED"
WAIT_S = 1800.0      # how long a writer waits for the other ranks
_POLL_S = 0.005
_AXES = ("tp", "dp", "pp")


def _step_dir(root: str, step: int, tmp: bool = False) -> str:
    return os.path.join(root, f"step_{step:010d}" + (".tmp" if tmp
                                                     else ""))


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that nothing else writes to."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.array(leaf)


def _dtype_name(leaf) -> str:
    if not isinstance(leaf, torch.Tensor):
        return str(np.asarray(leaf).dtype)
    if leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)


def _stored_dtype(name: str):
    return np.int16 if name == "bfloat16" else np.dtype(name)


def _tensor(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    if dtype_name == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(device)


def _data_offset(path: str) -> int:
    """Where a ``.npy`` file's data starts (after its header)."""
    with open(path, "rb") as f:
        major, _ = np.lib.format.read_magic(f)
        (np.lib.format.read_array_header_1_0 if major == 1
         else np.lib.format.read_array_header_2_0)(f)
        return f.tell()


def _write_block(fd: int, offset: int, shape: tuple, idx, arr: np.ndarray):
    """Write ``arr``, the block ``idx`` of a C-ordered array of global
    ``shape`` whose data starts at byte ``offset`` of ``fd``: one
    ``os.pwrite`` per run of contiguous elements (through a memory map,
    every page's first touch faults, 3-4x slower)."""
    bounds = []
    for d, n in enumerate(shape):
        i = idx[d] if d < len(idx) else slice(0, n)
        bounds.append((i, i + 1) if isinstance(i, int)
                      else (i.start or 0, n if i.stop is None else i.stop))
    k = len(shape)             # dims k.. are whole in the block
    while k > 0 and bounds[k - 1] == (0, shape[k - 1]):
        k -= 1
    strides = np.cumprod((1,) + tuple(shape[::-1]))[:-1][::-1]
    if k == 0:
        starts = np.zeros(1, np.int64)
    else:
        lead = [np.arange(a, b) for a, b in bounds[:k - 1]]
        grid = np.meshgrid(*lead, indexing="ij") if lead else []
        starts = bounds[k - 1][0] * strides[k - 1] + sum(
            (g.reshape(-1) * strides[d] for d, g in enumerate(grid)),
            np.zeros(1, np.int64))
    rows = np.ascontiguousarray(arr).reshape(len(starts), -1)
    for start, row in zip(starts.tolist(), rows):
        os.pwrite(fd, row.data, offset + start * arr.itemsize)


def _wait(cond, what: str, timeout_s: float):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint: waited {timeout_s:.0f} s for "
                               f"{what}")
        time.sleep(_POLL_S)


@dataclass
class _Leaf:
    """One leaf of a queued save: its file, global shape and dtype, and
    the blocks this rank writes (index into the global array, host
    copy)."""
    key: str
    file: str
    shape: tuple
    dtype: str
    per_rank: Optional[list] = None          # [pp, dp, tp]
    blocks: list = field(default_factory=list)


# every live manager, flushed once at interpreter exit, so a queued save
# is never lost with the daemon writer
_MANAGERS: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _flush_all_managers():
    for mgr in list(_MANAGERS):
        try:
            mgr.flush(raise_errors=False)
        except Exception:
            pass


class CheckpointManager:
    """Checkpoints of one rank's state in ``directory``; ``axes`` is the
    rank's ``MeshAxes`` (None: one process holding global trees)."""

    def __init__(self, directory: str, keep: int = 3, axes=None):
        self.dir = directory
        self.keep = keep
        self.axes = axes
        self.rank = axes.rank if axes is not None else 0
        self.world = (axes.pp * axes.dp * axes.tp) if axes is not None \
            else 1
        os.makedirs(directory, exist_ok=True)
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._errors: list = []
        self.io_seconds = 0.0
        self.io_bytes = 0
        self.saves = 0
        if self.rank == 0:
            self._sweep_orphans()
        _MANAGERS.add(self)

    # ----------------------------------------------------------------- save
    def _layout(self, tree, decls, per_rank: Sequence[str]) -> List[_Leaf]:
        """The leaves of ``{"params", "opt", "extra"}`` with the blocks
        this rank writes, copied to the host now."""
        dflat = dict(tree_leaves(decls)) if decls is not None else {}
        axes = self.axes
        coords = (_coords(axes.pp_rank, axes.dp_rank, axes.tp_rank, axes.pp,
                          axes.dp, axes.tp) if axes is not None else {})
        mesh = ([axes.pp, axes.dp, axes.tp] if axes is not None
                else [1, 1, 1])
        out = []
        for i, (key, leaf) in enumerate(tree_leaves(tree)):
            local = tuple(leaf.shape)
            lf = _Leaf(key, f"leaf_{i:05d}.npy", local, _dtype_name(leaf))
            if any(key == f"opt/{p}" or key.startswith(f"opt/{p}/")
                   for p in per_rank):
                lf.shape, lf.per_rank = (self.world,) + local, mesh
                lf.blocks.append(((self.rank,), _host(leaf)))
            elif self.world == 1:
                lf.blocks.append(((), _host(leaf)))
            else:
                if key not in dflat and not key.startswith("extra/"):
                    raise ValueError(
                        f"checkpoint of a rank of {self.world}: no decl "
                        f"for {key}; pass decls and opt_decls to "
                        f"save_async")
                spec = tuple(dflat[key].spec) if key in dflat else ()
                lf.shape = (tuple(dflat[key].shape) if key in dflat
                            else local)
                idx = _block(spec, coords, lf.shape)
                if tuple(s.stop - s.start for s in idx) != local:
                    raise ValueError(f"{key}: local shape {local} is not "
                                     f"a block of {lf.shape} under "
                                     f"{spec}")
                sharded = {e for e in spec if e is not None}
                if all(coords[a][1] == 0 for a in _AXES
                       if a not in sharded):
                    lf.blocks.append((idx, _host(leaf)))
            out.append(lf)
        return out

    def save_async(self, step: int, params, opt_state, extra=None,
                   meta: Optional[dict] = None, *, decls=None,
                   opt_decls=None, per_rank: Sequence[str] = ()):
        """Copy this rank's blocks to the host NOW, then queue the write
        and return without waiting on IO.  On a rank of a mesh,
        ``decls`` and ``opt_decls`` give each leaf's global shape and
        spec; ``per_rank`` names the optimizer states saved whole on
        every rank (``Optimizer.per_rank_state``).  Writes run one at a
        time on a background worker; ``flush()`` joins them all."""
        tree = {"params": params, "opt": opt_state,
                "extra": extra if extra is not None else {}}
        dtree = {"params": decls, "opt": opt_decls} \
            if decls is not None else None
        leaves = self._layout(tree, dtree, per_rank)
        self._ensure_worker()
        self._queue.put((step, leaves, dict(meta or {})))

    def save(self, step: int, params, opt_state, extra=None,
             meta: Optional[dict] = None, **layout):
        self.save_async(step, params, opt_state, extra, meta, **layout)
        self.flush()

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True,
                name=f"ckpt-writer:{self.dir}")
            self._worker.start()

    def _worker_loop(self):
        while True:
            job = self._queue.get()
            try:
                self._write(*job)
            except Exception as exc:    # surfaced at the next flush()
                self._errors.append(exc)
            finally:
                self._queue.task_done()

    def _write(self, step: int, leaves: List[_Leaf], meta: dict):
        t0 = time.perf_counter()
        # emitted from the writer thread: the span lands on its own
        # trace row, showing save IO overlapping the training steps
        span = get_tracer().begin("ckpt/save", cat="ckpt", step=step)
        tmp, final = _step_dir(self.dir, step, True), _step_dir(self.dir,
                                                               step)
        created = os.path.join(tmp, _CREATED)
        if self.rank == 0:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for lf in leaves:
                path = os.path.join(tmp, lf.file)
                dt = _stored_dtype(lf.dtype)
                if int(np.prod(lf.shape)) == 0:
                    np.save(path, np.empty(lf.shape, dt))
                else:
                    mm = np.lib.format.open_memmap(path, mode="w+",
                                                   dtype=dt, shape=lf.shape)
                    del mm
            open(created, "w").close()
        else:
            _wait(lambda: os.path.exists(created),
                  f"rank 0 to create step {step}", WAIT_S)
        nbytes = 0
        for lf in leaves:
            blocks = [(i, a) for i, a in lf.blocks if a.size]
            if not blocks:
                continue
            path = os.path.join(tmp, lf.file)
            offset = _data_offset(path)
            fd = os.open(path, os.O_WRONLY)
            try:
                for idx, arr in blocks:
                    _write_block(fd, offset, lf.shape, idx, arr)
                    nbytes += arr.nbytes
            finally:
                os.close(fd)
        done = [os.path.join(tmp, f"done_{r:05d}") for r in
                range(self.world)]
        if self.world > 1:
            open(done[self.rank], "w").close()
        if self.rank == 0:
            _wait(lambda: all(map(os.path.exists, done[1:])),
                  f"every rank's blocks of step {step}", WAIT_S)
            for path in done[1:] + [created]:
                os.remove(path)
            index = {"step": step, "leaves": {}, "meta": meta}
            for lf in leaves:
                rec = {"file": lf.file, "shape": list(lf.shape),
                       "dtype": lf.dtype}
                if lf.per_rank is not None:
                    rec["per_rank"] = lf.per_rank
                index["leaves"][lf.key] = rec
            with open(os.path.join(tmp, "index.json"), "w") as f:
                json.dump(index, f)
            # the marker goes LAST: its presence means complete
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write(str(step))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            # `latest` moves only AFTER the rename
            self._set_latest(step)
            self._gc()
        else:
            _wait(lambda: os.path.exists(os.path.join(final, "COMMITTED")),
                  f"rank 0 to commit step {step}", WAIT_S)
        dt = time.perf_counter() - t0
        self.io_seconds += dt
        self.io_bytes += nbytes
        self.saves += 1
        get_tracer().end(span.annotate(bytes=nbytes))
        get_metrics().counter("ckpt_saves_total",
                              "committed checkpoint saves").inc()
        get_metrics().counter("ckpt_bytes_total",
                              "bytes written by checkpoint saves").inc(
                                  nbytes)
        get_metrics().histogram("ckpt_write_seconds",
                                "checkpoint write wall seconds").observe(
                                    dt)

    def flush(self, raise_errors: bool = True):
        """Join every queued write (and its commit).  Errors the writer
        met are raised here, the first point the caller can see them."""
        self._queue.join()
        if self._errors and raise_errors:
            exc, self._errors = self._errors[0], []
            raise exc

    def wait(self):
        self.flush()

    def close(self):
        self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.flush(raise_errors=exc_info[0] is None)
        return False

    def io_stats(self) -> dict:
        return {"io_seconds": self.io_seconds, "io_bytes": self.io_bytes,
                "saves": self.saves}

    # ----------------------------------------------------- latest & hygiene
    def _set_latest(self, step: int):
        tmp = os.path.join(self.dir, _LATEST + ".tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, os.path.join(self.dir, _LATEST))

    def latest_step(self) -> Optional[int]:
        """The step the ``latest`` pointer names, verified complete;
        else the newest COMMITTED directory."""
        path = os.path.join(self.dir, _LATEST)
        if os.path.exists(path):
            try:
                with open(path) as f:
                    step = int(f.read().strip())
                if os.path.exists(os.path.join(_step_dir(self.dir, step),
                                               "COMMITTED")):
                    return step
            except (ValueError, OSError):
                pass
        steps = self.available_steps()
        return steps[-1] if steps else None

    def _sweep_orphans(self):
        """Remove torn ``.tmp`` partials and repair a ``latest`` pointer
        naming a missing or incomplete checkpoint."""
        for name in os.listdir(self.dir):
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)
        path = os.path.join(self.dir, _LATEST)
        if os.path.exists(path):
            try:
                with open(path) as f:
                    step = int(f.read().strip())
                ok = os.path.exists(os.path.join(_step_dir(self.dir, step),
                                                 "COMMITTED"))
            except (ValueError, OSError):
                ok = False
            if not ok:
                steps = self.available_steps()
                if steps:
                    self._set_latest(steps[-1])
                else:
                    os.remove(path)

    def invalidate_after(self, step: int):
        """Drop checkpoints after ``step``: the stale timeline an elastic
        restore rewinds past.  Joins queued writes first, so an
        in-flight save of abandoned state cannot commit afterwards."""
        self.flush(raise_errors=False)
        if self.rank:
            return
        for s in self.available_steps():
            if s > step:
                shutil.rmtree(_step_dir(self.dir, s), ignore_errors=True)
        remaining = self.available_steps()
        path = os.path.join(self.dir, _LATEST)
        if remaining:
            self._set_latest(remaining[-1])
        elif os.path.exists(path):
            os.remove(path)

    def _gc(self):
        steps = self.available_steps()
        latest = self.latest_step()
        for s in steps[:-self.keep]:
            if s == latest:
                continue
            shutil.rmtree(_step_dir(self.dir, s), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def available_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if os.path.exists(os.path.join(self.dir, name, "COMMITTED")):
                out.append(int(name.split("_")[1]))
        return out

    def _index(self, step: int) -> dict:
        with open(os.path.join(_step_dir(self.dir, step),
                               "index.json")) as f:
            return json.load(f)

    def load_host(self, step: int):
        """``(index, {key: np.ndarray})``, the keys the ``/``-joined tree
        paths: the global host tree the elastic runtime converts across
        model classes (a per-rank leaf with its leading rank axis)."""
        index = self._index(step)
        path = _step_dir(self.dir, step)
        leaves = {key: np.load(os.path.join(path, rec["file"]))
                  for key, rec in index["leaves"].items()}
        return index, leaves

    def meta(self, step: int) -> dict:
        return self._index(step).get("meta", {})

    def restore(self, step: int, decls, opt_decls, axes=None, device=None):
        """This rank's ``TrainState`` from a step directory: each leaf's
        block for ``axes`` (None: the global arrays) cut from the
        memory-mapped global file, on ``device`` (the card unless the
        caller asks for the CPU).  Works on any mesh; a leaf saved per
        rank only on the mesh it was saved on."""
        from repro_torch.parallel.axes import resolve_device
        from repro_torch.train.trainer import TrainState
        with get_tracer().span("ckpt/restore", cat="ckpt", step=step):
            dev = resolve_device(device)
            index = self._index(step)
            path = _step_dir(self.dir, step)
            coords, mesh, rank = {}, [1, 1, 1], 0
            if axes is not None:
                coords = _coords(axes.pp_rank, axes.dp_rank, axes.tp_rank,
                                 axes.pp, axes.dp, axes.tp)
                mesh, rank = [axes.pp, axes.dp, axes.tp], axes.rank
            skeleton = {"params": decls, "opt": opt_decls}
            flat = {}
            for key, decl in tree_leaves(skeleton):
                rec = index["leaves"].get(key)
                if rec is None:
                    raise KeyError(f"step {step} holds no {key}")
                arr = np.load(os.path.join(path, rec["file"]),
                              mmap_mode="r")
                if "per_rank" in rec:
                    if rec["per_rank"] != mesh:
                        raise ValueError(
                            f"{key} was saved per rank on pp x dp x tp = "
                            f"{rec['per_rank']}, and this mesh is {mesh}: "
                            f"the optimizer's factored moments are means "
                            f"over a rank's local leaf (ROADMAP.md queue "
                            f"3), so they do not carry over to another "
                            f"mesh")
                    block = arr[rank]
                else:
                    if tuple(arr.shape) != tuple(decl.shape):
                        raise ValueError(
                            f"{key}: saved {tuple(arr.shape)}, declared "
                            f"{tuple(decl.shape)}")
                    block = arr[_block(decl.spec, coords, arr.shape)] \
                        if coords else arr
                flat[key] = _tensor(block, rec["dtype"], dev)
            tree = tree_unflatten(skeleton, flat)
        return TrainState(tree["params"], tree["opt"], step)

    def restore_latest(self, decls, opt_decls, axes=None, device=None):
        """``restore`` of ``latest``, falling back past an unreadable
        checkpoint to the next newest; None when none is readable."""
        steps = self.available_steps()
        latest = self.latest_step()
        order = ([latest] if latest is not None else []) \
            + [s for s in reversed(steps) if s != latest]
        for step in order:
            try:
                return self.restore(step, decls, opt_decls, axes, device)
            except (OSError, ValueError, KeyError, EOFError) as e:
                print(f"[checkpoint] step {step} unreadable ({e}); "
                      f"falling back")
        return None
