"""Batched serving engine: prefill + decode steps with continuous
batching (slots with per-slot positions; finished slots are refilled
without stalling the running batch), on one device or over a dp x tp
mesh.

Over a mesh the engine is SPMD, one engine per rank (the reference runs
one program over the mesh instead):

  * every rank holds the same scheduler, page table and slot state and
    takes the same decisions; dp shards the slots (rank d runs the rows
    ``[d slots/dp, (d + 1) slots/dp)`` of every step), tp the model;
  * each rank samples the slots it runs and the sampled tokens are
    all-gathered over dp, so every rank sees every slot's token;
  * one virtual clock: each step's wall time is the maximum over the
    ranks, so ``replay`` admits the same arrivals everywhere;
  * a prefill leaves rank j of the model axis holding positions
    ``[j S/tp, (j + 1) S/tp)`` of its rows; the decode cache wants
    ``[j max_len/tp, (j + 1) max_len/tp)``.  After the metered prefill
    the group's rows are all-gathered over tp and each rank keeps its
    chunk (``_splice``): a prompt of ``S <= max_len/tp`` lands wholly on
    rank 0.

The agreement (clock, tokens, relayout) runs on ``Group.unrecorded``
copies of the mesh's groups: it is host bookkeeping, kept out of the
model's collectives that ``record_collectives`` counts, and its host
time, calls and bytes are summed in ``agreement`` by kind.

Around the physical KV cache sit the same runtime layers as in the
reference: ``kv_cache.PagedKVCache`` (page admission and occupancy),
``scheduler.Scheduler`` (length-bucketed refill groups in arrival
order), ``sampling.Sampler`` (per-request
greedy or seeded sampling on the host) and a virtual clock (wall time of
executed steps, which TTFT and TPOT are read from).

Bucket-padded prompts decode correctly via last-token replay: a prompt
of true length ``s`` padded to ``S`` leaves garbage cache rows at
positions ``s..S-1``, but decode masks cache positions ``>= pos + 1``,
so the engine sets ``pos = s - 1``, feeds the last real prompt token as
the first decode input (recomputing exactly the row prefill wrote at
``s - 1``), and samples the first output token from that step's logits.
Every later write lands at the current ``pos``, overwriting each pad
row before it ever becomes attendable.

Families whose prefill folds the tokens into a recurrent state
(``RECURRENT_FAMILIES``: the SSM, hybrid and encoder-decoder families)
cannot be right-padded: their refill groups are exact-length (the
scheduler's ``mixed_lengths=False``, so a prompt's length must be a
multiple of the page size), every first output token is the prefill's
own sample, and the state rows (``{"conv", "ssm"}``, no sequence dim)
are spliced whole.  A hybrid's cache holds both kinds, one tree per sub
of its superblock.

Every prefill gets the stubs of the family's frontends (by default
``_add_modality_stubs``, as the reference's engine adds them): zero
``frames`` for the encoder-decoder, zero ``vision_embeds`` over the
first ``n_vision_tokens`` positions for the vision frontend, and M-RoPE
``positions`` equal on all three rows.  The encoder-decoder's cache is
``{"self", "cross"}``: the cross K/V of a prompt of length ``S`` are
spliced into the first ``S`` of the ``max_len`` rows and the rest are
zero (relaid over tp like the self rows), and decode reads all
``max_len`` rows unmasked, zeros included, as the reference's does
(ROADMAP.md queue 3).

A request prefilled elsewhere (the fleet's prefill pool,
``serve/fleet``) joins a slot through ``adopt``: the same write as a
refill's splice (``_write_rows``: the tp relayout, the zeroed tail, the
SSD state whole, the dtype promotion) and the same decode state.  The
fleet sets its engines' clock itself (``clock_scale = 0``), and they
skip the clock's agreement.

Where the reference donates the decode cache to a jitted step that
returns a new one, the port's decode step writes the new K/V rows (or
the new state) into the cache in place, and refills splice prefill rows
into it in place.

Each refill group's prefill runs in a ``serve/prefill`` span and each
decode step in a ``serve/decode`` span; ``serve_prefill_tokens_total``
counts the groups' real prompt tokens, ``serve_decode_tokens_total``
the decode steps' tokens (on a mesh, each rank's own).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (forward_decode, forward_prefill,
                                      n_vision_tokens, rank_cache_decls,
                                      require_serving_mesh, serving_params)
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.parallel.axes import MeshAxes, resolve_device
from repro_torch.parallel.params import (tree_leaves, tree_map,
                                         tree_unflatten)
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.sampling import Sampler, SamplingParams
from repro_torch.serve.scheduler import Scheduler
from repro_torch.telemetry.ledger import LedgerEntry
from repro_torch.telemetry.meter import StepMeter

# model families whose prefill folds the tokens into a recurrent state:
# their refill groups are exact-length (the reference's tuple)
RECURRENT_FAMILIES = ("ssm", "hybrid", "encdec")


@dataclass
class Request:
    prompt: np.ndarray                  # [S_prompt] int32
    max_new_tokens: int = 32
    eos_id: int = -1                    # -1: never stops early
    sampling: SamplingParams = field(default_factory=SamplingParams)
    req_id: int = -1
    arrival_s: float = 0.0              # trace time (virtual clock)
    deadline_ms: float = 0.0            # e2e deadline; 0 = none
    out_tokens: list = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None         # admission rejection reason
    # SLO stamps on the engine's virtual clock
    t_submit_s: Optional[float] = None
    t_first_s: Optional[float] = None
    t_done_s: Optional[float] = None
    _seq: int = field(default=0, repr=False)
    _sampler: Optional[Sampler] = field(default=None, repr=False)


class ServeEngine:
    """Slot-based continuous batching on this rank of a dp x tp mesh
    (one device: ``axes=None``).

    ``params`` is this rank's parameter tree (any device and dtype): the
    global tree on one device, the rank's shards on a mesh
    (``parallel/params.py: shard_params`` or ``materialize_shards``);
    the engine moves it to ``device`` and casts it for serving once
    (``models.model.serving_params``).  ``device`` defaults to the card.
    ``ledger``: ``run`` and ``close`` record the meters' window to it
    (``record_to``).  ``stubs(cfg, batch, B, S) -> batch`` adds the
    stubbed frontends' inputs to a prefill of this rank's ``B`` rows of
    ``S`` tokens (default ``_add_modality_stubs``: zero frames and
    vision embeddings, as the reference's engine adds them)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 8,
                 max_len: int = 256, page_size: int = 16,
                 axes: Optional[MeshAxes] = None, device=None, ledger=None,
                 order: str = "fcfs", stubs=None):
        self.cfg = cfg
        self.axes = axes = axes or MeshAxes()
        require_serving_mesh(cfg, axes, "ServeEngine")
        # every bucket-padded prefill length must split over the model
        # axis, and the slots over dp (the reference's checks)
        if page_size % axes.tp:
            raise ValueError(
                f"page_size {page_size} must be a multiple of the "
                f"model-axis size {axes.tp} (sequence-shard divisibility of "
                f"bucket-padded prefills)")
        if slots % axes.dp or max_len % axes.tp:
            raise ValueError(f"{slots} slots x max_len {max_len} do not "
                             f"shard over dp={axes.dp} x tp={axes.tp}")
        self.device = resolve_device(device)
        self.params = serving_params(cfg, params, self.device)
        self.slots = slots
        self.max_len = max_len
        self.stubs = stubs or _add_modality_stubs
        self.ledger = ledger
        self._ledger_window = 0
        self._closed = False
        # this rank's rows of every step
        n = slots // axes.dp
        self.rows = range(axes.dp_rank * n, (axes.dp_rank + 1) * n)
        self.prefill_meter = StepMeter(f"prefill_{cfg.name}", warmup=1,
                                       device=self.device)
        self.decode_meter = StepMeter(f"decode_{cfg.name}", warmup=1,
                                      device=self.device)
        self.pages = PagedKVCache(slots, max_len, page_size)
        # dense prompts can be right-padded: mixed-length bucketed groups
        self.recurrent = cfg.family in RECURRENT_FAMILIES
        self.scheduler = Scheduler(bucket=page_size, order=order,
                                   pages=self.pages,
                                   mixed_lengths=not self.recurrent)
        # virtual clock: wall seconds of executed steps x clock_scale
        self.now_s = 0.0
        self.clock_scale = 1.0
        self._agree = {name: g.unrecorded() for name, g in (
            ("world", axes.world_comm), ("dp", axes.dp_comm),
            ("tp", axes.tp_comm)) if g.size > 1}
        self.agreement = {kind: {"calls": 0, "ms": 0.0, "bytes": 0}
                          for kind in ("clock", "tokens", "relayout")}
        self.cache = self._zero_cache()
        self.pos = np.zeros((slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * slots
        self.last_tok = np.zeros((slots, 1), np.int32)

    def _zero_cache(self):
        return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=self.device),
                        rank_cache_decls(self.cfg, self.axes, self.slots,
                                         self.max_len))

    # --- step functions --------------------------------------------------

    @torch.no_grad()
    def prefill_fn(self, tokens):
        """tokens [rows, S] (with the family's stubs added) -> (logits
        [rows, 1, V], this rank's cache rows)."""
        B, S = tokens.shape
        return forward_prefill(self.cfg, self.axes, self.params,
                               self.stubs(self.cfg, {"tokens": tokens},
                                          B, S))

    @torch.no_grad()
    def decode_fn(self, cache, tokens, pos):
        """Writes into ``cache`` in place; returns (logits, cache)."""
        return forward_decode(self.cfg, self.axes, self.params, cache,
                              tokens, pos)

    def _tensor(self, a):
        """This rank's rows of a per-slot host array, on the device."""
        a = np.asarray(a)[self.rows.start:self.rows.stop]
        return torch.from_numpy(a).to(self.device, dtype=torch.long)

    # --- agreement of the ranks -------------------------------------------

    def _agreed(self, kind: str, group: str, fn, t: torch.Tensor):
        """``fn(g, t)`` on the unrecorded group ``group``, its host time,
        call and bytes summed under ``agreement[kind]``; ``t`` unchanged
        when the group has one rank."""
        g = self._agree.get(group)
        if g is None:
            return t
        t0 = time.perf_counter()
        out = fn(g, t)
        rec = self.agreement[kind]
        rec["ms"] += (time.perf_counter() - t0) * 1e3
        rec["calls"] += 1
        rec["bytes"] += t.numel() * t.element_size()
        return out

    def _advance(self, dt_s: float):
        """Advance the clock by a step's wall time: the longest over the
        ranks, so every rank's clock agrees.  At ``clock_scale = 0`` (the
        fleet's engines, whose clock the fleet sets) the time would be
        thrown away, and so is its agreement."""
        if self.clock_scale == 0:
            return
        dt = self._agreed("clock", "world",
                          lambda g, t: g.all_reduce(t, op="max"),
                          torch.tensor([dt_s], dtype=torch.float64,
                                       device=self.device))
        self.now_s += float(dt.reshape(-1)[0]) * self.clock_scale

    def _sample(self, logits, slots) -> dict:
        """{slot: token} for ``slots``, the same on every rank: each rank
        samples the slots of its rows from ``logits`` (its rows'
        [rows, 1, V] numpy logits) and the tokens are all-gathered over
        dp."""
        if not slots:
            return {}
        mine = np.full((len(self.rows),), -1, np.int64)
        for i in slots:
            if i in self.rows:
                mine[i - self.rows.start] = self.active[i]._sampler(
                    logits[i - self.rows.start, 0])
        toks = self._agreed("tokens", "dp",
                            lambda g, t: g.all_gather(t).reshape(-1),
                            torch.from_numpy(mine).to(self.device))
        toks = toks.cpu().numpy()
        return {i: int(toks[i]) for i in slots}

    # --- clock -----------------------------------------------------------

    def advance_clock(self, dt_s: float):
        """Jump the virtual clock forward (idle gaps in a trace replay)."""
        self.now_s += max(0.0, dt_s)

    def _timed(self, meter, fn, *args):
        t0 = time.perf_counter()
        out = meter.call(fn, *args)
        self._advance(time.perf_counter() - t0)
        return out

    def has_active(self) -> bool:
        return any(r is not None for r in self.active)

    def warmup(self, bucket_lens=()):
        """Run one prefill per bucket length and one decode step outside
        the meters and the virtual clock (on a scratch cache), so the
        first measured steps do not pay one-time set-up."""
        n = len(self.rows)
        for S in sorted(set(bucket_lens)):
            self.prefill_fn(torch.zeros((n, S), dtype=torch.long,
                                        device=self.device))
        self.decode_fn(self._zero_cache(), self._tensor(self.last_tok),
                       self._tensor(self.pos))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def queue(self):
        return self.scheduler.queue

    # --- scheduling ------------------------------------------------------

    def submit(self, requests: List[Request]):
        """Enqueue requests (admission-checked) and refill free slots.
        Submitting is cumulative: a trace replay feeds arrivals in as the
        clock passes them."""
        for req in requests:
            if len(req.prompt) == 0:
                req.done, req.error = True, "rejected: empty prompt"
                self.scheduler.rejected.append(req)
                continue
            req.t_submit_s = self.now_s
            req._sampler = Sampler(req.sampling, self.cfg.vocab_size)
            self.scheduler.add([req])
        self._fill_slots()

    def _fill_slots(self):
        """Refill free slots with length-bucketed prefill groups; one
        group = one batched prefill call."""
        free = [i for i in range(self.slots) if self.active[i] is None]
        while free:
            n_active = self.slots - len(free)
            if not self.scheduler.should_refill(len(free), n_active):
                return
            S, group = self.scheduler.next_group(len(free))
            if not group:
                return
            self._prefill_group(S, group, free)

    def _prefill_group(self, S: int, group: List[Request],
                       free: List[int]):
        """Batched prefill for ``group`` (prompts padded to ``S``),
        splicing the new cache rows into the popped free slots."""
        slot_ids = [free.pop(0) for _ in group]
        toks = np.zeros((self.slots, S), np.int32)
        for i, req in zip(slot_ids, group):
            toks[i, :len(req.prompt)] = req.prompt
        with get_tracer().span("serve/prefill", cat="serve", bucket=S,
                               group=len(group)):
            logits, fresh = self._timed(self.prefill_meter,
                                        self.prefill_fn, self._tensor(toks))
        get_metrics().counter(
            "serve_prefill_tokens_total",
            "real (unpadded) prompt tokens prefilled").inc(
                sum(len(r.prompt) for r in group))
        self._splice(fresh, slot_ids, S)
        logits = logits.float().cpu().numpy()
        for i, req in zip(slot_ids, group):
            self.active[i] = req
            self.pages.alloc(i, S)
        exact = [i for i, req in zip(slot_ids, group)
                 if len(req.prompt) == S]
        first = self._sample(logits, exact)
        for i, req in zip(slot_ids, group):
            s = len(req.prompt)
            if s == S:
                # exact-length: prefill's last-position logits ARE the
                # first output token
                nxt = first[i]
                req.out_tokens.append(nxt)
                req.t_first_s = self.now_s
                self.last_tok[i, 0] = nxt
                self.pos[i] = s
                if nxt == req.eos_id or req.max_new_tokens <= 1:
                    self._finish(i, req)
                    free.append(i)
            else:
                # bucket-padded: replay the last real prompt token as
                # the first decode input (see module docstring)
                self.last_tok[i, 0] = req.prompt[s - 1]
                self.pos[i] = s - 1

    def _splice(self, fresh, slot_ids, S: int):
        """Write the group's prefill rows (``fresh``: this rank's rows of
        every slot) into the slots ``slot_ids`` of the cache
        (``_write_rows``)."""
        mine = [i for i in slot_ids if i in self.rows]
        if not mine:
            return
        idx = torch.tensor([i - self.rows.start for i in mine],
                           device=self.device)
        self._write_rows({path: t[:, idx] for path, t in tree_leaves(fresh)},
                         idx, S)

    def _write_rows(self, rows: dict, idx, S: int):
        """Write prefill rows into this rank's cache rows ``idx``, in
        place; ``rows`` maps each cache leaf's path to the rank's rows,
        ``[G, len(idx), ...]``, ``S`` positions long.  Zero past ``S``;
        an SSD state has no sequence dim and is written whole (each
        rank's prefill rows are its own channels and heads of it).  At
        tp > 1 rank j's prefill rows hold positions
        ``[j S/tp, (j + 1) S/tp)``: they are all-gathered over tp and the
        rank keeps its chunk of ``max_len / tp``.  A leaf takes the wider
        of its dtype and the rows', as the reference's ``jnp.where``
        merge promotes it: bf16 as declared under bf16 activations,
        float32 once float32 rows arrive."""
        p, j = self.axes.tp, self.axes.tp_rank
        merged = {}
        for path, c in tree_leaves(self.cache):
            f = rows[path]
            c = c.to(torch.promote_types(c.dtype, f.dtype))
            if path.split("/")[-1] in ("conv", "ssm"):
                c[:, idx] = f.to(c.dtype)
                merged[path] = c
                continue
            if p > 1:
                f = self._agreed(
                    "relayout", "tp",
                    lambda g, t: torch.cat(g.all_gather(t).unbind(0), 2), f)
            chunk = c.shape[2]
            lo, hi = j * chunk, min(S, (j + 1) * chunk)
            n = max(hi - lo, 0)
            c[:, idx, :n] = f[:, :, lo:lo + n].to(c.dtype)
            c[:, idx, n:] = 0
            merged[path] = c
        self.cache = tree_unflatten(self.cache, merged)

    def adopt(self, req: Request, cache_rows, *, prefill_len: int,
              pos: int, last_tok: int) -> int:
        """Install a request whose KV cache was computed ELSEWHERE (a
        fleet prefill pool) into the first free slot: page admission,
        the slot's cache rows (``_write_rows``, the write ``_splice``
        makes) and the decode state (``pos`` / ``last_tok``, the
        request's sampler) exactly as ``_prefill_group`` would have left
        them, so the replay-last-token contract survives the migration.
        ``cache_rows`` is this rank's rows of the request: a tree
        matching the cache's leaves with batch axis 1, ``prefill_len``
        positions long, sequence-sharded over tp as this rank's prefill
        left them.  Returns the slot; raises ``RuntimeError`` when no
        slot is free or the request is done, and ``CacheOverflow`` when
        it cannot fit a slot's frames."""
        free = [i for i in range(self.slots) if self.active[i] is None]
        if not free:
            raise RuntimeError("adopt: no free slot")
        if req.done:
            raise RuntimeError(f"adopt: request {req.req_id} already done")
        slot = free[0]
        self.pages.alloc(slot, prefill_len)
        if req._sampler is None:
            req._sampler = Sampler(req.sampling, self.cfg.vocab_size)
        if slot in self.rows:
            idx = torch.tensor([slot - self.rows.start], device=self.device)
            self._write_rows(dict(tree_leaves(cache_rows)), idx, prefill_len)
        self.active[slot] = req
        self.pos[slot] = pos
        self.last_tok[slot, 0] = last_tok
        return slot

    def _finish(self, slot: int, req: Request):
        req.done = True
        req.t_done_s = self.now_s
        self.active[slot] = None
        self.pages.free(slot)

    # --- decode ----------------------------------------------------------

    def step(self):
        if not self.has_active():
            self._fill_slots()
            if not self.has_active():
                return
        live = [i for i, r in enumerate(self.active) if r is not None]
        with get_tracer().span("serve/decode", cat="serve",
                               active=len(live)):
            logits, self.cache = self._timed(
                self.decode_meter, self.decode_fn, self.cache,
                self._tensor(self.last_tok), self._tensor(self.pos))
        get_metrics().counter(
            "serve_decode_tokens_total",
            "tokens produced by decode steps").inc(len(live))
        nxt = self._sample(logits.float().cpu().numpy(), live)
        for i in live:
            req = self.active[i]
            wrote = int(self.pos[i])          # decode wrote this row
            self.pos[i] += 1
            self.pages.advance(i, wrote)
            if req.t_first_s is None:         # replayed-prompt first token
                req.t_first_s = self.now_s
            req.out_tokens.append(nxt[i])
            self.last_tok[i, 0] = nxt[i]
            if (len(req.out_tokens) >= req.max_new_tokens
                    or nxt[i] == req.eos_id
                    or self.pos[i] >= self.max_len - 1):
                self._finish(i, req)
        self._fill_slots()

    def run(self, requests: List[Request], max_steps: int = 10_000):
        self.submit(requests)
        steps = 0
        while (self.has_active() or len(self.scheduler)) \
                and steps < max_steps:
            self.step()
            steps += 1
        if self.ledger is not None:
            self.record_to(self.ledger)
        return requests

    # --- shutdown --------------------------------------------------------

    def close(self):
        """Flush the telemetry window and mark the engine closed: a short
        session (a few ``step()`` calls, no ``run()``) records its tail
        to the ledger here.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self.ledger is not None:
            if self.prefill_meter.calls or self.decode_meter.calls:
                self.record_to(self.ledger)
            self.ledger.flush()

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # --- telemetry -------------------------------------------------------

    def telemetry(self) -> dict:
        """Step-time summaries of the prefill and decode meters, the
        page-table occupancy stats and the ranks' agreement traffic."""
        return {"prefill": self.prefill_meter.summary(),
                "decode": self.decode_meter.summary(),
                "pages": self.pages.stats(),
                "agreement": {k: dict(v) for k, v in self.agreement.items()}}

    def record_to(self, ledger, predicted=None, extra=None,
                  measured_extra=None):
        """Record one serving entry per metered step kind to a Ledger,
        then reset the meters, so repeated ``run()`` calls record
        disjoint windows (``extra["window"]`` orders them).
        ``predicted`` / ``measured_extra`` are optional per-kind dicts
        (``{"prefill": {...}, "decode": {...}}``): the router passes the
        analytic serve prediction and the counted account so the entries
        join into energy ratios."""
        impl = "phantom" if self.cfg.uses_phantom_sites() else "dense"
        out = []
        for kind, meter in (("prefill", self.prefill_meter),
                            ("decode", self.decode_meter)):
            if not meter.calls:
                continue
            ex = {"slots": self.slots, "max_len": self.max_len,
                  "window": self._ledger_window,
                  "pages": self.pages.stats()}
            ex.update(extra or {})
            measured = meter.summary()
            if measured_extra and measured_extra.get(kind):
                measured.update(measured_extra[kind])
            out.append(ledger.record(LedgerEntry(
                name=f"serve_{kind}_{self.cfg.name}", suite="serve",
                kind=kind, arch=self.cfg.name, impl=impl, p=self.axes.tp,
                measured=measured,
                predicted=predicted.get(kind) if predicted else None,
                extra=ex)))
            meter.reset(warm=True)
        self._ledger_window += 1
        return out


def _add_modality_stubs(cfg: ModelConfig, batch, B: int, S: int):
    """``batch`` with the stubbed frontends' inputs of a prefill of ``B``
    rows of ``S`` tokens, on the tokens' device (the reference's
    ``_add_modality_stubs``): zero float32 ``frames`` [B, S, d] for the
    encoder-decoder, zero float32 ``vision_embeds`` [B, n_img, d] for the
    vision frontend, and M-RoPE's ``positions`` [3, B, S], ``arange(S)``
    on each row."""
    dev = batch["tokens"].device
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((B, S, cfg.d_model), device=dev)
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.zeros(
            (B, n_vision_tokens(cfg, S), cfg.d_model), device=dev)
    if cfg.rope == "mrope":
        batch["positions"] = torch.arange(S, device=dev).expand(3, B, S)
    return batch


def drawn_stubs(cfg: ModelConfig, batch, B: int, S: int):
    """``_add_modality_stubs`` with non-zero ``frames`` and
    ``vision_embeds``: each row's drawn by ``stub_rows`` from its own
    tokens, so a request meets the same frontend inputs in any slot,
    refill group or rank.  Zero frames make the encoder's memory exactly
    zero, and zero vision embeddings leave the splice untested: a check
    of those paths serves through this (``ServeEngine(stubs=...)``)."""
    batch = _add_modality_stubs(cfg, batch, B, S)
    toks = batch["tokens"].cpu().numpy()
    for key in ("frames", "vision_embeds"):
        if key in batch:
            rows = np.stack([stub_rows(t, batch[key].shape[1], cfg.d_model)
                             for t in toks])
            batch[key] = torch.from_numpy(rows).to(batch[key].device)
    return batch


def stub_rows(tokens, n: int, d: int) -> np.ndarray:
    """[n, d] standard normal float32 rows from a numpy ``RandomState``
    seeded by the token ids ``tokens`` (one prompt, padded as served)."""
    t = np.asarray(tokens, np.int64) % 65521
    seed = int(np.dot(t, np.arange(1, len(t) + 1)) % (2 ** 31 - 1))
    return np.random.RandomState(seed).standard_normal((n, d)).astype(
        np.float32)
