"""Batched serving engine on one device: prefill + decode steps with
continuous batching (slots with per-slot positions; finished slots are
refilled without stalling the running batch).

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
(``RECURRENT_FAMILIES``; the SSM and hybrid families are ported) cannot
be right-padded: their refill groups are exact-length (the scheduler's
``mixed_lengths=False``, so a prompt's length must be a multiple of the
page size), every first output token is the prefill's own sample, and
the state rows (``{"conv", "ssm"}``, no sequence dim) are spliced whole.
A hybrid's cache holds both kinds, one tree per sub of its superblock.

Every prefill gets the stubs of the family's frontends
(``_add_modality_stubs``, as the reference's engine adds them): zero
``frames`` for the encoder-decoder, zero ``vision_embeds`` over the
first ``n_vision_tokens`` positions for the vision frontend, and M-RoPE
``positions`` equal on all three rows.  The encoder-decoder's cache is
``{"self", "cross"}``: the cross K/V of a prompt of length ``S`` are
spliced into the first ``S`` of the ``max_len`` rows and the rest are
zero, and decode reads all ``max_len`` rows unmasked, zeros included, as
the reference's does (ROADMAP.md queue 3).

Where the reference donates the decode cache to a jitted step that
returns a new one, the port's decode step writes the new K/V rows (or
the new state) into the cache in place, and refills splice prefill rows
into it in place.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.specs import cache_specs, input_specs
from repro_torch.models.model import (forward_decode, forward_prefill,
                                      n_vision_tokens, serving_params)
from repro_torch.parallel.axes import (SERVE_TP_TODO, MeshAxes,
                                      resolve_device)
from repro_torch.parallel.params import (tree_leaves, tree_map,
                                         tree_unflatten)
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.sampling import Sampler, SamplingParams
from repro_torch.serve.scheduler import Scheduler
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
    """Slot-based continuous batching on one device.

    ``params`` is the model's parameter tree (any device and dtype); the
    engine moves it to ``device`` and casts it for serving once
    (``models.model.serving_params``).  ``device`` defaults to the card.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 8,
                 max_len: int = 256, page_size: int = 16,
                 axes: Optional[MeshAxes] = None, device=None):
        self.cfg = cfg
        self.axes = axes or MeshAxes()
        if self.axes.tp * self.axes.dp > 1:
            raise NotImplementedError(
                f"ServeEngine on dp={self.axes.dp} tp={self.axes.tp}: it "
                f"serves on one device; see {SERVE_TP_TODO}")
        self.device = resolve_device(device)
        self.params = serving_params(cfg, params, self.device)
        self.slots = slots
        self.max_len = max_len
        self.prefill_meter = StepMeter(f"prefill_{cfg.name}", warmup=1,
                                       device=self.device)
        self.decode_meter = StepMeter(f"decode_{cfg.name}", warmup=1,
                                      device=self.device)
        self.pages = PagedKVCache(slots, max_len, page_size)
        # dense prompts can be right-padded: mixed-length bucketed groups
        self.recurrent = cfg.family in RECURRENT_FAMILIES
        self.scheduler = Scheduler(bucket=page_size, pages=self.pages,
                                   mixed_lengths=not self.recurrent)
        # virtual clock: wall seconds of executed steps
        self.now_s = 0.0
        self._cache_shape = ShapeConfig("serve", max_len, slots, "decode")
        self.cache = self._zero_cache()
        self.pos = np.zeros((slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * slots
        self.last_tok = np.zeros((slots, 1), np.int32)

    def _zero_cache(self):
        return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=self.device),
                        cache_specs(self.cfg, self._cache_shape, self.axes))

    # --- step functions --------------------------------------------------

    @torch.no_grad()
    def prefill_fn(self, tokens):
        """tokens [slots, S] (with the family's stubs added) -> (logits
        [slots, 1, V], cache rows)."""
        B, S = tokens.shape
        return forward_prefill(self.cfg, self.axes, self.params,
                               _add_modality_stubs(self.cfg,
                                                   {"tokens": tokens}, B, S))

    @torch.no_grad()
    def decode_fn(self, cache, tokens, pos):
        """Writes into ``cache`` in place; returns (logits, cache)."""
        return forward_decode(self.cfg, self.axes, self.params, cache,
                              tokens, pos)

    def _tensor(self, a):
        return torch.from_numpy(np.asarray(a)).to(self.device,
                                                  dtype=torch.long)

    # --- clock -----------------------------------------------------------

    def _timed(self, meter, fn, *args):
        t0 = time.perf_counter()
        out = meter.call(fn, *args)
        self.now_s += time.perf_counter() - t0
        return out

    def has_active(self) -> bool:
        return any(r is not None for r in self.active)

    def warmup(self, bucket_lens=()):
        """Run one prefill per bucket length and one decode step outside
        the meters and the virtual clock (on a scratch cache), so the
        first measured steps do not pay one-time set-up."""
        for S in sorted(set(bucket_lens)):
            tok = input_specs(self.cfg, ShapeConfig("warmup", S, self.slots,
                                                    "prefill"),
                              self.axes)["tokens"]
            self.prefill_fn(torch.zeros(tok.shape, dtype=tok.dtype,
                                        device=self.device))
        self.decode_fn(self._zero_cache(), self._tensor(self.last_tok),
                       self._tensor(self.pos))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- scheduling ------------------------------------------------------

    def submit(self, requests: List[Request]):
        """Enqueue requests (admission-checked) and refill free slots."""
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
        logits, fresh = self._timed(self.prefill_meter, self.prefill_fn,
                                    self._tensor(toks))
        # splice the group's rows into the max_len cache, zero past S; an
        # SSD state has no sequence dim and is spliced whole.  A leaf
        # takes the wider of its dtype and the rows', as the reference's
        # ``jnp.where`` merge promotes it: bf16 as declared under bf16
        # activations, float32 once float32 rows arrive
        idx = torch.tensor(slot_ids, device=self.device)
        rows = dict(tree_leaves(fresh))
        merged = {}
        for path, c in tree_leaves(self.cache):
            f = rows[path][:, idx]
            c = c.to(torch.promote_types(c.dtype, f.dtype))
            if path.split("/")[-1] in ("conv", "ssm"):
                c[:, idx] = f.to(c.dtype)
            else:
                c[:, idx, :S] = f.to(c.dtype)
                c[:, idx, S:] = 0
            merged[path] = c
        self.cache = tree_unflatten(self.cache, merged)
        logits = logits.float().cpu().numpy()
        for i, req in zip(slot_ids, group):
            self.active[i] = req
            self.pages.alloc(i, S)
            s = len(req.prompt)
            if s == S:
                # exact-length: prefill's last-position logits ARE the
                # first output token
                nxt = req._sampler(logits[i, 0])
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
        logits, self.cache = self._timed(
            self.decode_meter, self.decode_fn, self.cache,
            self._tensor(self.last_tok), self._tensor(self.pos))
        logits = logits.float().cpu().numpy()
        for i, req in enumerate(self.active):
            if req is None:
                continue
            wrote = int(self.pos[i])          # decode wrote this row
            self.pos[i] += 1
            self.pages.advance(i, wrote)
            nxt = req._sampler(logits[i, 0])
            if req.t_first_s is None:         # replayed-prompt first token
                req.t_first_s = self.now_s
            req.out_tokens.append(nxt)
            self.last_tok[i, 0] = nxt
            if (len(req.out_tokens) >= req.max_new_tokens
                    or nxt == req.eos_id
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
        return requests

    # --- telemetry -------------------------------------------------------

    def telemetry(self) -> dict:
        """Step-time summaries of the prefill and decode meters, plus the
        page-table occupancy stats."""
        return {"prefill": self.prefill_meter.summary(),
                "decode": self.decode_meter.summary(),
                "pages": self.pages.stats()}


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
