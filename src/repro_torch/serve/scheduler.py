"""Admission + length-bucketed continuous-batching scheduler.

The old engine's refill path asserted that every prompt in a refill
group had the *same* length and that the length was a multiple of 16.
The scheduler removes both footguns by bucketing: a prompt of length
``s`` is padded (right, with zeros) to ``bucket_of(s) = ceil(s / bucket)
* bucket`` and only requests sharing a padded length are prefillled
together.  The engine then decodes padded requests correctly by
*replaying* the last real prompt token as the first decode step (see
``engine._fill_slots``) — pad rows in the KV cache are never attended
because decode masks cache positions ``>= pos + 1``, and each pad row is
overwritten before the write position reaches it.

Families with a recurrent prefill state (ssm / hybrid / encdec) cannot
be right-padded — the pad tokens are folded into the SSD/conv state
irreversibly — so for them the scheduler falls back to exact-length
groups (``mixed_lengths=False``), which is precisely the old contract,
now stated instead of asserted.

Policy knobs:

  * ``order`` — ``"fcfs"`` (arrival order) or ``"edf"`` (earliest
    deadline first, with FCFS tie-break; requests without a deadline
    sort last).
  * ``min_free_for_prefill`` — prefill/decode interleaving: a refill
    prefill recompiles nothing but does stall the running decode batch
    for one prefill step, so ``min_free_for_prefill > 1`` batches
    refills until enough slots have drained (amortizing the stall),
    while the default ``1`` is the eager policy.  A fully idle engine
    always refills regardless, so the knob can never deadlock.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.serve.kv_cache import PagedKVCache


def bucket_of(length: int, bucket: int) -> int:
    """Padded prefill length for a prompt of ``length`` tokens."""
    return max(bucket, -(-int(length) // bucket) * bucket)


class Scheduler:
    """Queue + admission + refill-group formation."""

    def __init__(self, *, bucket: int = 16, order: str = "fcfs",
                 mixed_lengths: bool = True,
                 min_free_for_prefill: int = 1,
                 pages: Optional[PagedKVCache] = None):
        if order not in ("fcfs", "edf"):
            raise ValueError(f"unknown order {order!r} (fcfs|edf)")
        self.bucket = bucket
        self.order = order
        self.mixed_lengths = mixed_lengths
        self.min_free_for_prefill = max(1, min_free_for_prefill)
        self.pages = pages
        self.queue: List = []          # pending Requests
        self.rejected: List = []       # admission failures
        self._seq = 0                  # arrival tiebreak counter

    # --- admission -------------------------------------------------------

    def add(self, requests: Sequence) -> List:
        """Enqueue requests, rejecting any that can never fit a slot's
        page frames (prompt bucket + max_new_tokens > max_len).  Returns
        the rejected requests (also marked ``done`` with an ``error``)."""
        bad = []
        for req in requests:
            self._seq += 1
            req._seq = self._seq
            try:
                padded = self.padded_len(len(req.prompt))
            except ValueError as exc:
                # exact-length mode (recurrent families): an unpaddable
                # prompt is an ADMISSION failure, not a session crash
                req.done = True
                req.error = f"rejected: {exc}"
                bad.append(req)
                continue
            if self.pages is not None and not self.pages.can_admit(
                    len(req.prompt), req.max_new_tokens, padded):
                req.done = True
                req.error = (
                    f"rejected: prompt {len(req.prompt)} (padded "
                    f"{padded}) + {req.max_new_tokens} new tokens "
                    f"exceeds max_len {self.pages.max_len}")
                bad.append(req)
                continue
            self.queue.append(req)
        self.rejected.extend(bad)
        return bad

    def padded_len(self, prompt_len: int) -> int:
        if self.mixed_lengths:
            return bucket_of(prompt_len, self.bucket)
        # exact-length mode still needs the sequence-shard divisibility
        if prompt_len % self.bucket:
            raise ValueError(
                f"this model family keeps recurrent prefill state, so "
                f"prompts cannot be bucket-padded: length {prompt_len} "
                f"must be a multiple of {self.bucket}")
        return prompt_len

    # --- refill policy ---------------------------------------------------

    def should_refill(self, free_slots: int, active_slots: int) -> bool:
        """Prefill/decode interleaving: refill when enough slots drained
        (or the engine is fully idle — never starve an empty engine)."""
        if not self.queue or free_slots <= 0:
            return False
        if active_slots == 0:
            return True
        return free_slots >= min(self.min_free_for_prefill,
                                 len(self.queue))

    def next_group(self, free_slots: int) -> Tuple[int, List]:
        """Form one refill group: order the queue by policy, let the
        head request pick the bucket, then take up to ``free_slots``
        queued requests sharing that bucket (in policy order).

        Returns ``(padded_len, requests)``; ``(0, [])`` when empty."""
        if not self.queue or free_slots <= 0:
            return 0, []
        ordered = sorted(self.queue, key=self._key)
        head_bucket = self.padded_len(len(ordered[0].prompt))
        group = [r for r in ordered
                 if self.padded_len(len(r.prompt)) == head_bucket]
        group = group[:free_slots]
        taken = set(id(r) for r in group)
        self.queue = [r for r in self.queue if id(r) not in taken]
        return head_bucket, group

    def _key(self, req):
        if self.order == "edf":
            dl = (req.arrival_s + req.deadline_ms * 1e-3
                  if req.deadline_ms else float("inf"))
            return (dl, req._seq)
        return (req._seq,)

    def __len__(self):
        return len(self.queue)

    def __repr__(self):
        return (f"Scheduler(pending={len(self.queue)}, "
                f"order={self.order}, bucket={self.bucket}, "
                f"mixed={self.mixed_lengths})")
