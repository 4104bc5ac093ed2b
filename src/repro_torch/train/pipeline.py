"""Pipeline parallelism: the 1F1B schedule and the engine that executes it.
The port of the JAX package's ``train/pipeline.py``.

Two halves, one object each:

  * ``PipelineSchedule``: the ANALYTIC side, the reference's unchanged.
    Given (stages, microbatches) it produces the canonical
    non-interleaved 1F1B order (warmup/steady/drain), the bubble
    fraction, the 1F1B in-flight activation bound, and the per-device
    stage-boundary ``CommEvent`` account that ``core/energy.py`` and
    ``telemetry/predict.py`` price, and the ``pipeline_bubble_fraction``
    gauge.

  * ``pipeline_run``: the EXECUTED side.  The reference runs a wavefront
    of ``M + S - 1`` ticks in one SPMD program whose bubbles compute on
    masked garbage, and its autodiff transposes the ``ppermute``s into
    the backward pipeline.  The port runs one process per rank, so each
    stage walks its own ``PipelineSchedule.table(stage)``: a forward
    receives the microbatch's activation from the previous stage, runs
    the stage and sends its output on; a backward receives the output's
    gradient from the next stage, back-propagates through the stage and
    sends the input's gradient back.  Bubbles idle and compute nothing.
    The gradients are the same sums as the reference's.

On a pp = 1 mesh the same engine runs the whole model per microbatch,
one microbatch after another: the reference's equivalence path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.strategies.base import CommEvent


# ---------------------------------------------------------------------------
# the schedule (analytic)
# ---------------------------------------------------------------------------

def one_f_one_b(stages: int, microbatches: int,
                stage: int) -> List[Tuple[str, int]]:
    """``PipelineSchedule(stages, microbatches).table(stage)``, without
    the schedule's gauge: what ``pipeline_run`` walks every step."""
    M, w = microbatches, min(stages - 1 - stage, microbatches)
    ops: List[Tuple[str, int]] = [("F", i) for i in range(w)]
    b = 0
    for f in range(w, M):
        ops.append(("F", f))
        ops.append(("B", b))
        b += 1
    ops.extend(("B", i) for i in range(b, M))
    return ops


@dataclass(frozen=True)
class PipelineSchedule:
    """Non-interleaved 1F1B over ``microbatches`` microbatches and
    ``stages`` pipeline stages."""

    stages: int
    microbatches: int

    def __post_init__(self):
        if self.stages < 1 or self.microbatches < 1:
            raise ValueError(f"need stages >= 1 and microbatches >= 1, "
                             f"got {self.stages}/{self.microbatches}")
        from repro_torch.obs import get_metrics
        get_metrics().gauge(
            "pipeline_bubble_fraction",
            "idle fraction of the 1F1B timeline, (S-1)/(M+S-1)").set(
                self.bubble_fraction, stages=str(self.stages),
                microbatches=str(self.microbatches))

    # --- wavefront geometry ------------------------------------------------

    @property
    def num_ticks(self) -> int:
        """Clock ticks of one forward (or one backward) wavefront."""
        return self.microbatches + self.stages - 1

    @property
    def bubble_fraction(self) -> float:
        """Idle fraction of the 1F1B timeline: (S-1)/(M+S-1)."""
        return (self.stages - 1) / self.num_ticks

    def makespan_ticks(self, t_fwd: float = 1.0, t_bwd: float = 2.0) -> float:
        """1F1B makespan in stage-compute units: (M + S - 1)(t_f + t_b).
        The useful work per stage is M(t_f + t_b); the rest is bubble."""
        return self.num_ticks * (t_fwd + t_bwd)

    def warmup(self, stage: int) -> int:
        """Forward microbatches stage ``stage`` runs before its first
        backward (the 1F1B warmup depth)."""
        return min(self.stages - 1 - stage, self.microbatches)

    def max_in_flight(self, stage: int) -> int:
        """Peak activations stage ``stage`` holds under 1F1B — min(M, S-s),
        versus GPipe's M."""
        return min(self.microbatches, self.stages - stage)

    def table(self, stage: int) -> List[Tuple[str, int]]:
        """The canonical per-stage 1F1B op order: [("F", mb) | ("B", mb)].
        Warmup forwards, then strict 1F1B alternation, then the drain."""
        return one_f_one_b(self.stages, self.microbatches, stage)

    # --- stage-boundary communication account ------------------------------

    def stage_bounds(self, num_layers: int) -> List[Tuple[int, int]]:
        """[lo, hi) layer range per stage (earlier stages take the
        remainder when the stack doesn't divide evenly)."""
        S = self.stages
        base, extra = divmod(num_layers, S)
        bounds, lo = [], 0
        for s in range(S):
            hi = lo + base + (1 if s < extra else 0)
            bounds.append((lo, hi))
            lo = hi
        return bounds

    def p2p_events(self, m_floats: float, *,
                   executed: bool = False) -> List[CommEvent]:
        """Per-device stage-boundary transfers for ONE iteration, in paper
        Eqn. 26 units (m = per-rank message floats).

        ``executed=False`` is the ideal deployment account: every interior
        boundary moves each microbatch once forward (activation) and once
        backward (activation grad) — M sends per device per direction.
        The port's ``pipeline_run`` executes this account, except that an
        end stage has no neighbour on one side (the ledger's per-rank
        figure, ``telemetry/probe.py``).

        ``executed=True`` is the reference's SPMD wavefront, which issues
        a ppermute at every tick but the last, forward and
        transposed-backward alike — (M + S - 2) per direction.
        """
        if self.stages <= 1:
            return []
        n = (self.num_ticks - 1) if executed else self.microbatches
        return ([CommEvent("collective_permute", m_floats, "fwd")] * n
                + [CommEvent("collective_permute", m_floats, "bwd")] * n)


# ---------------------------------------------------------------------------
# the engine (executed, one rank)
# ---------------------------------------------------------------------------

def pipeline_run(stage_fn: Callable[[torch.Tensor], torch.Tensor],
                 x_mb: torch.Tensor, axes: MeshAxes,
                 loss_fn: Callable[[torch.Tensor, int], torch.Tensor], *,
                 input_grad: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run this rank's 1F1B over pre-split microbatches, forward and
    backward.

    ``stage_fn(x) -> z`` applies THIS rank's stage to one microbatch
    activation (under pp = 1 it applies ALL stages in turn); its
    parameters are leaves that require grad, and their ``.grad``
    accumulates over the microbatches.  A stage with a loss of its own
    (the MoE balance loss) returns ``(z, aux)`` instead: the scalar
    ``aux`` is back-propagated with the stage's output.  ``x_mb`` is ``[M, ...]`` of
    stage-0 inputs (local shards; only stage 0 reads their values, the
    other stages only their shape and dtype); every stage's input and
    output are shaped and typed like ``x_mb[i]`` (the FFN's feature
    shard, the LM's residual stream), which is what a receive expects.
    ``loss_fn(z, i)`` is microbatch ``i``'s loss from the last stage's
    output.

    Returns ``(loss, x_grad)``: the sum of the last stage's microbatch
    losses (zero on other stages) and, with ``input_grad`` on stage 0,
    the gradient w.r.t. ``x_mb`` (``[M, ...]``), else None.  Every send
    has ended when it returns.
    """
    M, S, s = x_mb.shape[0], axes.pp, axes.pp_rank
    first, last = s == 0, s == S - 1
    pipe = axes.pp_comm
    held = {}          # microbatch -> (stage input, stage output or loss)
    sends = []
    loss = torch.zeros((), dtype=x_mb.dtype, device=x_mb.device)
    x_grad = torch.zeros_like(x_mb) if first and input_grad else None
    for op, i in one_f_one_b(S, M, s):
        if op == "F":
            x = x_mb[i] if first else pipe.recv(x_mb[i], s - 1)
            x = x.detach().requires_grad_(not first or input_grad)
            z = stage_fn(x)
            z, aux = z if isinstance(z, tuple) else (z, None)
            if last:
                z = loss_fn(z, i)
                loss = loss + z.detach()
            else:
                sends.append(pipe.send(z, s + 1))
            held[i] = (x, z, aux)
        else:
            x, z, aux = held.pop(i)
            dz = None if last else pipe.recv(z, s + 1)
            if aux is not None and aux.requires_grad:
                torch.autograd.backward([z, aux], [dz, None])
            else:
                torch.autograd.backward(z, dz)
            if not first:
                sends.append(pipe.send(x.grad, s - 1))
            elif x_grad is not None:
                x_grad[i] = x.grad
    for sent in sends:
        sent.wait()
    return loss, x_grad


def batch_axis(key) -> int:
    """The batch axis of a batch leaf: 1 for M-RoPE's ``positions``
    ``[3, B, S]``, 0 for every other leaf."""
    return 1 if key == "positions" else 0


def split_batch_microbatches(batch, M: int):
    """Split every leaf of a batch (a nested dict of tensors) into M
    microbatches along its batch axis (``batch_axis``)."""
    def split(key, x):
        if isinstance(x, dict):
            return {k: split(k, v) for k, v in x.items()}
        return split_microbatches(x, M, axis=batch_axis(key))
    return split(None, batch)


def split_microbatches(x: torch.Tensor, M: int, axis: int = 0):
    """[..., B, ...] -> [M, ..., B/M, ...] along ``axis`` (leading
    microbatch dim), preserving row order within each microbatch."""
    B = x.shape[axis]
    if B % M:
        raise ValueError(f"batch axis {B} not divisible by "
                         f"{M} microbatches")
    xs = x.reshape(x.shape[:axis] + (M, B // M) + x.shape[axis + 1:])
    return xs.movedim(axis, 0)
