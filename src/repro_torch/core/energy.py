"""The paper's energy and communication models (§II-A, Appendix), as the
JAX package's ``core/energy.py`` has them:

  e(n,p,L)   = A * alpha + B * beta           (Eqn. 1)
  E_lambda   = nu_lambda * e                  (Eqn. 2)
  comm_time(m,p) = c1*log2(p) + c2*m + c3     (Eqn. 26, microseconds)

with the Frontier-fitted Table III constants (the paper's), plus the
H100's peak rates from its datasheet, which price the compute term
(alpha) and the roofline of a step on the card.  The per-iteration costs
are sums over ``ProjectionStrategy.flops()`` / ``comm_events()``: the
account of the very operators a step runs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


# --- hardware constants ----------------------------------------------------

# Frontier (paper §II-A): dynamic/static power per GCD.
FRONTIER_A_W = 560.0
FRONTIER_B_W = 90.0

# Paper Table III: comm_time(m, p) = c1*log2 p + c2*m [+ c3~0], microseconds,
# m in floats (4 bytes).  ``collective_permute`` is the point-to-point
# stage-boundary transfer of pipeline parallelism — a SINGLE hop, so its
# c1 is charged once instead of log2(p) times (``comm_time_us`` special-
# cases it); the paper has no p2p fit, so it is priced with the broadcast
# constants.
P2P_COLLECTIVES = ("collective_permute", "p2p")

PAPER_COLLECTIVE_FITS = {
    "broadcast":      (35.5, 1.12e-3),
    "all_reduce":     (33.4, 2.56e-3),
    "all_gather":     (149.94, 2.07e-3),
    "reduce_scatter": (145.52, 2.40e-3),
    "collective_permute": (35.5, 1.12e-3),
}

# NVIDIA H100 SXM5 80GB datasheet, 700 W; until calibrated.  The paper-FFN
# trains in float32 on the CUDA cores (torch leaves TF32 off for matmuls),
# so the float32 rate is the default peak.
H100_PEAK_FLOPS_FP32 = 67e12     # FLOP/s, CUDA cores
# NVIDIA H100 SXM5 80GB datasheet, 700 W; until calibrated.
H100_PEAK_FLOPS_BF16 = 989e12    # FLOP/s, dense tensor cores
# NVIDIA H100 SXM5 80GB datasheet, 700 W; until calibrated.
H100_HBM_BW = 3.35e12            # bytes/s
# NVIDIA H100 SXM5 80GB datasheet, 700 W; until calibrated.
H100_NVLINK_BW = 450e9           # bytes/s per direction, all to all
# assumed per-log2(p)-hop latency of an NVLink collective, until calibrated
H100_HOP_LATENCY_US = 1.0


def h100_collective_fits() -> dict:
    """H100 analogues of the paper's Table III (c1, c2) constants,
    derived from the NVLink rate rather than fitted: c2 is the wire time
    per float (4 bytes over one direction of NVLink; doubled for
    all-reduce's reduce-scatter and all-gather phases), c1 the
    per-log2(p)-hop latency (``H100_HOP_LATENCY_US``).  Pass the result
    as ``fits=`` to ``comm_time_us`` to price Eqn. 26 on the card's
    links instead of Frontier's."""
    c1 = H100_HOP_LATENCY_US
    c2 = 4.0 / H100_NVLINK_BW * 1e6                  # us per float
    return {
        "broadcast":      (c1, c2),
        "all_gather":     (c1, c2),
        "reduce_scatter": (c1, c2),
        "all_reduce":     (c1, 2.0 * c2),
        "collective_permute": (c1, c2),
    }


def comm_time_us(collective: str, m_floats: float, p: int,
                 fits=None) -> float:
    """Paper Eqn. 26 with Table III constants (returns microseconds).

    Point-to-point transfers (``collective_permute`` — pipeline stage
    boundaries) are a single neighbour hop: c1 + c2*m, with no log2(p)
    latency term (``p`` only gates the degenerate single-rank case).
    """
    table = fits or PAPER_COLLECTIVE_FITS
    if collective in P2P_COLLECTIVES:
        if p <= 1:
            return 0.0
        c1, c2 = table["collective_permute"]
        return c1 + c2 * m_floats
    c1, c2 = table[collective]
    if p <= 1:
        return 0.0
    return c1 * math.log2(p) + c2 * m_floats


# --- per-iteration cost models (paper Eqns. 3-4, 24-25) -------------------

TRAIN_PASS_FACTOR = 3.0   # fwd + bwd-input + bwd-weight GEMMs


def costs_from_strategies(strategies, p: int, L: int, batch: int,
                          peak_flops: float = H100_PEAK_FLOPS_FP32,
                          fits=None, training: bool = True):
    """(alpha_sec, beta_sec) per iteration for L layers, each executing
    the given projection strategies once per pass.

    alpha: per-rank flops summed over strategies (x3 for training: the
    backward re-runs each GEMM twice — input grads + weight grads).
    beta:  paper Eqn. 26 comm time summed over each strategy's fwd+bwd
    collective events (forward only when not training).
    """
    pass_factor = TRAIN_PASS_FACTOR if training else 1.0
    flops_rank = sum(st.flops(batch) for st in strategies) * pass_factor * L
    alpha = flops_rank / peak_flops
    us = 0.0
    for st in strategies:
        for ev in st.comm_events(batch):
            if not training and ev.phase == "bwd":
                continue
            us += comm_time_us(ev.collective, ev.m_floats, p, fits)
    beta = us * L * 1e-6
    return alpha, beta


def tp_costs(n: int, p: int, L: int, batch: int,
             peak_flops: float = H100_PEAK_FLOPS_FP32, fits=None):
    """(alpha_sec, beta_sec) per iteration for TP training of an n-wide,
    L-layer FFN: the ``tensor_col`` strategy's account (6*n^2*batch/p
    flops + AG/RS of (n/p)*batch floats per layer)."""
    from repro_torch.parallel.strategies import TensorColStrategy
    st = TensorColStrategy(n, n, p, bias=True)
    return costs_from_strategies([st], p, L, batch, peak_flops, fits)


def phantom_costs(n: int, p: int, L: int, k: int, batch: int,
                  peak_flops: float = H100_PEAK_FLOPS_FP32, fits=None):
    """(alpha_sec, beta_sec) per iteration for phantom-parallel training:
    the ``phantom`` strategy's account (6*((n/p)^2 + k*n)*batch flops per
    rank + AG/RS of k*batch ghost floats per layer)."""
    from repro_torch.configs.base import ProjectionSpec
    from repro_torch.parallel.strategies import make_strategy
    st = make_strategy(ProjectionSpec(kind="phantom", k=k), n, n, p,
                       bias=True)
    return costs_from_strategies([st], p, L, batch, peak_flops, fits)


def pipeline_p2p_time_us(schedule, m_floats: float, fits=None, *,
                         executed: bool = False) -> float:
    """Per-device microseconds of stage-boundary p2p traffic for one
    iteration of a ``PipelineSchedule`` — each event priced as a single
    ``collective_permute`` hop of ``m_floats`` (the carried activation /
    activation-grad shard)."""
    return sum(comm_time_us(ev.collective, ev.m_floats, schedule.stages,
                            fits)
               for ev in schedule.p2p_events(m_floats, executed=executed))


def energy_per_iteration(alpha_s: float, beta_s: float, p: int,
                         A: float = FRONTIER_A_W,
                         B: float = FRONTIER_B_W) -> float:
    """Paper Eqn. 1, summed over the p ranks (Joules/iteration)."""
    return p * (A * alpha_s + B * beta_s)


def energy_to_loss(alpha_s: float, beta_s: float, p: int, iterations: int,
                   A: float = FRONTIER_A_W, B: float = FRONTIER_B_W) -> float:
    """Paper Eqn. 2: E = nu * e."""
    return iterations * energy_per_iteration(alpha_s, beta_s, p, A, B)


@dataclass(frozen=True)
class RooflineTerms:
    """The three roofline terms, in seconds (per device)."""
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        # overlap model: memory traffic hides behind compute within fused
        # ops; collectives assumed exposed unless explicitly overlapped.
        return max(self.compute_s, self.memory_s) + self.collective_s

    def fraction_of_roofline(self) -> float:
        """useful-compute / achievable-step-time (1.0 = compute-bound and
        fully overlapped)."""
        if self.step_s == 0:
            return 0.0
        return self.compute_s / self.step_s


def roofline_terms(flops_per_device: float, hbm_bytes_per_device: float,
                   link_bytes_per_device: float,
                   peak_flops: float = H100_PEAK_FLOPS_FP32,
                   hbm_bw: float = H100_HBM_BW,
                   link_bw: float = H100_NVLINK_BW) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_device / peak_flops,
        memory_s=hbm_bytes_per_device / hbm_bw,
        collective_s=link_bytes_per_device / link_bw,
    )
