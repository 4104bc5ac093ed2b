"""Paper Table I / Fig. 7 priced: energy to train tensor- vs
phantom-parallel FFNs to the SAME fixed loss (the counterpart of the JAX
package's ``benchmarks/table1_energy.py``).

It runs no training: it takes the iteration counts of a Table I
mini-run (n = 1024, L = 2, batch 64, p = 8, loss <= 0.175; ``chip_smoke.
py`` runs one on the card), records them with the models' sizes, and
prices the paper-scale projection (n = 16384, L = 2, batch 64, p = 8 to
256) with the paper's model E = nu * p * (A*alpha + B*beta): Frontier's
A = 560 W / B = 90 W and Table III comm fits, alpha at the H100's
float32 peak.  The tensor-parallel run takes the paper's 453 iterations;
the phantom run that many times the mini-run's ratio (k = 4 against
tensor, at most 1).

    PYTHONPATH=src python -m repro_torch.benchmarks.table1_energy \\
        --iterations tensor=168,4=154,8=154,16=180
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.benchmarks.common import emit
from repro_torch.configs.base import (ModelConfig, PhantomConfig,
                                      dense_projection_map,
                                      phantom_projection_map)
from repro_torch.core.energy import (FRONTIER_A_W, FRONTIER_B_W,
                                     H100_PEAK_FLOPS_FP32, energy_to_loss,
                                     phantom_costs, tp_costs)
from repro_torch.core.ffn import ffn_model_params
from repro_torch.telemetry import Ledger
from repro_torch.telemetry.ledger import REPORT_DIR

TABLE1 = dict(n=1024, L=2, batch=64, p=8, target=0.175)
PAPER = dict(n=16_384, L=2, batch=64, tp_iterations=453)
# (p, k) of the paper-scale projection rows
PROJECTION = ((8, 16), (16, 6), (32, 4), (64, 2), (128, 2), (256, 4))
SUITE = "table1_energy"


def table1_config(impl: str, k: int) -> ModelConfig:
    """The mini-run's FFN: tensor-parallel, or phantom of ghost width k."""
    n, L = TABLE1["n"], TABLE1["L"]
    proj = (phantom_projection_map(k, ffn_layer=True,
                                   kernel_backend="pallas")
            if impl == "phantom" else dense_projection_map())
    return ModelConfig(name=f"table1-{impl}-k{k}", family="ffn",
                       num_layers=L, d_model=n, ffn_width=n, ffn_depth=L,
                       mlp="relu", phantom=PhantomConfig(k=k),
                       projections=proj)


def run(ledger: Ledger, iterations: dict) -> list:
    """``iterations``: {"tensor": nu_tp, k: nu_pp, ...}, the mini-run's
    iterations to the target (or its step budget where not reached); k = 4
    must be among them.  Returns the projection rows."""
    p0, target = TABLE1["p"], TABLE1["target"]
    nu_tp = iterations["tensor"]
    size_tp = ffn_model_params(table1_config("tensor", 4), p0)
    emit(ledger, "table1_tp_iters", 0.0,
         f"iters={nu_tp};params={size_tp};loss<={target}", suite=SUITE,
         kind="train", arch="tp", impl="tensor_col", p=p0,
         measured={"iterations": nu_tp, "param_count": size_tp},
         extra={"n": TABLE1["n"], "L": TABLE1["L"], "target_loss": target})
    for k, nu_pp in iterations.items():
        if k == "tensor":
            continue
        size_pp = ffn_model_params(table1_config("phantom", int(k)), p0)
        emit(ledger, f"table1_pp_k{k}_iters", 0.0,
             f"iters={nu_pp};params={size_pp};"
             f"size_ratio={size_pp / size_tp:.3f}", suite=SUITE,
             kind="train", arch=f"pp-k{k}", impl="phantom", p=p0,
             measured={"iterations": nu_pp, "param_count": size_pp},
             extra={"n": TABLE1["n"], "L": TABLE1["L"], "k": int(k),
                    "target_loss": target,
                    "size_ratio_vs_tp": size_pp / size_tp})

    n, L, batch = PAPER["n"], PAPER["L"], PAPER["batch"]
    nu_ratio = min(iterations[4] / max(nu_tp, 1), 1.0)
    nu_tp_paper = PAPER["tp_iterations"]
    rows = []
    for p, k in PROJECTION:
        a_t, b_t = tp_costs(n, p, L, batch, H100_PEAK_FLOPS_FP32)
        a_p, b_p = phantom_costs(n, p, L, k, batch, H100_PEAK_FLOPS_FP32)
        E_tp = energy_to_loss(a_t, b_t, p, nu_tp_paper, FRONTIER_A_W,
                              FRONTIER_B_W)
        E_pp = energy_to_loss(a_p, b_p, p, int(nu_tp_paper * nu_ratio),
                              FRONTIER_A_W, FRONTIER_B_W)
        row = {"p": p, "k": k, "energy_j_tp": E_tp, "energy_j_pp": E_pp,
               "saving_fraction": 1 - E_pp / E_tp,
               "alpha_s_tp": a_t, "beta_s_tp": b_t,
               "alpha_s_pp": a_p, "beta_s_pp": b_p}
        rows.append(row)
        emit(ledger, f"table1_energy_p{p}", 0.0,
             f"E_tp={E_tp:.0f}J;E_pp={E_pp:.0f}J;"
             f"saving={(1 - E_pp / E_tp) * 100:.0f}%", suite=SUITE,
             kind="analytic", p=p,
             predicted={key: v for key, v in row.items()
                        if key not in ("p", "k")},
             extra={"n": n, "L": L, "k": k, "peak_flops": H100_PEAK_FLOPS_FP32,
                    "iters_ratio_measured": nu_ratio})
    return rows


def parse_iterations(text: str) -> dict:
    """"tensor=168,4=154" -> {"tensor": 168, 4: 154}."""
    out = {}
    for item in text.split(","):
        key, value = item.split("=")
        out[key if key == "tensor" else int(key)] = int(value)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iterations", required=True, type=parse_iterations,
                    help="tensor=N,4=N,...: a Table I run's iterations")
    ap.add_argument("--report-out",
                    default=str(REPORT_DIR / "torch_table1_report.json"))
    args = ap.parse_args(argv)
    ledger = Ledger(run=SUITE)
    run(ledger, args.iterations)
    print(f"wrote {ledger.write_report(args.report_out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
