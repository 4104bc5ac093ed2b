"""The bf16 phantom forward's and dgrad's wgmma launches on the card:
where a launch's fixed time goes, the constants of ``wg_plan``'s
estimate, and the plan against every other launch it could make.

    PYTHONPATH=src python -m repro_torch.benchmarks.wgmma_plan \\
        [--parts floor,check,fit,sites] [--out build/wgmma_plan.json]

Kernel-only, on one card (``chip_smoke.py`` drives the paths):

* ``floor``: the forward at a 4-row site (mamba2-370m's in-projection at
  tp 4, x [4, 256], L [256, 512], PK 32) through a probe built from the
  same source (``csrc/wgmma_probe.cu``): an empty kernel launched as the
  forward's is, the kernel with no tile, every tile with no slab, one
  slab and the whole job, with and without the cluster attribute at
  S = 1, at the one-shape plan's 128 x 256 and at the plan's shape;
* ``check``: every instance (tile shape) of both products at every split
  it can run, M of 1 to 2,048, K and N up to 512, against the plain
  version within 2e-2, and a second launch bit for bit;
* ``fit``: each shape's slab time with every SM busy (a full wave of
  tiles, 64 slabs against 32), for ``WG_SLAB_US``;
* ``sites``: at each bf16 LM site of PERF.md rows b-n, every launch of
  ``wg_candidates`` timed, the plan's pick, the one-shape plan (every
  call at 128 x 256, split by ``wg_split`` with its reduction priced as a
  whole tile) and ``torch.mm`` on the joined operands; then a least-
  squares fit of the split's constants (``WG_SPLIT_US``,
  ``WG_SPLIT_US_PER_KB``) with the slab times of ``fit`` and one
  intercept per site.

Times are CUDA-graph replays of 20 calls (the median of 5), operands
resident in L2, as ``chip_smoke.py: time_ms``.  Prints each line and
writes the whole as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels import phantom_fused as pf
from repro_torch.kernels.ref import matmul_nt_ref, phantom_fused_ref

PROBE_SRC = Path(__file__).resolve().parent / "csrc" / "wgmma_probe.cu"
# (M, K, N, PK) of the bf16 phantom sites, PERF.md rows b-n, and the
# main and pipeline-stage shapes of rows 2 and 3
SITES = {
    "b": [(2048, 768, 2048, 48), (2048, 2048, 768, 48)],
    "c": [(2048, 1280, 3456, 64), (2048, 3456, 1280, 64)],
    "d": [(512, 1536, 4096, 24), (512, 4096, 1536, 24)],
    "e": [(2048, 512, 512, 32)],
    "f": [(2048, 256, 512, 32), (2048, 512, 256, 32)],
    "g": [(1024, 1536, 4096, 24), (1024, 4096, 1536, 24)],
    "h": [(2048, 2048, 6144, 128), (2048, 6144, 2048, 128)],
    "i": [(2048, 2048, 7392, 128), (2048, 7392, 2048, 128)],
    "j": [(2048, 256, 2048, 32), (2048, 2048, 256, 32)],
    "k": [(M, K, N, 64) for M in (4, 192)
          for K, N in ((1024, 3424), (3424, 1024))],
    "l": [(M, K, N, 32) for M in (4, 192)
          for K, N in ((512, 512), (256, 512), (512, 256), (256, 2048),
                       (2048, 256))],
    "m": [(M, K, N, PK) for M in (4, 192)
          for K, N, PK in ((2048, 6144, 128), (6144, 2048, 128),
                           (1280, 3456, 64), (3456, 1280, 64),
                           (2048, 7392, 128), (7392, 2048, 128))],
    "n": [(2048, 1536, 1536, 8), (2048, 1536, 4096, 8),
          (2048, 4096, 1536, 8)],
    "main": [(64, 2048, 2048, 128), (8, 8192, 8192, 32)],
}
FLOOR_SITE = (4, 256, 512, 32)
CHECK_ROWS = (1, 4, 8, 63, 64, 65, 192, 2048)
CHECK_TOL = 2e-2
PRODUCTS = ("forward", "dgrad")


def time_us(fn, reps=20, trials=5):
    """Device microseconds a call: ``reps`` calls captured in one CUDA
    graph, replayed ``trials`` times between CUDA events (the median)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps * 1e3)
    return statistics.median(times)


def one_shape_plan(row_parts, col_parts, seg_lens, dgrad, resident):
    """The one-shape plan: every call at 128 x 256 tiles, ``wg_split``'s
    splits (a reduction priced as ``WG_SPLIT_SLABS`` slabs whatever the
    tile holds) -- what the wgmma route ran before it chose a tile shape
    per call, kept as the yardstick of ``wg_plan``."""
    shape = pf.WG_SHAPES[0]
    tiles = pf._tiles(row_parts, shape[0]) * pf._tiles(col_parts, shape[1])
    slabs = sum(-(-k // pf.WG_BK) for k in seg_lens)
    splits, blocks = pf.wg_split(tiles, slabs, resident[shape])
    return pf.GemmPlan(shape[0], shape[1], pf.WG_BK, pf.WG_RING[shape],
                       splits,
                       (blocks, 1), (splits, 1, 1), "wgmma",
                       pf.WG_SMEM_BYTES[shape], slabs, dgrad, 2, tiles)


def site_parts(M, K, N, PK, product):
    """(row parts, column parts, contraction segments) of a product."""
    if product == "forward":
        return (M,), (N,), (K, PK)
    return (M,), (K, PK), (N,)


class Site:
    """Aligned bf16 operands of one (M, K, N, PK) on the card, the calls
    of both products on any plan, their plain versions and library
    calls."""

    def __init__(self, M, K, N, PK, gen):
        def r(*shape):
            return (torch.randn(*shape, device="cuda", generator=gen)
                    * 0.3).to(torch.bfloat16)
        self.shape = (M, K, N, PK)
        self.x, self.L, self.g, self.D, self.dz = (
            r(M, K), r(K, N), r(M, PK), r(PK, N), r(M, N))
        self.xg = torch.cat([self.x, self.g], 1)
        self.LD = torch.cat([self.L, self.D])
        self.LDt = self.LD.t()

    def resident(self, product):
        return pf._wg_resident(product, self.x)

    def plans(self, product):
        """The plan, the one-shape plan and every candidate."""
        parts = site_parts(*self.shape, product)
        resident = self.resident(product)
        dgrad = product == "dgrad"
        return (pf.wg_plan(*parts, dgrad, resident),
                one_shape_plan(*parts, dgrad, resident),
                pf.wg_candidates(*parts, dgrad, resident))

    def call(self, product, plan):
        if product == "forward":
            return lambda: pf._launch_forward(self.x, self.L, self.g,
                                              self.D, plan)
        return lambda: pf._launch_nt(self.dz, self.L, self.D, plan)

    def plain(self, product):
        if product == "forward":
            return phantom_fused_ref(self.x, self.L, self.g, self.D)
        return matmul_nt_ref(self.dz, self.LD)

    def library(self, product):
        if product == "forward":
            return lambda: torch.mm(self.xg, self.LD)
        return lambda: torch.mm(self.dz, self.LDt)


def _held(got, want):
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool(
        (diff <= CHECK_TOL + CHECK_TOL * want.float().abs()).all())


def _describe(plan):
    return {"bm": plan.bm, "bn": plan.bn, "splits": plan.splits,
            "blocks": plan.grid[0], "tiles": plan.tiles,
            "est_us": plan.est_us}


def _probe_library():
    out = build.BUILD_DIR / "wgmma_probe.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-o", str(out), str(PROBE_SRC)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_wgmma_probe.argtypes = [p] * 5 + [i] * 4 + [ll] * 5 + \
        [i] * 6 + [p]
    lib.repro_wgmma_probe.restype = ctypes.c_int
    return lib


def part_floor(gen):
    """The forward at FLOOR_SITE through the probe: each cut of the job,
    the tiles' stores alone (the kernels' epilogue, and two-element stores
    with no shuffle) and, at S = 1, with and without the
    cluster attribute; at the one-shape plan (128 x 256, S = 1), the
    plan's pick, and each shape at S = 1 and at its largest split."""
    lib = _probe_library()
    site = Site(*FLOOR_SITE, gen)
    M, K, N, PK = FLOOR_SITE
    plan, one, cands = site.plans("forward")
    z = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
    base = (site.x.data_ptr(), site.L.data_ptr(), site.g.data_ptr(),
            site.D.data_ptr(), z.data_ptr(), M, K, N, PK,
            site.x.stride(0), site.L.stride(0), site.g.stride(0),
            site.D.stride(0), z.stride(0))
    whats = ("empty kernel", "set-up", "epilogue, no slab", "one slab",
             "whole job", "stores: epilogue", "stores: two-element")
    probes = [("one-shape", one), ("plan", plan)]
    for shape in pf.WG_SHAPES:
        mine = [c for c in cands if (c.bm, c.bn) == shape]
        probes += [("S=1", mine[0]), ("largest S", mine[-1])]
    out = []
    for label, p in probes:
        for cluster in ((0, 1) if p.splits == 1 else (1,)):
            for what, name in enumerate(whats):
                if cluster and what >= 5:
                    continue
                def call(p=p, what=what, cluster=cluster):
                    err = lib.repro_wgmma_probe(
                        *base, p.bm, p.bn, p.splits, p.grid[0], what,
                        cluster, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"probe {what}: error {err}")
                us = time_us(call)
                row = {"plan": label, **_describe(p), "cluster": cluster,
                       "what": name, "us": us}
                out.append(row)
                print(f"floor {FLOOR_SITE} {label} {p.bm}x{p.bn} "
                      f"S={p.splits} blocks={p.grid[0]} cluster={cluster} "
                      f"{name}: {us:.2f} us", flush=True)
    out.append({"what": "torch.mm", "us": time_us(site.library("forward"))})
    print(f"floor {FLOOR_SITE} torch.mm: {out[-1]['us']:.2f} us",
          flush=True)
    return out


def part_check(gen):
    """Every instance of both products at every split it can run, at M
    of CHECK_ROWS with K, N <= 512 (D's narrow tiles, both forward
    segments, splits whose tiles have fewer real rows than BM)."""
    out, bad = [], []
    for M in CHECK_ROWS:
        site = Site(M, 384, 448, 24, gen)
        for product in PRODUCTS:
            want = site.plain(product)
            _, _, cands = site.plans(product)
            for p in cands:
                fn = site.call(product, p)
                got = fn()
                torch.cuda.synchronize()
                err, ok = _held(got, want)
                again = torch.equal(got, fn())
                row = {"M": M, "product": product, **_describe(p),
                       "max_abs_err": err, "ok": ok and again,
                       "bitwise": again}
                out.append(row)
                if not row["ok"]:
                    bad.append(row)
        print(f"check M={M}: {sum(r['ok'] for r in out if r['M'] == M)} "
              f"of {sum(r['M'] == M for r in out)} launches held", flush=True)
    if bad:
        print(f"check FAILED: {bad}", flush=True)
    return out, bad


def part_fit(gen):
    """Each shape's slab time with every SM busy: a full wave of tiles
    (the card's clusters of 1, as 12 k row tiles by 11 column tiles)
    at 64 slabs against 32; the difference over 32 slabs."""
    out = {}
    for product in PRODUCTS:
        for shape in pf.WG_SHAPES:
            bm, bn = shape
            full = pf._wg_resident(product, torch.empty(
                1, device="cuda"))[shape][1]
            rows, cols = full // 11, 11
            times = {}
            for slabs in (32, 64):
                if product == "forward":
                    M, K, N, PK = bm * rows, pf.WG_BK * (slabs - 1), \
                        bn * cols, pf.WG_BK
                else:
                    M, K, N, PK = bm * rows, bn * cols, pf.WG_BK * slabs, 0
                site = Site(M, K, N, max(PK, 8), gen)
                parts = site_parts(M, K, N, PK, product)
                tiles = pf._tiles(parts[0], bm) * pf._tiles(
                    [p for p in parts[1] if p], bn)
                plan = pf.GemmPlan(bm, bn, pf.WG_BK, pf.WG_RING[shape], 1,
                                   (tiles, 1), (1, 1, 1), "wgmma",
                                   pf.WG_SMEM_BYTES[shape], slabs,
                                   product == "dgrad", 2, tiles)
                if product == "forward":
                    fn = site.call(product, plan)
                else:
                    fn = (lambda s=site, p=plan:
                          pf._launch_nt(s.dz, s.L, None, p))
                times[slabs] = time_us(fn)
            slab_us = (times[64] - times[32]) / 32
            out[f"{product} {bm}x{bn}"] = {"blocks": full, "us": times,
                                           "slab_us": slab_us}
            print(f"fit {product} {bm}x{bn}: {full} blocks, 32 slabs "
                  f"{times[32]:.2f} us, 64 slabs {times[64]:.2f} us: "
                  f"{slab_us:.4f} us a slab", flush=True)
    return out


def part_sites(gen):
    """At each site: every candidate timed, the plan's pick, the
    one-shape plan and ``torch.mm``."""
    out = []
    for row, shapes in SITES.items():
        for shape in shapes:
            site = Site(*shape, gen)
            for product in PRODUCTS:
                plan, one, cands = site.plans(product)
                timed = []
                for p in cands:
                    timed.append({**_describe(p),
                                  "us": time_us(site.call(product, p))})
                lib_us = time_us(site.library(product))
                key = (plan.bm, plan.bn, plan.splits)
                plan_us = next(t["us"] for t in timed
                               if (t["bm"], t["bn"], t["splits"]) == key)
                one_us = time_us(site.call(product, one))
                best = min(timed, key=lambda t: t["us"])
                out.append({"row": row, "shape": list(shape),
                            "product": product, "plan": _describe(plan),
                            "plan_us": plan_us, "one_shape": _describe(one),
                            "one_shape_us": one_us, "best": best,
                            "library_us": lib_us, "candidates": timed})
                print(f"site {row} {shape} {product}: plan "
                      f"{plan.bm}x{plan.bn} S={plan.splits} "
                      f"blocks={plan.grid[0]} {plan_us:.2f} us; one-shape "
                      f"S={one.splits} blocks={one.grid[0]} {one_us:.2f} "
                      f"us; best {best['bm']}x{best['bn']} "
                      f"S={best['splits']} {best['us']:.2f} us; torch.mm "
                      f"{lib_us:.2f} us", flush=True)
    return out


def fit_plan(sites, resident, slab_us):
    """``WG_REFILL_US``, ``WG_SPLIT_US`` and ``WG_SPLIT_US_PER_KB`` on a
    grid, with the slab times of ``fit``: the constants under which
    ``wg_plan``'s picks are over 5% slower than the one-shape plan at the
    fewest sites, then the least slower than each site's fastest
    candidate on average.  Returns them with those two numbers."""
    import itertools
    slab = {(p, tuple(int(v) for v in k.split("x"))): t
            for (p, k), t in ((key.split(" "), t)
                              for key, t in slab_us.items())}
    cases = []
    for site in sites:
        M, K, N, PK = site["shape"]
        rows, cols, segs = site_parts(M, K, N, PK, site["product"])
        slabs = sum(-(-k // pf.WG_BK) for k in segs)
        cands = [(c, (c["bm"], c["bn"])) for c in site["candidates"]]
        cases.append((site, slabs, min(rows), max(cols), cands))
    best = None
    grid = itertools.product([i / 4 for i in range(13)],
                             [i / 4 for i in range(17)],
                             [i / 100 for i in range(21)])
    for refill, split, per_kb in grid:
        worse, ratio = 0, 0.0
        for site, slabs, rows, cols, cands in cases:
            def est(cs):
                c, shape = cs
                table = resident[f"{site['product']} {shape[0]}x{shape[1]}"]
                return pf.wg_estimate_us(
                    site["product"], shape, c["tiles"], slabs, c["splits"],
                    c["blocks"], min(shape[0], rows), min(shape[1], cols),
                    {int(k): v for k, v in table.items()}, slab, refill,
                    split_us=split, split_us_per_kb=per_kb)
            pick = min(cands, key=est)[0]
            worse += pick["us"] > 1.05 * site["one_shape_us"]
            ratio += pick["us"] / site["best"]["us"]
        key = (worse, ratio / len(cases))
        if best is None or key < best[0]:
            best = (key, refill, split, per_kb)
    (worse, ratio), refill, split, per_kb = best
    return {"refill_us": refill, "split_us": split,
            "split_us_per_kb": per_kb, "sites_over_one_shape": worse,
            "mean_of_fastest": ratio}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks.wgmma_plan",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="floor,check,fit,sites")
    ap.add_argument("--out", default="build/wgmma_plan.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wgmma_plan: no CUDA device; it measures the card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = build.build(["phantom_fused"])
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for line in logs.get("phantom_fused", "").splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    parts = args.parts.split(",")
    res = {"nvidia_smi": smi, "torch": torch.__version__,
           "device": torch.cuda.get_device_name(0),
           "constants": {"slab_us": {f"{p} {s[0]}x{s[1]}": v for (p, s), v
                                     in pf.WG_SLAB_US.items()},
                         "refill_us": pf.WG_REFILL_US,
                         "split_us": pf.WG_SPLIT_US,
                         "split_us_per_kb": pf.WG_SPLIT_US_PER_KB}}
    x = torch.empty(1, device="cuda")
    res["resident"] = {f"{p} {s[0]}x{s[1]}": t for p in PRODUCTS + ("wgrad",)
                       for s, t in pf._wg_resident(p, x).items()}
    print(f"resident clusters by S: {res['resident']}", flush=True)
    ok = True
    if "floor" in parts:
        res["floor"] = part_floor(gen)
    if "check" in parts:
        res["check"], bad = part_check(gen)
        ok = ok and not bad
    if "fit" in parts:
        res["fit"] = part_fit(gen)
    if "sites" in parts:
        res["sites"] = part_sites(gen)
        slab = ({k: v["slab_us"] for k, v in res["fit"].items()}
                if "fit" in res else res["constants"]["slab_us"])
        res["fitted"] = fit_plan(res["sites"], res["resident"], slab)
        print(f"fitted: {res['fitted']}", flush=True)
        worse = [s for s in res["sites"]
                 if s["plan_us"] > 1.05 * s["one_shape_us"]]
        print(f"sites where the plan is over 5% slower than the one-shape "
              f"plan: {[(s['row'], s['shape'], s['product']) for s in worse]}",
              flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(f"written to {out}", flush=True)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
