"""The planner's search space: the port's copy of the reference's
``planner/space.py`` (mesh shape x strategy x ghost width x microbatch).

A ``PlanCandidate`` is one fully specified configuration; it may use
FEWER devices than are available: the paper's claim is that a phantom
plan on a smaller mesh can match a tensor-parallel plan on the full mesh
at lower energy.  ``model_config()`` turns a candidate into the port's
``ModelConfig``, the strategy selected through ``projections``.  The
port's ``ModelConfig`` has no ``scan_layers`` (ROADMAP.md queue 3), so
that field is carried in ``name`` and ``as_dict`` only.
``kernel_backend`` keeps the reference's ``"xla"`` default, which the
port reads as its plain torch core.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.configs.base import (PHANTOM_KINDS, PROJECTION_SITES,
                                      ModelConfig, PipelineConfig,
                                      ProjectionMap, ProjectionSpec)


@dataclass(frozen=True)
class PlanCandidate:
    """One point of the search space (the paper-FFN subject)."""

    dp: int                        # data-parallel ways
    tp: int                        # model-parallel ways (the paper's p)
    strategy: str                  # projection kind at `site`
    width: int                     # model width n
    depth: int                     # layers L
    batch: int                     # global batch rows per step
    k: int = 0                     # ghost width (phantom family only)
    pp: int = 1                    # pipeline stages
    site: str = "ffn_layer"        # projection site the strategy binds to
    microbatches: int = 1
    scan_layers: bool = True
    variant: str = "fused"
    kernel_backend: str = "xla"    # xla | pallas | auto

    @property
    def devices(self) -> int:
        return self.dp * self.tp * self.pp

    @property
    def name(self) -> str:
        tag = f"{self.strategy}_n{self.width}_mesh{self.dp}x{self.tp}"
        if self.pp > 1:
            tag += f"x{self.pp}pp"
        if self.strategy in PHANTOM_KINDS:
            tag += f"_k{self.k}"
        if self.microbatches > 1:
            tag += f"_mb{self.microbatches}"
        if self.kernel_backend != "xla":
            tag += f"_{self.kernel_backend}"
        return tag

    def spec(self) -> ProjectionSpec:
        if self.strategy in PHANTOM_KINDS:
            return ProjectionSpec(kind=self.strategy, k=self.k,
                                  variant=self.variant,
                                  kernel_backend=self.kernel_backend)
        return ProjectionSpec(kind=self.strategy,
                              kernel_backend=self.kernel_backend)

    def model_config(self) -> ModelConfig:
        return ModelConfig(
            name=self.name, family="ffn", num_layers=self.depth,
            d_model=self.width, ffn_width=self.width, ffn_depth=self.depth,
            mlp="relu", microbatches=self.microbatches,
            pipeline=PipelineConfig(stages=self.pp),
            projections=ProjectionMap(**{self.site: self.spec()}))

    def with_width(self, width: int) -> "PlanCandidate":
        return replace(self, width=width)

    def as_dict(self) -> dict:
        return {
            "name": self.name, "dp": self.dp, "tp": self.tp,
            "pp": self.pp,
            "devices": self.devices, "strategy": self.strategy,
            "site": self.site, "width": self.width, "depth": self.depth,
            "batch": self.batch, "k": self.k,
            "microbatches": self.microbatches,
            "scan_layers": self.scan_layers,
            "projection_spec": {"kind": self.spec().kind,
                                "k": self.spec().k,
                                "variant": self.spec().variant},
        }


def mesh_shapes(max_devices: int,
                device_counts: Optional[Iterable[int]] = None
                ) -> List[Tuple[int, int]]:
    """All (dp, tp) factorizations of every candidate device count; the
    counts default to the divisors of ``max_devices``, so an 8-device
    budget searches 1, 2, 4 and 8 devices."""
    if device_counts is None:
        device_counts = [d for d in range(1, max_devices + 1)
                         if max_devices % d == 0]
    shapes = []
    for d in device_counts:
        for tp in range(1, d + 1):
            if d % tp == 0:
                shapes.append((d // tp, tp))
    return shapes


def enumerate_plans(max_devices: int, *, width: int, depth: int,
                    batch: int,
                    strategies: Sequence[str] = ("tensor_col", "phantom"),
                    ks: Sequence[int] = (4, 8, 16),
                    microbatch_options: Sequence[int] = (1,),
                    pps: Sequence[int] = (1, 2),
                    site: str = "ffn_layer",
                    device_counts: Optional[Iterable[int]] = None,
                    allow_submesh_tensor: bool = False,
                    kernel_backends: Sequence[str] = ("xla",)
                    ) -> List[PlanCandidate]:
    """The structurally valid dp x tp x pp x strategy x k candidates
    (divisibility, the phantom regime k < n/p, layers dividing into pp
    stages); resource feasibility is ``planner/constraints.py``'s.

    Tensor plans use the FULL device budget (dp x pp fill what the model
    axis does not): they are the baseline, and idling paid-for devices
    under it would make every comparison trivially winnable.  Phantom
    plans may downsize.  ``allow_submesh_tensor=True`` lets the baseline
    downsize too."""
    if site not in PROJECTION_SITES:
        raise KeyError(f"unknown projection site {site!r}")
    plans: List[PlanCandidate] = []
    seen_meshes = set()
    for dp, tp in mesh_shapes(max_devices, device_counts):
        for pp in pps:
            if pp < 1 or (dp * tp) % pp or pp > depth or depth % pp:
                continue
            # pp devices come out of the dp dimension first (stage
            # boundaries replace gradient replication, not the model axis)
            if dp % pp == 0:
                dpp, tpp = dp // pp, tp
            elif tp % pp == 0 and tp // pp >= 1:
                dpp, tpp = dp, tp // pp
            else:
                continue
            key = (dpp, tpp, pp)
            if key in seen_meshes:
                continue
            seen_meshes.add(key)
            if width % max(tpp, 1) or batch % max(dpp, 1):
                continue
            for strat in strategies:
                phantom = strat in PHANTOM_KINDS
                if phantom and (tpp < 2 or width % tpp):
                    continue    # the phantom class needs >= 2 ranks
                if not phantom and not allow_submesh_tensor \
                        and dpp * tpp * pp != max_devices:
                    continue
                for mb in microbatch_options:
                    if batch % (dpp * mb):
                        continue
                    for k in (ks if phantom else (0,)):
                        # paper Eqn. 8's regime: ghosts narrower than the
                        # activation shard they replace
                        if phantom and k >= width // tpp:
                            continue
                        # the kernel backend changes only the phantom
                        # fused op: other plans get one entry
                        for kb in (kernel_backends if phantom
                                   else kernel_backends[:1]):
                            plans.append(PlanCandidate(
                                dp=dpp, tp=tpp, strategy=strat,
                                width=width, depth=depth, batch=batch,
                                k=k, pp=pp, site=site, microbatches=mb,
                                kernel_backend=kb))
    return plans
