"""Config system of the PyTorch port: its own copy of the JAX package's
``configs/base.py``, cut down to what the port's families read.

Plain dataclasses, no framework imports.  Field names, defaults and the
projection-site resolution are the reference's, so a config built here
compares field by field with its counterpart there (the tests check
that for every ported config).  Two fields that no ported feature reads
are left out (tied embeddings, which no config sets, and the
reference's python-loop layer stack, a dry-run device); the tests hold
every ported config to the reference's default for each.
"""
from __future__ import annotations

import dataclasses
import importlib
import warnings
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # MoE on the layers where (layer_idx % every_n) == offset
    every_n: int = 1
    offset: int = 0
    # "expert": the expert dim sharded over the model axis (E % tp == 0);
    # "tensor": each expert's d_ff sharded over the model axis
    partition: str = "expert"
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128          # SSD chunk length
    ngroups: int = 1


@dataclass(frozen=True)
class PhantomConfig:
    """The paper's technique: the legacy per-family selection surface
    (``apply_ffn`` / ``apply_attn_proj``) and the phantom knobs.  New
    configs set ``ModelConfig.projections`` instead."""
    k: int = 64                     # ghost neurons per phantom layer
    apply_ffn: bool = True          # factorize the MLP projections
    apply_attn_proj: bool = False   # factorize QKV/O projections
    include_self_term: bool = False
    variant: str = "fused"          # faithful | fused | ring
    kernel_backend: str = "xla"     # xla | pallas | auto


@dataclass(frozen=True)
class PipelineConfig:
    """Layer-to-stage partitioning (the pipe mesh axis): ``stages``
    contiguous stages, each with its own strategy when ``stage_specs`` is
    set (``core/ffn.py``)."""
    stages: int = 1
    stage_specs: tuple = ()          # per-stage ProjectionSpec overrides

    def __post_init__(self):
        if self.stages < 1:
            raise ValueError(f"pipeline stages must be >= 1, "
                             f"got {self.stages}")
        if self.stage_specs and len(self.stage_specs) != self.stages:
            raise ValueError(
                f"stage_specs has {len(self.stage_specs)} entries for "
                f"{self.stages} stages")
        if self.stages == 1 and self.stage_specs:
            raise ValueError(
                "stage_specs requires stages > 1 — a single-stage config "
                "takes its strategy from the projection site spec")

    @property
    def mixed(self) -> bool:
        """True when stages run DIFFERENT strategies (per-stage param
        subtrees + runtime dispatch instead of one pipe-sharded stack)."""
        return bool(self.stage_specs) and len(set(self.stage_specs)) > 1


@dataclass(frozen=True)
class ProjectionSpec:
    """Selects and parameterizes one projection strategy at one site.

    ``kind`` is a key of the ``parallel.strategies`` registry, or the
    pseudo-kind ``tensor`` (the site's natural dense sharding).
    ``kernel_backend`` selects the executing kernel at sites that have
    one: ``"xla"`` runs plain torch ops, ``"pallas"`` and ``"auto"`` run
    the hand-written CUDA kernel on a CUDA tensor and its plain version
    on a CPU tensor (``kernels/ops.py``)."""
    kind: str = "tensor"
    k: int = 64
    variant: str = "fused"
    include_self_term: bool = False
    kernel_backend: str = "xla"


# every projection site, with its natural dense strategy
PROJECTION_SITES = {
    "ffn_layer": "tensor_col",
    "ffn_gate": "tensor_col",
    "ffn_up": "tensor_col",
    "ffn_down": "tensor_row",
    "attn_q": "tensor_col",
    "attn_k": "tensor_col",
    "attn_v": "tensor_col",
    "attn_o": "tensor_row",
    "ssm_in": "tensor_col",
    "ssm_out": "tensor_row",
    "moe_experts": "tensor_col",
}

_FFN_SITES = ("ffn_gate", "ffn_up", "ffn_down")
_PROJ_LEGACY_ATTN_SITES = ("attn_q", "attn_k", "attn_v", "attn_o",
                           "ssm_in", "ssm_out")

PHANTOM_KINDS = ("phantom", "lowrank_distill")


@dataclass(frozen=True)
class ProjectionMap:
    """Per-site ProjectionSpec overrides; ``default`` covers any site
    without an entry, ``None`` everywhere falls back to the legacy
    ``ffn_impl`` / ``PhantomConfig.apply_*`` shim."""
    default: Optional[ProjectionSpec] = None
    ffn_layer: Optional[ProjectionSpec] = None
    ffn_gate: Optional[ProjectionSpec] = None
    ffn_up: Optional[ProjectionSpec] = None
    ffn_down: Optional[ProjectionSpec] = None
    attn_q: Optional[ProjectionSpec] = None
    attn_k: Optional[ProjectionSpec] = None
    attn_v: Optional[ProjectionSpec] = None
    attn_o: Optional[ProjectionSpec] = None
    ssm_in: Optional[ProjectionSpec] = None
    ssm_out: Optional[ProjectionSpec] = None
    moe_experts: Optional[ProjectionSpec] = None

    def get(self, site: str) -> Optional[ProjectionSpec]:
        return getattr(self, site) or self.default


def dense_projection_map() -> ProjectionMap:
    """Every site at its natural dense (Megatron-TP) strategy."""
    return ProjectionMap(default=ProjectionSpec(kind="tensor"))


def phantom_projection_map(k: int, *, variant: str = "fused",
                           include_self_term: bool = False,
                           ffn: bool = False, attn: bool = False,
                           ffn_layer: bool = False,
                           kernel_backend: str = "xla") -> ProjectionMap:
    """Phantom at the selected site families, the natural dense strategy
    everywhere else (``default="tensor"`` shadows the legacy shim)."""
    ph = ProjectionSpec(kind="phantom", k=k, variant=variant,
                        include_self_term=include_self_term,
                        kernel_backend=kernel_backend)
    entries: dict = {"default": ProjectionSpec(kind="tensor")}
    if ffn_layer:
        entries["ffn_layer"] = ph
    if ffn:
        entries.update({s: ph for s in _FFN_SITES})
    if attn:
        entries.update({s: ph for s in _PROJ_LEGACY_ATTN_SITES})
    return ProjectionMap(**entries)


def with_kernel_backend(cfg: "ModelConfig",
                        backend: str) -> "ModelConfig":
    """Config with ``kernel_backend`` set on every explicit projection
    entry and on the legacy phantom sub-config (the launcher's
    ``--kernel-backend``)."""
    entries = {}
    for f in dataclasses.fields(ProjectionMap):
        spec = getattr(cfg.projections, f.name)
        entries[f.name] = (None if spec is None else
                           dataclasses.replace(spec,
                                               kernel_backend=backend))
    return cfg.replace(
        projections=ProjectionMap(**entries),
        phantom=dataclasses.replace(cfg.phantom, kernel_backend=backend))


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec
                                    # | vlm | ffn
    num_layers: int                 # the decoder's, for encdec
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0               # 0 -> d_model // num_heads

    encoder_layers: int = 0         # encdec: the encoder's depth

    norm: str = "rmsnorm"           # rmsnorm | layernorm
    mlp: str = "swiglu"             # swiglu | gelu | relu
    qkv_bias: bool = False
    norm_eps: float = 1e-5

    rope: str = "full"              # full | partial | mrope | none
    rope_fraction: float = 1.0      # chatglm3 "2d rope" == 0.5
    rope_theta: float = 10000.0

    # one attention layer per ``attn_period`` layers (0: every layer is
    # attention, -1: attention-free)
    attn_period: int = 0

    # the stubbed frontends: a batch carries their embeddings
    frontend: str = "none"          # none | audio | vision

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    ffn_impl: str = "dense"         # legacy shim, see projection_spec
    phantom: PhantomConfig = field(default_factory=PhantomConfig)
    projections: ProjectionMap = field(default_factory=ProjectionMap)
    attn_shard: str = "auto"        # auto | head | ring

    dtype: str = "bfloat16"         # compute dtype
    param_dtype: str = "float32"    # stored parameter dtype
    remat: str = "full"             # full | none (recompute each block)
    optimizer: str = "adamw"        # adamw | adafactor | sgd
    fsdp: bool = False              # also shard parameters over dp
    loss_chunk: int = 2048          # sequence chunk of the cross-entropy
    attn_bf16_scores: bool = False  # bf16 score blocks in the plain core
    kv_cache_quant: bool = False    # the SSD decode state in bf16
    attn_kv_chunk: int = 0          # 0 = default chunking; -1 = one block
    fsdp_gather_quant: bool = False  # int8 FSDP gathers (gather_fsdp)
    attn_ring_gather_kv: bool = False  # ring mode: one all-gather of K/V
                                       # instead of p ppermute hops
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    microbatches: int = 1           # microbatches: pipeline or accumulation

    # paper-FFN-specific (family == "ffn")
    ffn_width: int = 0
    ffn_depth: int = 0

    def projection_spec(self, site: str) -> ProjectionSpec:
        """The spec governing one site: explicit entry > ``default`` >
        legacy shim > natural dense strategy; ``tensor`` resolves to the
        site's col/row strategy."""
        if site not in PROJECTION_SITES:
            raise KeyError(f"unknown projection site {site!r}; "
                           f"known: {sorted(PROJECTION_SITES)}")
        spec = self.projections.get(site)
        if spec is None:
            spec = self._legacy_projection_spec(site)
        if spec.kind == "tensor":
            spec = dataclasses.replace(spec, kind=PROJECTION_SITES[site])
        return spec

    def _legacy_projection_spec(self, site: str) -> ProjectionSpec:
        pp = self.phantom

        def ph() -> ProjectionSpec:
            warnings.warn(
                f"config {self.name!r} selects phantom at site {site!r} "
                f"through the deprecated ffn_impl/PhantomConfig.apply_* "
                f"shim; set ModelConfig.projections instead",
                DeprecationWarning, stacklevel=4)
            return ProjectionSpec(kind="phantom", k=pp.k,
                                  variant=pp.variant,
                                  include_self_term=pp.include_self_term,
                                  kernel_backend=pp.kernel_backend)

        if site == "ffn_layer":
            return ph() if self.ffn_impl == "phantom" else ProjectionSpec()
        if site in _FFN_SITES and pp.apply_ffn \
                and self.ffn_impl != "dense_force":
            return ph()
        if site in _PROJ_LEGACY_ATTN_SITES and pp.apply_attn_proj:
            return ph()
        return ProjectionSpec()

    def stage_projection_spec(self, stage: int,
                              site: str = "ffn_layer") -> ProjectionSpec:
        """The ProjectionSpec governing `site` on pipeline stage `stage`
        (per-stage override when ``pipeline.stage_specs`` is set, else the
        site's spec)."""
        if self.pipeline.stage_specs:
            spec = self.pipeline.stage_specs[stage]
            if spec.kind == "tensor":
                spec = dataclasses.replace(spec, kind=PROJECTION_SITES[site])
            return spec
        return self.projection_spec(site)

    def uses_phantom_sites(self) -> bool:
        """True if any projection site resolves to a phantom-family
        strategy."""
        return any(self.projection_spec(s).kind in PHANTOM_KINDS
                   for s in PROJECTION_SITES)

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",  524_288,    1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    microbatches: int = 1            # gradient accumulation
    seed: int = 0


def applicable_shapes(cfg: ModelConfig) -> list:
    """Which of the 4 assigned shapes apply to this architecture:
    ``long_500k`` needs sub-quadratic attention, so only the SSM and
    hybrid families run it."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("ssm", "hybrid"):
        names.append("long_500k")
    return names


# the architectures of the port (``--arch``): every one of the reference's
_MODULES = {
    "chatglm3-6b": "chatglm3_6b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "mamba2-370m": "mamba2_370m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "phi3-mini-3.8b": "phi3_mini",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "seamless-m4t-large-v2": "seamless_m4t_large",
    "stablelm-3b": "stablelm_3b",
    # the paper's own FFN models
    "paper-ffn-4k": "paper_ffn",
    "paper-ffn-16k": "paper_ffn",
    "paper-ffn-64k": "paper_ffn",
    "paper-ffn-131k": "paper_ffn",
    "paper-ffn-262k": "paper_ffn",
}


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    """Load an architecture config by id (``--arch`` flag)."""
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    if arch.startswith("paper-ffn"):
        cfg = (mod.smoke_config if smoke else mod.config)(arch)
    else:
        cfg = (mod.smoke_config if smoke else mod.config)()
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
