"""The paper's own FFN models (§VI): width-n, depth-L fully-connected
stacks trained on the Gaussian-teacher dataset with MSE loss.

Sizes from the paper: n in {4096, 16384, 65536, 131072, 262144},
L in {2, 6}; ghost width k in {2..64}.
"""
from repro_torch.configs.base import (ModelConfig, PhantomConfig,
                                      phantom_projection_map)

_SIZES = {
    "paper-ffn-4k": (4_096, 2, 3),
    "paper-ffn-16k": (16_384, 2, 16),
    "paper-ffn-64k": (65_536, 6, 64),
    "paper-ffn-131k": (131_072, 2, 64),
    "paper-ffn-262k": (262_144, 2, 64),
}


def config(arch: str = "paper-ffn-16k") -> ModelConfig:
    n, L, k = _SIZES[arch]
    return ModelConfig(
        name=arch,
        family="ffn",
        num_layers=L,
        d_model=n,
        ffn_width=n,
        ffn_depth=L,
        phantom=PhantomConfig(k=k),
        projections=phantom_projection_map(k, ffn_layer=True, ffn=True),
        mlp="relu",
    )


def smoke_config(arch: str = "paper-ffn-16k") -> ModelConfig:
    _, L, _ = _SIZES[arch]
    return ModelConfig(
        name=arch + "-smoke",
        family="ffn",
        num_layers=L,
        d_model=128,
        ffn_width=128,
        ffn_depth=L,
        phantom=PhantomConfig(k=4),
        projections=phantom_projection_map(4, ffn_layer=True, ffn=True),
        mlp="relu",
    )
