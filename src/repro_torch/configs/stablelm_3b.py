"""stablelm-3b  [dense]

32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm family; unverified]

StableLM-2 style: partial rotary (25%), LayerNorm, SwiGLU MLP.
"""
from repro_torch.configs.base import (ModelConfig, PhantomConfig,
                                      phantom_projection_map)


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        family="dense",
        num_layers=32,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
        attn_shard="head",
        norm="layernorm",
        rope="partial",
        rope_fraction=0.25,
        phantom=PhantomConfig(k=8),
        projections=phantom_projection_map(8, ffn=True),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        attn_shard="head",
        norm="layernorm",
        rope="partial",
        rope_fraction=0.25,
        phantom=PhantomConfig(k=4),
        projections=phantom_projection_map(4, ffn=True),
        loss_chunk=64,
    )
