"""olmoe-1b-7b  [moe]

16L d_model=2048 16H (GQA kv=16) d_ff=1024/expert vocab=50304, MoE 64
experts top-8.  [arXiv:2409.02060]

64 experts divide the model axis: expert-partitioned (``models/moe.py``),
the expert GEMMs of a rank's E/tp experts behind one all-to-all each
way.  Phantom q/k/v/o sites (``attn=True``): at tp > 1 the stream stays
feature-sharded and the attention projections run the phantom kernels.
"""
from repro_torch.configs.base import (ModelConfig, MoEConfig, PhantomConfig,
                                      phantom_projection_map)


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024,
                      partition="expert"),
        attn_shard="head",
        phantom=PhantomConfig(k=8),
        projections=phantom_projection_map(8, attn=True),
        rope="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=32,
        vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                      partition="expert"),
        attn_shard="head",
        phantom=PhantomConfig(k=4),
        projections=phantom_projection_map(4, attn=True),
        rope="full",
        loss_chunk=64,
    )
