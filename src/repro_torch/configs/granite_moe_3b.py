"""granite-moe-3b-a800m  [moe]

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 40
experts top-8.  [hf:ibm-granite family]

40 experts do not divide a model axis of 16: tensor-partitioned (each
expert's d_ff sharded over the model axis, ``models/moe.py``).  24 heads
do not divide it either: ring (sequence-sharded) attention.  No site is
phantom: ring attention keeps the stream sequence-sharded and the
experts are small tensor-partitioned FFNs, so the model runs without
the technique, as in the reference.
"""
from repro_torch.configs.base import (ModelConfig, MoEConfig, PhantomConfig,
                                      phantom_projection_map)


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512,
                      partition="tensor"),
        attn_shard="ring",
        phantom=PhantomConfig(k=8),
        projections=phantom_projection_map(8),
        rope="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=32,
        vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                      partition="tensor"),
        attn_shard="ring",
        phantom=PhantomConfig(k=4),
        projections=phantom_projection_map(4),
        rope="full",
        loss_chunk=64,
    )
