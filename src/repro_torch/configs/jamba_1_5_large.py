"""jamba-1.5-large-398b  [hybrid]

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16 experts
top-2: Mamba and attention interleaved 1:7.  [arXiv:2403.19887]

72 layers = 9 superblocks of 8 (1 attention + 7 SSD); the MoE on every
other layer (odd ones).  Adafactor, FSDP over the data axis and bf16
parameters, as the reference sets them.  Phantom at the MLP sites only
(``ffn=True``): the SSD's in and out projections stay tensor-parallel,
and the experts are partitioned by expert.

The card holds one attention + MLP layer and one SSD + MoE layer of it
(the first two layers of the plan): one MoE layer's experts are 9.66 G
parameters, 19.3 GB in bf16, and a superblock has four.
"""
from repro_torch.configs.base import (ModelConfig, MoEConfig, PhantomConfig,
                                      SSMConfig, phantom_projection_map)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        attn_period=8,            # 1 attention layer per 8 (1:7 interleave)
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                      every_n=2, offset=1, partition="expert"),
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4),
        attn_shard="head",
        phantom=PhantomConfig(k=32),
        projections=phantom_projection_map(32, ffn=True),
        fsdp=True,
        optimizer="adafactor",
        param_dtype="bfloat16",
        microbatches=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        family="hybrid",
        num_layers=8,             # one superblock
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        attn_period=8,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                      every_n=2, offset=1, partition="expert"),
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4,
                      chunk=32),
        attn_shard="head",
        phantom=PhantomConfig(k=4),
        projections=phantom_projection_map(4, ffn=True),
        loss_chunk=64,
    )
