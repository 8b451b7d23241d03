"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 in parallel with a dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]
"""
import dataclasses
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=4864, vocab_size=32000,
        moe_experts=128, moe_top_k=2, moe_interleave=1,
        moe_dense_residual=True,
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=512, vocab_pad_to=64, moe_experts=4,
        remat=False)
