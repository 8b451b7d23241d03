"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 + shared expert, interleaved every
2nd layer (matches 400B total / 17B active; see DESIGN.md).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
import dataclasses
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=8192, vocab_size=202048,
        moe_experts=128, moe_top_k=1, moe_interleave=2,
        moe_shared_expert=True,
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, vocab_pad_to=64, moe_experts=4,
        remat=False)
