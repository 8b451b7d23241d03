"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936; qk_norm. [hf:Qwen/Qwen3-8B; hf]
"""
import dataclasses
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=17408, vocab_size=151936, head_dim=128,
        qk_norm=True,
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=160, vocab_size=512, vocab_pad_to=64, head_dim=16,
        remat=False)
