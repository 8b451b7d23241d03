"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000; llama+mistral mix with sliding-window attention (4096).
Runs long_500k: SWA is O(S*w). [arXiv:2401.16818; hf]
"""
import dataclasses
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
        d_ff=6912, vocab_size=32000,
        attn_window=4096,
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, vocab_pad_to=64, attn_window=16,
        remat=False)
