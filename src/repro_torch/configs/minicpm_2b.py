"""minicpm-2b [dense] — 40L d_model=2304 36H (MHA kv=36) d_ff=5760
vocab=122753; WSD schedule, mup-style depth-scaled residuals
(scale_depth=1.4 -> residual_scale = 1.4/sqrt(40)), embedding scale 12.
[arXiv:2404.06395; hf]
"""
import dataclasses
import math
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
        d_ff=5760, vocab_size=122753,
        residual_scale=1.4 / math.sqrt(40), embed_scale=12.0,
        tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, vocab_pad_to=64,
        residual_scale=1.4 / math.sqrt(3), remat=False)
