"""internvl2-1b [vlm] — InternViT (stub) + Qwen2-0.5B-style backbone:
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The vision frontend
is a STUB: `input_specs` provides precomputed patch embeddings (B, P, D)
prepended to the token sequence; in the GIDS integration these embeddings
are fetched from the tiered feature store by image id (they are exactly a
node-feature table). [arXiv:2404.16821; hf]
"""
import dataclasses
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        d_ff=4864, vocab_size=151655,
        qkv_bias=True, tie_embeddings=True,
        frontend="vision_stub", frontend_tokens=256,
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, vocab_pad_to=64, frontend_tokens=8,
        remat=False)
