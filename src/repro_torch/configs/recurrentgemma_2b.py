"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1, hd=256)
d_ff=7680 vocab=256000; Griffin pattern 2 RG-LRU blocks : 1 local-attention
(window 2048) block -> 8 full (rec,rec,attn) groups + 2 trailing rec layers.
Runs long_500k (constant-size recurrent state + windowed attention).
[arXiv:2402.19427; hf]
"""
import dataclasses
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        d_ff=7680, vocab_size=256000, head_dim=256,
        hybrid_attn_every=3, lru_width=2560, local_window=2048,
        tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=512, vocab_pad_to=64, head_dim=16,
        lru_width=64, local_window=16, remat=False)
