"""mamba2-1.3b [ssm] — 48L d_model=2048, attn-free SSD (state-space
duality), ssm_state=128, headdim=64, expand=2, vocab=50280.  Runs long_500k
(O(1) decode state). [arXiv:2405.21060; unverified]
"""
import dataclasses
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm",
        num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
        tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=4, d_model=64, vocab_size=512, vocab_pad_to=64,
        ssm_state=16, ssm_headdim=8, ssm_chunk=8, remat=False)
