"""whisper-small [audio] — enc-dec, 12L each side, d_model=768 12H (MHA)
d_ff=3072 vocab=51865; conv frontend STUB (input_specs provides precomputed
mel-frame embeddings (B, 1500, D)), learned positions, LayerNorm, GELU MLP.
[arXiv:2212.04356; unverified]
"""
import dataclasses
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec",
        num_layers=12, encoder_layers=12, d_model=768, num_heads=12,
        num_kv_heads=12, d_ff=3072, vocab_size=51865,
        norm_type="layernorm", act="gelu", pos_embed="learned",
        encoder_seq=1500, frontend="audio_stub",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=512, vocab_pad_to=64,
        encoder_seq=32, max_position=128, remat=False)
