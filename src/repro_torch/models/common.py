"""Model configuration and parameter-spec machinery, the port's subset of
`repro.models.common`: `ModelConfig`, `ParamDef`, `init_params` and
`param_count`.  The sharding rules, `abstract_params` and `param_pspecs`
wait for the launch and distributed slice (ROADMAP.md Queue 1 items 10-11).

Initial values come from an explicit `torch.Generator` and are drawn on
its device, so a CUDA generator fills a full-width model on the card;
they differ from `jax.random`'s for the same seed, so parity tests carry
the reference's parameters over instead (`GNN.load_reference_params`,
`LM.load_reference_params`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of the reference's `ModelConfig` that the dense serving
    path reads, with torch dtypes.  `family` and `moe_experts` are kept so
    that `LM` can refuse the families it does not have; the other families'
    fields come with the slices that port them (ROADMAP.md Queue 1 item 10).
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    vocab_pad_to: int = 2048
    norm_type: str = "rms"           # rms | layernorm
    norm_eps: float = 1e-6
    act: str = "silu_gated"          # silu_gated | gelu
    pos_embed: str = "rope"          # rope | none (learned waits)
    rope_theta: float = 10_000.0
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen2 / internvl2 backbone
    attn_window: int | None = None   # sliding-window attention (h2o-danube)
    tie_embeddings: bool = False
    residual_scale: float = 1.0      # minicpm depth-scaled residuals
    embed_scale: float = 1.0         # minicpm mup-style embedding scale
    moe_experts: int = 0             # > 0 is refused by LM
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "einsum"        # einsum | flash (the CUDA kernel)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                  # normal | zeros | ones | lecun
    scale: float = 1.0

    def initializer(self, generator: torch.Generator) -> torch.Tensor:
        dev = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=dev)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=dev)
        if self.init == "lecun":
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            std = math.sqrt(1.0 / fan_in)
        else:
            std = 0.02 * self.scale
        return (torch.randn(self.shape, generator=generator,
                            dtype=torch.float32, device=dev) * std
                ).to(self.dtype)


ParamTree = Any  # nested dict / list of ParamDef


def init_params(defs: ParamTree, generator: torch.Generator) -> Any:
    """Materialise a ParamDef tree on `generator`'s device, leaves drawn in
    order (sorted keys within a dict, index order within a list)."""
    if isinstance(defs, ParamDef):
        return defs.initializer(generator)
    if isinstance(defs, list):
        return [init_params(d, generator) for d in defs]
    return {k: init_params(defs[k], generator) for k in sorted(defs)}


def tree_map_defs(fn, defs: ParamTree) -> Any:
    if isinstance(defs, ParamDef):
        return fn(defs)
    if isinstance(defs, list):
        return [tree_map_defs(fn, d) for d in defs]
    return {k: tree_map_defs(fn, v) for k, v in defs.items()}


def param_count(defs: ParamTree) -> int:
    if isinstance(defs, ParamDef):
        return math.prod(defs.shape)
    items = defs if isinstance(defs, list) else defs.values()
    return sum(param_count(d) for d in items)
