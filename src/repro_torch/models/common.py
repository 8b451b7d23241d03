"""Model configuration and parameter-spec machinery, the port of
`repro.models.common`.

Every architecture declares its parameters once as `ParamDef`s (shape,
logical axes, init); from that one source come
  * materialised params (`init_params`),
  * abstract params on the meta device with their placements for the
    dry-run (`abstract_params`),
  * PartitionSpecs under a sharding strategy (`param_pspecs`).

Logical axis names resolve to mesh axes through a rules table; a dim not
divisible by its mesh axes' size falls back to replication, as in the
reference.

Initial values come from an explicit `torch.Generator` and are drawn on
its device, so a CUDA generator fills a full-width model on the card;
they differ from `jax.random`'s for the same seed, so parity tests carry
the reference's parameters over instead (`GNN.load_reference_params`,
`LM.load_reference_params`).  A leaf of more than `INIT_CHUNK` elements is
drawn in chunks of that many, so that a full-width MoE expert tensor never
needs an f32 temporary of its whole size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.launch.mesh import Mesh, NamedSharding, P, Placed


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's `ModelConfig` with torch dtypes.

    `remat` recomputes each layer group's forward in the backward pass
    (`torch.utils.checkpoint`, as the reference's `jax.checkpoint`);
    `scan_unroll` is accepted and changes nothing, because the port already
    runs its layers in a Python loop, which is what the reference's unrolled
    scan is."""

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
    pos_embed: str = "rope"          # rope | learned | none
    rope_theta: float = 10_000.0
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen2 / internvl2 backbone
    attn_window: int | None = None   # sliding-window attention (h2o-danube)
    max_position: int = 32768        # learned-pos table size (whisper)
    tie_embeddings: bool = False
    residual_scale: float = 1.0      # minicpm depth-scaled residuals
    embed_scale: float = 1.0         # minicpm mup-style embedding scale
    # --- MoE ---------------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_interleave: int = 1          # layer i is MoE iff i % interleave ==
                                     # interleave-1 (llama4: every 2nd)
    moe_shared_expert: bool = False  # llama4
    moe_dense_residual: bool = False # arctic: dense FFN parallel to MoE
    moe_capacity_factor: float = 1.25
    # --- SSM / hybrid --------------------------------------------------------
    ssm_state: int = 0               # mamba2 N
    ssm_headdim: int = 64            # mamba2 P
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_chunk: int = 128             # SSD chunk length
    hybrid_attn_every: int = 0       # recurrentgemma: attn layer every 3rd
    lru_width: int = 0               # RG-LRU width (0 -> d_model)
    local_window: int = 2048         # recurrentgemma local attention window
    # --- encoder-decoder / frontends -----------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper: 30 s of 20 ms frames
    frontend: str | None = None      # audio_stub | vision_stub
    frontend_tokens: int = 256       # vlm: patch embeddings per image
    # --- numerics -------------------------------------------------------------
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True               # recompute each layer in the backward
    attn_impl: str = "einsum"        # einsum | flash (the CUDA kernel) |
                                     # flash_stub (the dry-run's stand-in)
    scan_unroll: bool = False        # no effect: layers loop in Python
    moe_2d_dispatch: bool = False    # serving: shard dispatch d_model over
                                     # data (weight-stationary experts) —
                                     # see launch/specs.activation_specs

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def is_moe_layer(self, i: int) -> bool:
        if not self.moe_experts:
            return False
        return (i % self.moe_interleave) == (self.moe_interleave - 1)

    def is_attn_layer(self, i: int) -> bool:
        """hybrid archs: which layers are (local) attention."""
        if self.family != "hybrid":
            return True
        k = self.hybrid_attn_every
        return k > 0 and (i % k) == (k - 1)


INIT_CHUNK = 1 << 30     # elements drawn at once: 4 GB of f32


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
        # drawn INIT_CHUNK elements at a time, so that a large leaf never
        # has a whole f32 temporary beside it
        n = math.prod(self.shape)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        flat = out.view(-1)
        for start in range(0, n, INIT_CHUNK):
            part = torch.randn(min(INIT_CHUNK, n - start),
                               generator=generator, dtype=torch.float32,
                               device=dev)
            flat[start:start + part.numel()] = part.mul_(std)
        return out


ParamTree = Any  # nested dict / list of ParamDef


def init_params(defs: ParamTree, generator: torch.Generator) -> Any:
    """Materialise a ParamDef tree on `generator`'s device, leaves drawn in
    order (sorted keys within a dict, index order within a list)."""
    if isinstance(defs, ParamDef):
        return defs.initializer(generator)
    if isinstance(defs, list):
        return [init_params(d, generator) for d in defs]
    return {k: init_params(defs[k], generator) for k in sorted(defs)}


# --------------------------------------------------------------------------
# sharding rules
# --------------------------------------------------------------------------
# logical axis -> mesh axis (or None). Tuple values shard over several axes.
def sharding_rules(strategy: str, multi_pod: bool = False) -> dict:
    batch = ("pod", "data") if multi_pod else ("data",)
    base = {
        "batch": batch,
        "seq": None,
        "layers": None,            # the layer axis, never sharded
        "vocab": "model",
        "embed": None,             # d_model
        "qkv": "model",            # fused head*hd projection dim
        "heads": "model",          # falls back to None if not divisible
        "kv_heads": "model",
        "head_dim": None,
        "ffn": "model",
        "expert": "model",         # EP
        "expert_ffn": None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "lru": "model",
        "conv": None,
    }
    if strategy == "tp":
        pass
    elif strategy == "fsdp_tp":
        # ZeRO-3 style: the d_model dim of weights also over the data axis,
        # all-gathered per layer
        base["embed"] = "data"
        base["expert_ffn"] = "data"
    elif strategy == "ep_tp":
        # serving layout: weight-stationary experts, the expert dim over
        # data, ffn dims over model
        base["expert"] = "data"
        base["expert_ffn"] = None
    elif strategy == "dp":
        for k in ("vocab", "qkv", "heads", "kv_heads", "ffn", "expert",
                  "ssm_inner", "ssm_heads", "lru"):
            base[k] = None
    else:
        raise ValueError(strategy)
    return base


def resolve_pspec(pdef: ParamDef, rules: dict, mesh: Mesh) -> P:
    """Logical axes -> PartitionSpec with the divisibility fallback."""
    used: set = set()
    out = []
    for dim, ax in zip(pdef.shape, pdef.axes):
        mesh_ax = rules.get(ax) if ax else None
        if mesh_ax is None:
            out.append(None)
            continue
        axes_tuple = (mesh_ax,) if isinstance(mesh_ax, str) else tuple(mesh_ax)
        size = math.prod(mesh.shape[a] for a in axes_tuple)
        if dim % size != 0 or any(a in used for a in axes_tuple):
            out.append(None)
            continue
        used.update(axes_tuple)
        out.append(mesh_ax)
    return P(*out)


def tree_map_defs(fn, defs: ParamTree) -> Any:
    if isinstance(defs, ParamDef):
        return fn(defs)
    if isinstance(defs, list):
        return [tree_map_defs(fn, d) for d in defs]
    return {k: tree_map_defs(fn, v) for k, v in defs.items()}


def abstract_params(defs: ParamTree, rules: dict, mesh: Mesh) -> Any:
    """Each leaf as a `Placed` meta tensor of its shape and dtype and its
    sharding; nothing is allocated and no initializer runs."""
    def mk(d: ParamDef) -> Placed:
        return Placed(torch.empty(d.shape, dtype=d.dtype, device="meta"),
                      NamedSharding(mesh, resolve_pspec(d, rules, mesh)))
    return tree_map_defs(mk, defs)


def param_pspecs(defs: ParamTree, rules: dict, mesh: Mesh) -> Any:
    return tree_map_defs(lambda d: resolve_pspec(d, rules, mesh), defs)


def param_count(defs: ParamTree) -> int:
    if isinstance(defs, ParamDef):
        return math.prod(defs.shape)
    items = defs if isinstance(defs, list) else defs.values()
    return sum(param_count(d) for d in items)
