"""Shared LM layers, the port's subset of `repro.models.layers`: norms,
rotary embeddings, self-attention (einsum path and the CUDA
`flash_attention` path, with a KV cache at a scalar or per-slot index)
and the MLP.  Mixture of experts and cross-attention wait for their
families (ROADMAP.md Queue 1 item 10).

Functions take params in and give activations out, as in the reference,
with one exception: a KV cache passed to `attention` is written in place
(the reference returns an updated copy).  The reference's activation
sharding constraints (`repro.distributed.ctx.constrain`) are the identity
on one card and are left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, ParamDef


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def norm_defs(cfg: ModelConfig, shape=None) -> dict:
    shape = shape or (cfg.d_model,)
    d = {"scale": ParamDef(shape, ("embed",) * len(shape), torch.float32,
                           init="ones")}
    if cfg.norm_type == "layernorm":
        d["bias"] = ParamDef(shape, ("embed",) * len(shape), torch.float32,
                             init="zeros")
    return d


def apply_norm(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMS norm or layer norm, computed in f32, cast back to x's dtype."""
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"]
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def _rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """cos and sin of shape (B|1, S, 1, hd/2) for positions (B, S) or (S,)."""
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    # split halves, not interleaved pairs, as the reference
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1], theta))


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def attention_defs(cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    d = {
        "wq": ParamDef((D, H * hd), ("embed", "qkv"), cfg.param_dtype,
                       init="lecun"),
        "wk": ParamDef((D, KV * hd), ("embed", "qkv"), cfg.param_dtype,
                       init="lecun"),
        "wv": ParamDef((D, KV * hd), ("embed", "qkv"), cfg.param_dtype,
                       init="lecun"),
        "wo": ParamDef((H * hd, D), ("qkv", "embed"), cfg.param_dtype,
                       init="lecun"),
    }
    if cfg.qkv_bias:            # biases stay f32, as in the reference
        d["bq"] = ParamDef((H * hd,), ("qkv",), torch.float32, init="zeros")
        d["bk"] = ParamDef((KV * hd,), ("qkv",), torch.float32, init="zeros")
        d["bv"] = ParamDef((KV * hd,), ("qkv",), torch.float32, init="zeros")
    if cfg.qk_norm:
        d["q_norm"] = ParamDef((hd,), ("head_dim",), torch.float32,
                               init="ones")
        d["k_norm"] = ParamDef((hd,), ("head_dim",), torch.float32,
                               init="ones")
    return d


def _rms(x, scale, eps):
    xf = x.float()
    y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps) * scale
    return y.to(x.dtype)


def _mask_bias(Sq: int, Sk: int, q_offset, causal: bool, window, dtype,
               device) -> torch.Tensor:
    """q_offset: int, or (B,) per-sequence offsets (slot decoding).
    Returns (Sq, Sk) or (B, 1, 1, Sq, Sk)."""
    vec = isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1
    ar_q = torch.arange(Sq, device=device)
    k_pos = torch.arange(Sk, device=device)
    if vec:
        q_pos = q_offset.long()[:, None, None] + ar_q[None, :, None]
        k_pos = k_pos[None, None, :]
    else:
        q_pos = q_offset + ar_q[:, None]
        k_pos = k_pos[None, :]
    ok = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                    dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    bias = torch.where(ok, 0.0, -1e30).to(dtype)
    if vec:
        bias = bias[:, None, None, :, :]
    return bias


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor | None = None,
              kv_cache: tuple | None = None,
              cache_index=None,
              causal: bool = True,
              window: int | None = None) -> tuple[torch.Tensor, tuple | None]:
    """Self-attention with GQA / SWA / qk-norm / bias / cache.

    kv_cache:    (k, v) of shape (B, S_cache, KV, hd), written IN PLACE:
                 with Sq == 1 and an index, one row per sequence at its
                 index (decode); otherwise the prompt at the scalar index
                 (prefill writes at 0)
    cache_index: int, or a (B,) int32 tensor of per-slot positions
    returns (out, (k, v) cache or None)

    attn_impl "flash" runs `ops.flash_attention` over the whole cache with
    the cache's per-sequence offsets as q_offset, which is what the einsum
    path computes; the reference's flash branch passes no offset, so its
    decode steps see only cache row 0 (ROADMAP.md Queue 3).
    """
    B, Sq, _ = x.shape
    H, KVh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, Sq, H, hd)
    k = k.reshape(B, Sq, KVh, hd)
    v = v.reshape(B, Sq, KVh, hd)
    if cfg.qk_norm:
        q = _rms(q, p["q_norm"], cfg.norm_eps)
        k = _rms(k, p["k_norm"], cfg.norm_eps)

    # cache_index may be a scalar or a per-sequence (B,) vector
    # (continuous-batching slots decode at different positions)
    idx_vec = None
    per_slot = isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1
    if per_slot:
        idx_vec = cache_index.to(device=x.device, dtype=torch.int32)
    elif cache_index is not None:
        idx_vec = torch.full((B,), int(cache_index), dtype=torch.int32,
                             device=x.device)
    if cfg.pos_embed == "rope":
        if positions is None:
            positions = torch.arange(Sq, device=x.device)
            if kv_cache is not None and idx_vec is not None:
                positions = positions[None, :] + idx_vec[:, None]
        cos, sin = _rope_tables(positions, hd, cfg.rope_theta)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)

    q_offset = 0
    new_cache = None
    if kv_cache is not None:
        ck, cv = kv_cache                   # (B, S_cache, KV, hd)
        if Sq == 1 and idx_vec is not None:
            rows = torch.arange(B, device=x.device)
            ck[rows, idx_vec.long()] = k[:, 0].to(ck.dtype)
            cv[rows, idx_vec.long()] = v[:, 0].to(cv.dtype)
        else:
            if per_slot:
                raise ValueError("a prompt is written at one scalar index")
            idx = int(cache_index) if cache_index is not None else 0
            ck[:, idx:idx + Sq] = k.to(ck.dtype)
            cv[:, idx:idx + Sq] = v.to(cv.dtype)
        q_offset = idx_vec if idx_vec is not None else 0
        k, v = ck, cv
        new_cache = (ck, cv)

    group = H // KVh
    if cfg.attn_impl == "flash":
        off = q_offset if isinstance(q_offset, torch.Tensor) else None
        att = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window,
            q_offset=None if off is None else off.contiguous())
        out = att.transpose(1, 2).reshape(B, Sq, H * hd)
        return out @ p["wo"], new_cache
    if cfg.attn_impl != "einsum":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")

    qh = q.reshape(B, Sq, KVh, group, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qh, k) * (hd ** -0.5)
    Sk = k.shape[1]
    bias = _mask_bias(Sq, Sk, q_offset, causal, window, scores.dtype,
                      x.device)
    if kv_cache is not None and idx_vec is not None:
        # self-attention over a cache: mask unwritten slots (per sequence)
        valid = (torch.arange(Sk, device=x.device)[None, :]
                 <= (idx_vec.long()[:, None] + Sq - 1))[:, None, None, None, :]
        bias = bias + torch.where(valid, 0.0, -1e30).to(bias.dtype)
    scores = scores + bias
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v).reshape(B, Sq, H * hd)
    return out @ p["wo"], new_cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "silu_gated":
        return {
            "w1": ParamDef((D, Fd), ("embed", "ffn"), cfg.param_dtype,
                           init="lecun"),
            "w3": ParamDef((D, Fd), ("embed", "ffn"), cfg.param_dtype,
                           init="lecun"),
            "w2": ParamDef((Fd, D), ("ffn", "embed"), cfg.param_dtype,
                           init="lecun"),
        }
    return {  # gelu (whisper)
        "w1": ParamDef((D, Fd), ("embed", "ffn"), cfg.param_dtype,
                       init="lecun"),
        "b1": ParamDef((Fd,), ("ffn",), torch.float32, init="zeros"),
        "w2": ParamDef((Fd, D), ("ffn", "embed"), cfg.param_dtype,
                       init="lecun"),
        "b2": ParamDef((D,), ("embed",), torch.float32, init="zeros"),
    }


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act == "silu_gated":
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
        return h @ p["w2"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w1"] + p["b1"].to(x.dtype), approximate="tanh")
    return h @ p["w2"] + p["b2"].to(x.dtype)
