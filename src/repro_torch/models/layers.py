"""Shared LM layers, the port of `repro.models.layers`: norms, rotary
embeddings, attention (self-attention on the einsum path or the CUDA
`flash_attention` path, with a KV cache at a scalar or per-slot index;
non-causal self-attention; cross-attention with a cache written once),
the MLP and the capacity-based mixture of experts.

Functions take params in and give activations out, as in the reference,
with one exception: a KV cache passed to `attention` is written in place
(the reference returns an updated copy).  The activation-sharding anchors
(`repro_torch.distributed.ctx.constrain`) sit where the reference's do;
on one device each returns its tensor unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.ctx import constrain as _constrain
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
              kv_x: torch.Tensor | None = None,
              positions: torch.Tensor | None = None,
              kv_cache: tuple | None = None,
              cache_index=None,
              causal: bool = True,
              window: int | None = None,
              static_kv: bool = False) -> tuple[torch.Tensor, tuple | None]:
    """Multi-head attention with GQA / SWA / qk-norm / bias / cache.

    kv_x:        source of K, V (cross-attention); defaults to x
    kv_cache:    (k, v) of shape (B, S_cache, KV, hd), written IN PLACE:
                 with Sq == 1 and an index, one row per sequence at its
                 index (decode); otherwise the new K/V at the scalar index
                 (prefill writes at 0)
    cache_index: int, or a (B,) int32 tensor of per-slot positions
    static_kv:   cross-attention cache: with kv_x, K/V of kv_x are written
                 into the cache once (prefill); without it, the cache is
                 read as it is and no K/V are computed (decode)
    returns (out, (k, v) cache or None)

    attn_impl "flash_stub" is the reference's dry-run stand-in on that same
    branch: q plus the mean key and the mean value of each kv head, which
    reads q and the whole K/V once and writes the output, the kernel's
    memory traffic without its S^2 work (plain torch on every device).

    attn_impl "flash" runs `ops.flash_attention` wherever the reference's
    flash branch does, whenever K/V come from x or the cache (kv_x is
    None): self-attention over the whole cache with the cache's
    per-sequence offsets as q_offset, which is what the einsum path
    computes (the reference's flash branch passes no offset, so its decode
    steps see only cache row 0: ROADMAP.md Queue 3), and cross-attention's
    decode, non-causal over the encoded memory.  Cross-attention that
    encodes kv_x (prefill, forward) takes the einsum path, as there.
    """
    B, Sq, _ = x.shape
    H, KVh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    cross = kv_x is not None or static_kv

    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
    q = q.reshape(B, Sq, H, hd)
    if cfg.qk_norm:
        q = _rms(q, p["q_norm"], cfg.norm_eps)

    # cache_index may be a scalar or a per-sequence (B,) vector
    # (continuous-batching slots decode at different positions)
    idx_vec = None
    per_slot = isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1
    if per_slot:
        idx_vec = cache_index.to(device=x.device, dtype=torch.int32)
    elif isinstance(cache_index, torch.Tensor) and Sq == 1:
        # a scalar index tensor, read without a host sync (the meta device
        # of the dry-run has no values)
        idx_vec = cache_index.to(device=x.device,
                                 dtype=torch.int32).reshape(()).expand(B)
    elif cache_index is not None:
        idx_vec = torch.full((B,), int(cache_index), dtype=torch.int32,
                             device=x.device)

    q_offset = 0
    new_cache = None
    if static_kv and kv_x is None:
        # cross-attention decode: the cache holds the encoded memory
        k, v = kv_cache
        new_cache = kv_cache
    else:
        src = x if kv_x is None else kv_x
        Sk = src.shape[1]
        k = src @ p["wk"]
        v = src @ p["wv"]
        if cfg.qkv_bias:
            k = k + p["bk"].to(k.dtype)
            v = v + p["bv"].to(v.dtype)
        k = k.reshape(B, Sk, KVh, hd)
        v = v.reshape(B, Sk, KVh, hd)
        if cfg.qk_norm:
            k = _rms(k, p["k_norm"], cfg.norm_eps)
        if cfg.pos_embed == "rope" and kv_x is None:
            if positions is None:
                positions = torch.arange(Sq, device=x.device)
                if kv_cache is not None and idx_vec is not None:
                    positions = positions[None, :] + idx_vec[:, None]
            cos, sin = _rope_tables(positions, hd, cfg.rope_theta)
            q = _apply_rope(q, cos, sin)
            k = _apply_rope(k, cos, sin)
        if kv_cache is not None:
            ck, cv = kv_cache               # (B, S_cache, KV, hd)
            if Sq == 1 and idx_vec is not None:
                rows = torch.arange(B, device=x.device)
                ck[rows, idx_vec.long()] = k[:, 0].to(ck.dtype)
                cv[rows, idx_vec.long()] = v[:, 0].to(cv.dtype)
            else:
                if per_slot:
                    raise ValueError("a prompt is written at one scalar "
                                     "index")
                idx = int(cache_index) if cache_index is not None else 0
                ck[:, idx:idx + Sk] = k.to(ck.dtype)
                cv[:, idx:idx + Sk] = v.to(cv.dtype)
            if not static_kv:
                q_offset = idx_vec if idx_vec is not None else 0
                k, v = ck, cv
            new_cache = (ck, cv)

    group = H // KVh
    q = _constrain(q, "attn_act")
    k = _constrain(k, "attn_act")
    v = _constrain(v, "attn_act")
    if cfg.attn_impl == "flash" and kv_x is None:
        off = q_offset if isinstance(q_offset, torch.Tensor) else None
        att = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal and not static_kv, window=window,
            q_offset=None if off is None else off.contiguous())
        out = att.transpose(1, 2).reshape(B, Sq, H * hd)
        return _constrain(out, "attn_out") @ p["wo"], new_cache
    if cfg.attn_impl == "flash_stub" and kv_x is None:
        kk = k.mean(1, keepdim=True).repeat_interleave(group, dim=2)
        vv = v.mean(1, keepdim=True).repeat_interleave(group, dim=2)
        out = (q + kk + vv).reshape(B, Sq, H * hd)
        return _constrain(out, "attn_out") @ p["wo"], new_cache
    if cfg.attn_impl not in ("einsum", "flash", "flash_stub"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")

    qh = q.reshape(B, Sq, KVh, group, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qh, k) * (hd ** -0.5)
    decode = kv_cache is not None and cache_index is not None and Sq == 1
    scores = _constrain(scores,
                        "attn_scores_decode" if decode else "attn_scores")
    Sk = k.shape[1]
    bias = _mask_bias(Sq, Sk, q_offset, causal and not cross, window,
                      scores.dtype, x.device)
    if not cross and kv_cache is not None and idx_vec is not None:
        # self-attention over a cache: mask unwritten slots (per sequence)
        valid = (torch.arange(Sk, device=x.device)[None, :]
                 <= (idx_vec.long()[:, None] + Sq - 1))[:, None, None, None, :]
        bias = bias + torch.where(valid, 0.0, -1e30).to(bias.dtype)
    scores = scores + bias
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    probs = _constrain(probs,
                       "attn_scores_decode" if decode else "attn_scores")
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v).reshape(B, Sq, H * hd)
    out = _constrain(out, "attn_out")
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


# --------------------------------------------------------------------------
# Mixture of Experts: capacity-based scatter dispatch (Switch-style), as the
# reference: each expert takes at most C tokens in arrival order, the rest
# go to a dropped slot that contributes 0.
# --------------------------------------------------------------------------
def moe_defs(cfg: ModelConfig) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    d = {
        "router": ParamDef((D, E), ("embed", None), torch.float32,
                           init="normal", scale=0.1),
        "w1": ParamDef((E, D, Fd), ("expert", "expert_ffn", None),
                       cfg.param_dtype, init="lecun"),
        "w3": ParamDef((E, D, Fd), ("expert", "expert_ffn", None),
                       cfg.param_dtype, init="lecun"),
        "w2": ParamDef((E, Fd, D), ("expert", None, "expert_ffn"),
                       cfg.param_dtype, init="lecun"),
    }
    if cfg.moe_shared_expert:
        d["shared"] = mlp_defs(cfg)
    if cfg.moe_dense_residual:
        d["dense"] = mlp_defs(cfg)
    return d


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S, D = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    N = B * S
    xf = x.reshape(N, D)

    # router matmul in the compute dtype, softmax in f32
    logits = (xf @ p["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k breaks ties by the lower index and torch.topk does not say;
    # random f32 router logits have no ties, so no rule is added here
    gates, sel = torch.topk(probs, k, dim=-1)              # (N, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    C = int((k * N / E) * cfg.moe_capacity_factor)
    C = max(8, -(-C // 8) * 8)
    eid = sel.reshape(-1)                                  # (N*k,)
    onehot = F.one_hot(eid, E).float()                     # (N*k, E)
    pos = ((torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1.0).long()
    keep = pos < C
    slot = torch.where(keep, eid * C + pos, E * C)         # overflow -> drop

    # gather-based dispatch: scatter the token ids into the (E*C+1,) slot
    # table, then gather rows (the dropped slot's entry is never read)
    token_of = torch.arange(N * k, device=x.device) // k
    dispatch = torch.full((E * C + 1,), N, dtype=torch.long, device=x.device)
    dispatch[slot] = token_of
    xf_pad = torch.cat([xf, xf.new_zeros(1, D)], dim=0)
    xe = _constrain(xf_pad[dispatch[:E * C]].reshape(E, C, D),
                    "moe_dispatch")

    h = F.silu(torch.bmm(xe, p["w1"])) * torch.bmm(xe, p["w3"])
    ye = _constrain(torch.bmm(h, p["w2"]), "moe_dispatch")  # (E, C, D)

    ypad = torch.cat([ye.reshape(E * C, D), ye.new_zeros(1, D)], dim=0)
    contrib = ypad[slot] * gates.reshape(-1)[:, None].to(ye.dtype)
    y = contrib.reshape(N, k, D).sum(dim=1)

    if cfg.moe_shared_expert:
        y = y + mlp(p["shared"], xf, cfg)
    if cfg.moe_dense_residual:
        y = y + mlp(p["dense"], xf, cfg)
    return y.reshape(B, S, D)


def moe_aux_loss(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Switch load-balancing loss: E * sum_e f_e * p_e."""
    D = x.shape[-1]
    xf = x.reshape(-1, D)
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    top = probs.argmax(dim=-1)
    f = F.one_hot(top, cfg.moe_experts).float().mean(dim=0)
    pbar = probs.mean(dim=0)
    return cfg.moe_experts * (f * pbar).sum()
