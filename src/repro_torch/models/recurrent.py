"""Recurrent mixers, the port of `repro.models.recurrent`: RG-LRU
(recurrentgemma / Griffin) and Mamba-2 SSD.

Both have a sequence form (prefill, parallel across S) and a single-step
form (decode, an O(1) state update).  The reference runs the sequence
recurrences with `jax.lax.associative_scan`; here `_linear_scan` runs the
same first-order recurrence h_t = a_t h_{t-1} + b_t as a log-depth
doubling scan of plain torch operations (log2(S) rounds over the whole
sequence, never a Python loop over S), so values agree to rounding: the
summation order differs.  The JAX package has no Pallas kernel here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, ParamDef

RG_LRU_C = 8.0


def _linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along `dim` from h_{-1} = 0, for every t.
    `a` broadcasts against `b` (it may lack b's trailing axes).  Doubling
    (Hillis-Steele): after the round of step d each position holds the
    composition of the d..2d positions before it."""
    n = b.shape[dim]
    extra = b.dim() - a.dim()
    d = 1
    while d < n:
        a_prev = a.narrow(dim, 0, n - d)
        b_prev = b.narrow(dim, 0, n - d)
        a_cur = a.narrow(dim, d, n - d)
        b_cur = b.narrow(dim, d, n - d)
        a_b = a_cur.reshape(a_cur.shape + (1,) * extra)
        b = torch.cat([b.narrow(dim, 0, d), a_b * b_prev + b_cur], dim=dim)
        a = torch.cat([a.narrow(dim, 0, d), a_cur * a_prev], dim=dim)
        d *= 2
    return b


# --------------------------------------------------------------------------
# depthwise causal conv (width K), shared by both mixers
# --------------------------------------------------------------------------
def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x: (B,S,C), w: (K,C) depthwise, b: (C,); f32 out when w is f32, as
    the reference's promotion."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    return out + b.to(out.dtype)


def conv_step(state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """state: (B,K-1,C) trailing inputs; x_t: (B,1,C)."""
    window = torch.cat([state, x_t], dim=1)               # (B,K,C)
    out = torch.einsum("bkc,kc->bc", window.to(w.dtype), w) + b
    return window[:, 1:, :], out[:, None, :].to(x_t.dtype)


def _tail3(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The last 3 rows of x (B,S,C), zero-padded in front when S < 3: a
    prefill's conv state."""
    tail = x[:, -3:, :]
    pad = 3 - tail.shape[1]
    if pad > 0:
        tail = F.pad(tail, (0, 0, pad, 0))
    return tail.to(dtype)


# --------------------------------------------------------------------------
# RG-LRU block (Griffin recurrent residual block)
# --------------------------------------------------------------------------
def rglru_defs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    W = cfg.lru_width or D
    pd = cfg.param_dtype
    return {
        "w_in": ParamDef((D, W), ("embed", "lru"), pd, init="lecun"),
        "w_gate": ParamDef((D, W), ("embed", "lru"), pd, init="lecun"),
        "conv_w": ParamDef((4, W), ("conv", "lru"), torch.float32,
                           init="normal", scale=0.5),
        "conv_b": ParamDef((W,), ("lru",), torch.float32, init="zeros"),
        "wa": ParamDef((W, W), ("lru", None), pd, init="lecun"),
        "ba": ParamDef((W,), ("lru",), torch.float32, init="zeros"),
        "wx": ParamDef((W, W), ("lru", None), pd, init="lecun"),
        "bx": ParamDef((W,), ("lru",), torch.float32, init="zeros"),
        # Λ init so decay a ≈ U(0.9, 0.999) at r=1 (Griffin §2.4)
        "lam": ParamDef((W,), ("lru",), torch.float32, init="ones",
                        scale=1.0),
        "w_out": ParamDef((W, D), ("lru", "embed"), pd, init="lecun"),
    }


class RGLRUState(NamedTuple):
    conv: torch.Tensor   # (B, 3, W)
    h: torch.Tensor      # (B, W) f32


def rglru_init_state(cfg: ModelConfig, batch: int,
                     device=None) -> RGLRUState:
    W = cfg.lru_width or cfg.d_model
    return RGLRUState(
        conv=torch.zeros((batch, 3, W), dtype=cfg.compute_dtype,
                         device=device),
        h=torch.zeros((batch, W), dtype=torch.float32, device=device))


def _rglru_gates(p: dict, u: torch.Tensor):
    """u: post-conv input (..., W) -> decay a, driven input b (f32)."""
    uf = u.float()
    r = torch.sigmoid(uf @ p["wa"].float() + p["ba"])
    i = torch.sigmoid(uf @ p["wx"].float() + p["bx"])
    log_a = -RG_LRU_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)) \
        * (i * uf)
    return a, b


def rglru_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: RGLRUState | None = None, *,
                return_state: bool = False
                ) -> tuple[torch.Tensor, RGLRUState | None]:
    """x: (B,S,D).

    state None  -> sequence mode (prefill): a doubling scan over S; with
                   return_state=True also the final recurrent and conv
                   state.
    state given -> single-step decode (S must be 1).
    """
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    u_raw = x @ p["w_in"]

    if state is None:
        u = causal_conv(u_raw, p["conv_w"], p["conv_b"]).to(u_raw.dtype)
        a, b = _rglru_gates(p, u)
        h = _linear_scan(a, b, dim=1)
        new_state = None
        if return_state:
            new_state = RGLRUState(conv=_tail3(u_raw, cfg.compute_dtype),
                                   h=h[:, -1, :])
    else:
        new_conv, u1 = conv_step(state.conv, u_raw, p["conv_w"], p["conv_b"])
        a, b = _rglru_gates(p, u1)
        h1 = a[:, 0] * state.h + b[:, 0]
        h = h1[:, None, :]
        new_state = RGLRUState(conv=new_conv, h=h1)

    y = (h.to(x.dtype) * gate) @ p["w_out"]
    return y, new_state


# --------------------------------------------------------------------------
# Mamba-2 SSD block (state-space duality, chunked)
# --------------------------------------------------------------------------
def ssd_defs(cfg: ModelConfig) -> dict:
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    pd = cfg.param_dtype
    conv_ch = DI + 2 * N
    return {
        "wz": ParamDef((D, DI), ("embed", "ssm_inner"), pd, init="lecun"),
        "wx": ParamDef((D, DI), ("embed", "ssm_inner"), pd, init="lecun"),
        "wB": ParamDef((D, N), ("embed", "ssm_state"), pd, init="lecun"),
        "wC": ParamDef((D, N), ("embed", "ssm_state"), pd, init="lecun"),
        "wdt": ParamDef((D, H), ("embed", "ssm_heads"), pd, init="lecun"),
        "dt_bias": ParamDef((H,), ("ssm_heads",), torch.float32,
                            init="zeros"),
        "A_log": ParamDef((H,), ("ssm_heads",), torch.float32, init="ones"),
        "D_skip": ParamDef((H,), ("ssm_heads",), torch.float32, init="ones"),
        "conv_w": ParamDef((4, conv_ch), ("conv", None), torch.float32,
                           init="normal", scale=0.5),
        "conv_b": ParamDef((conv_ch,), (None,), torch.float32, init="zeros"),
        "norm": ParamDef((DI,), ("ssm_inner",), torch.float32, init="ones"),
        "w_out": ParamDef((DI, D), ("ssm_inner", "embed"), pd, init="lecun"),
    }


class SSDState(NamedTuple):
    conv: torch.Tensor   # (B, 3, DI + 2N)
    h: torch.Tensor      # (B, H, P, N) f32


def ssd_init_state(cfg: ModelConfig, batch: int, device=None) -> SSDState:
    DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    return SSDState(
        conv=torch.zeros((batch, 3, DI + 2 * N), dtype=cfg.compute_dtype,
                         device=device),
        h=torch.zeros((batch, H, P, N), dtype=torch.float32, device=device))


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    g = (y * F.silu(z)).float()
    return g * torch.rsqrt((g ** 2).mean(-1, keepdim=True) + eps) * scale


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) -> (..., Q, Q) lower-tri pairwise sums
    L[i,j] = sum_{j < k <= i} a_k  (i >= j), -inf above diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(Q, device=a.device)
    mask = ii[:, None] >= ii[None, :]
    return diff.masked_fill(~mask, float("-inf"))


def ssd_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
              state: SSDState | None = None, *,
              return_state: bool = False
              ) -> tuple[torch.Tensor, SSDState | None]:
    """Mamba-2 mixer. x: (B,S,D) -> (B,S,D).  Modes as in rglru_block."""
    Bsz, S, _ = x.shape
    DI, N = cfg.d_inner, cfg.ssm_state
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    z = x @ p["wz"]
    xc_raw = torch.cat([x @ p["wx"], x @ p["wB"], x @ p["wC"]], dim=-1)
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])     # (B,S,H)
    A = -torch.exp(p["A_log"])                                 # (H,)

    if state is None:
        xc = F.silu(causal_conv(xc_raw, p["conv_w"], p["conv_b"])
                    ).to(x.dtype)
        xs, Bm, Cm = torch.split(xc, [DI, N, N], dim=-1)
        xs = xs.reshape(Bsz, S, H, P)
        # pad S to a chunk multiple; padded steps get dt=0 (identity decay,
        # zero input) so outputs before S and the final state are exact.
        Q = cfg.ssm_chunk
        S_pad = -(-S // Q) * Q
        if S_pad != S:
            pad = S_pad - S
            xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, pad))
        y, h_final = _ssd_chunked(xs, dt, A, Bm, Cm, p["D_skip"], Q)
        if S_pad != S:
            y = y[:, :S]
        new_state = None
        if return_state:
            new_state = SSDState(conv=_tail3(xc_raw, cfg.compute_dtype),
                                 h=h_final)
    else:
        new_conv, xc1 = conv_step(state.conv, xc_raw, p["conv_w"],
                                  p["conv_b"])
        xc1 = F.silu(xc1).to(x.dtype)
        xs, Bm, Cm = torch.split(xc1, [DI, N, N], dim=-1)
        xs = xs.reshape(Bsz, 1, H, P)
        dtA = torch.exp(dt[:, 0] * A)                          # (B,H)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bm[:, 0].float(),
                           xs[:, 0].float())
        h = dtA[:, :, None, None] * state.h + dBx
        y = torch.einsum("bhpn,bn->bhp", h, Cm[:, 0].float())
        y = y + p["D_skip"][:, None] * xs[:, 0].float()
        y = y.reshape(Bsz, 1, DI)
        new_state = SSDState(conv=new_conv, h=h)

    y = _gated_rmsnorm(y.float(), z.float(), p["norm"],
                       cfg.norm_eps).to(x.dtype)
    return y @ p["w_out"], new_state


def _ssd_chunked(xs, dt, A, Bm, Cm, D_skip, Q: int):
    """Chunked SSD scan (Mamba-2 Alg. 1, single B/C group).

    xs: (B,S,H,P); dt: (B,S,H) f32; A: (H,); Bm/Cm: (B,S,N).  Quadratic
    attention-like compute within each chunk; the chunk states' linear
    recurrence h_c = cd_c * h_{c-1} + st_c by `_linear_scan` over the chunk
    axis.  The reference's five- and four-operand einsums run here as
    pairwise products, whose intermediates stay (B, nc, H, Q, Q) at most.
    Returns y (B,S,H*P) f32 and the final state (B,H,P,N).
    """
    Bsz, S, H, P = xs.shape
    N = Bm.shape[-1]
    nc = S // Q
    assert nc * Q == S, (S, Q)
    xs = xs.reshape(Bsz, nc, Q, H, P).float()
    dt = dt.reshape(Bsz, nc, Q, H)
    Bm = Bm.reshape(Bsz, nc, Q, N).float()
    Cm = Cm.reshape(Bsz, nc, Q, N).float()

    a = dt * A                                  # (B,nc,Q,H) log-decay
    a_cs = torch.cumsum(a, dim=2)
    # intra-chunk (diagonal blocks): sum_s C_l.B_s L[h,l,s] dt_s x_s
    L = torch.exp(_segsum(a.permute(0, 1, 3, 2)))           # (B,nc,H,Q,Q)
    G = torch.einsum("bcln,bcsn->bcls", Cm, Bm)             # (B,nc,Q,Q)
    M = G[:, :, None] * L * dt.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchls,bcshp->bclhp", M, xs)
    # per-chunk input states
    decay_states = torch.exp(a_cs[:, :, -1:, :] - a_cs)     # (B,nc,Q,H)
    w = (decay_states * dt)[..., None] * xs                 # (B,nc,Q,H,P)
    states = torch.einsum("bcsn,bcshp->bchpn", Bm, w)
    chunk_decay = torch.exp(a_cs[:, :, -1, :])              # (B,nc,H)

    h_inc = _linear_scan(chunk_decay, states, dim=1)        # (B,nc,H,P,N)
    h_last = h_inc[:, -1]
    h_prev = torch.cat([torch.zeros_like(h_inc[:, :1]), h_inc[:, :-1]],
                       dim=1)
    # inter-chunk contribution
    y_off = torch.einsum("bcln,bchpn->bclhp", Cm, h_prev) \
        * torch.exp(a_cs)[..., None]
    y = y_diag + y_off + D_skip[:, None] * xs               # (B,nc,Q,H,P)
    return y.reshape(Bsz, S, H * P), h_last
