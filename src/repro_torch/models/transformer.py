"""The LM, the port of `repro.models.transformer`: one model class whose
config selects the layer plan, with its training loss (`loss`, through
autograd) and its serving path, `prefill` and `decode_step` over a
per-block cache (KV, RG-LRU or SSD state, and the cross-attention memory
of the encoder-decoder).

  dense / vlm        [("attn_dense",) x L]
  moe interleave=1   [("attn_moe",) x L]                       (arctic)
  moe interleave=2   [("attn_dense", "attn_moe") x L/2]        (llama4)
  hybrid 1:2         [("rec","rec","attn_local") x L//3 + rest] (recurrentgemma)
  ssm                [("ssm",) x L]                            (mamba2)
  encdec             encoder [("enc",) x Le] + decoder [("dec",) x Ld]

Parameters are a plain tree as in the reference (`{"embed", "final_norm",
"stacks": [...], "unembed"?, "pos"?, "encoder"?, "frontend"?}`, each
stack's leaves carrying a leading layer axis); a Python loop over that axis
takes the place of `lax.scan`.  A gradient of a stacked leaf accumulates
the gradients of its layers' views.  With `cfg.remat`, each layer group's
forward (each encoder layer's) runs under `torch.utils.checkpoint` when
autograd records, as the reference wraps its scanned function in
`jax.checkpoint`.  The cache is written in place: `prefill` and
`decode_step` return the cache they were given, updated.

    model = LM(configs.get("qwen2_1_5b"), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cache = model.init_cache(1, 2048)
    logits, cache = model.prefill(params, {"tokens": prompt[None]}, cache)
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.distributed.ctx import (  # noqa: F401 (re-export)
    activation_sharding, constrain as _constrain)
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models.common import (ModelConfig, ParamDef, init_params,
                                       tree_map_defs)

ATTENTION_KINDS = ("attn_dense", "attn_moe", "attn_local", "enc", "dec")


def _block_defs(cfg: ModelConfig, kind: str) -> dict:
    if kind in ("attn_dense", "attn_local", "enc"):
        return {"ln1": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
                "ln2": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)}
    if kind == "attn_moe":
        return {"ln1": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
                "ln2": L.norm_defs(cfg), "moe": L.moe_defs(cfg)}
    if kind == "rec":
        return {"ln1": L.norm_defs(cfg), "rec": R.rglru_defs(cfg),
                "ln2": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)}
    if kind == "ssm":
        return {"ln1": L.norm_defs(cfg), "ssm": R.ssd_defs(cfg)}
    if kind == "dec":
        return {"ln1": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
                "lnx": L.norm_defs(cfg), "xattn": L.attention_defs(cfg),
                "ln2": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)}
    raise ValueError(kind)


def _block_cache(cfg: ModelConfig, kind: str, batch: int, seq: int,
                 device) -> dict:
    """One block's zero cache, (batch, ...) leaves."""
    dt = cfg.compute_dtype
    if kind in ("attn_dense", "attn_moe", "attn_local", "dec"):
        shape = (batch, seq, cfg.num_kv_heads, cfg.hd)
        c = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
        if kind == "dec":
            xshape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.hd)
            c["xk"] = torch.zeros(xshape, dtype=dt, device=device)
            c["xv"] = torch.zeros(xshape, dtype=dt, device=device)
        return c
    if kind == "rec":
        return R.rglru_init_state(cfg, batch, device)._asdict()
    if kind == "ssm":
        return R.ssd_init_state(cfg, batch, device)._asdict()
    raise ValueError(kind)


def _copy_into(cache: dict, state: dict) -> None:
    """Write a new recurrent state into the cache's views, in place."""
    for name, t in state.items():
        cache[name].copy_(t)


def _stack(defs: Any, n: int) -> Any:
    return tree_map_defs(
        lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes, d.dtype,
                           d.init, d.scale), defs)


def _layer(tree: Any, g: int) -> Any:
    """Layer g's views of a stacked parameter or cache tree."""
    if isinstance(tree, torch.Tensor):
        return tree[g]
    return {k: _layer(v, g) for k, v in tree.items()}


def _unstack(tree: Any, n: int) -> list:
    """The n layers' views of a stacked parameter tree, through one
    `unbind` a leaf: its backward stacks the layers' gradients into one
    tensor, where indexing each layer would add a zero-filled gradient of
    the whole leaf per layer."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    by_key = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: layers[g] for k, layers in by_key.items()}
            for g in range(n)]


def _from_reference(defs: Any, tree: Any, device, path: str = "") -> Any:
    """Copy a reference parameter tree (numpy or ml_dtypes arrays) into
    tensors of the defs' dtypes; bf16 goes through f32, which is exact."""
    if isinstance(defs, ParamDef):
        arr = np.asarray(tree)
        if tuple(arr.shape) != tuple(defs.shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)} != "
                             f"{tuple(defs.shape)}")
        return torch.from_numpy(np.array(arr, np.float32)).to(
            device=device, dtype=defs.dtype)
    if isinstance(defs, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(defs):
            raise ValueError(f"{path}: expected a list of {len(defs)}")
        return [_from_reference(d, t, device, f"{path}[{i}]")
                for i, (d, t) in enumerate(zip(defs, tree))]
    if set(tree) != set(defs):
        raise ValueError(f"{path or 'params'}: tree has {sorted(tree)}, "
                         f"model has {sorted(defs)}")
    return {k: _from_reference(defs[k], tree[k], device, f"{path}.{k}")
            for k in defs}


class LM:
    """The LM on one device (`device="cuda"` by default; "cpu" runs
    attention through the plain `attention_ref`; "meta" holds shapes only,
    for the dry-run, with attn_impl "einsum" or "flash_stub")."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        if cfg.attn_impl not in ("einsum", "flash", "flash_stub"):
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
        if cfg.pos_embed not in ("rope", "learned", "none"):
            raise ValueError(f"unknown pos_embed {cfg.pos_embed!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plan = self._layer_plan()          # [(kinds tuple, n_groups)]

    # ---- plan ----------------------------------------------------------------
    def _layer_plan(self) -> list[tuple[tuple[str, ...], int]]:
        cfg = self.cfg
        if cfg.family == "ssm":
            return [(("ssm",), cfg.num_layers)]
        if cfg.family == "hybrid":
            k = cfg.hybrid_attn_every
            group = ("rec",) * (k - 1) + ("attn_local",)
            n, rem = divmod(cfg.num_layers, k)
            plan = [(group, n)]
            if rem:
                plan.append((("rec",) * rem, 1))
            return plan
        if cfg.family == "encdec":
            return [(("dec",), cfg.num_layers)]
        if cfg.moe_experts:
            il = cfg.moe_interleave
            group = ("attn_dense",) * (il - 1) + ("attn_moe",)
            if cfg.num_layers % il:
                raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not "
                                 f"interleave by {il}")
            return [(group, cfg.num_layers // il)]
        return [(("attn_dense",), cfg.num_layers)]

    def attention_layers(self) -> int:
        """Self-attention layers one prefill or decode step of the decoder
        runs (each one `flash_attention` call on the flash path); the
        encoder's are `cfg.encoder_layers` more a prefill, and the
        decoder's cross-attention layers (`cross_attention_layers`) more a
        decode step."""
        return sum(n * sum(k in ATTENTION_KINDS for k in kinds)
                   for kinds, n in self.plan)

    def cross_attention_layers(self) -> int:
        """Cross-attention layers of the decoder: on the flash path each is
        one `flash_attention` call a decode step (over the encoded memory)
        and none a prefill (which encodes it on the einsum path)."""
        return sum(n * kinds.count("dec") for kinds, n in self.plan)

    # ---- params ----------------------------------------------------------------
    def param_defs(self) -> dict:
        cfg = self.cfg
        V, D = cfg.padded_vocab, cfg.d_model
        defs: dict = {
            "embed": ParamDef((V, D), ("vocab", "embed"), cfg.param_dtype,
                              init="normal"),
            "final_norm": L.norm_defs(cfg),
            "stacks": [
                _stack({f"b{i}": _block_defs(cfg, kind)
                        for i, kind in enumerate(kinds)}, n)
                for kinds, n in self.plan
            ],
        }
        if not cfg.tie_embeddings:
            defs["unembed"] = ParamDef((D, V), ("embed", "vocab"),
                                       cfg.param_dtype, init="normal")
        if cfg.pos_embed == "learned":
            defs["pos"] = ParamDef((cfg.max_position, D), (None, "embed"),
                                   cfg.param_dtype, init="normal")
        if cfg.family == "encdec":
            defs["encoder"] = {
                "stack": _stack({"b0": _block_defs(cfg, "enc")},
                                cfg.encoder_layers),
                "final_norm": L.norm_defs(cfg),
                "pos": ParamDef((cfg.encoder_seq, D), (None, "embed"),
                                cfg.param_dtype, init="normal"),
                "frontend": ParamDef((D, D), ("embed", None),
                                     cfg.param_dtype, init="lecun"),
            }
        if cfg.frontend == "vision_stub":
            defs["frontend"] = ParamDef((D, D), ("embed", None),
                                        cfg.param_dtype, init="lecun")
        return defs

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn on `generator`'s device (a CUDA generator
        fills a full-width model on the card), then moved to the model's."""
        return tree_map_tensors(lambda t: t.to(self.device),
                                init_params(self.param_defs(), generator))

    def load_reference_params(self, tree: Any) -> dict:
        """The reference's parameter pytree (`repro.models.transformer.LM.
        init`, leaves converted with np.asarray) as this model's params."""
        return _from_reference(self.param_defs(), tree, self.device)

    # ---- blocks ----------------------------------------------------------------
    def _apply_block(self, kind: str, p: dict, x, *, mode="train",
                     cache=None, index=None, enc_out=None):
        """mode: train (no cache) | prefill (sequence, fill the cache) |
        decode (one step against the cache).  The cache's views are
        written in place."""
        cfg = self.cfg
        res_scale = cfg.residual_scale
        if kind in ATTENTION_KINDS:
            h = L.apply_norm(p["ln1"], x, cfg)
            window = None
            if kind == "attn_local":
                window = cfg.local_window
            elif cfg.attn_window is not None:
                window = cfg.attn_window
            kv = None if cache is None else (cache["k"], cache["v"])
            a, _ = L.attention(p["attn"], h, cfg, kv_cache=kv,
                               cache_index=index, causal=(kind != "enc"),
                               window=window)
            x = x + res_scale * a
            if kind == "dec":
                h = L.apply_norm(p["lnx"], x, cfg)
                xkv = None if cache is None else (cache["xk"], cache["xv"])
                a, _ = L.attention(p["xattn"], h, cfg, kv_x=enc_out,
                                   kv_cache=xkv, causal=False,
                                   static_kv=cache is not None)
                x = x + res_scale * a
            h = L.apply_norm(p["ln2"], x, cfg)
            if kind == "attn_moe":
                m = L.moe_block(p["moe"], h, cfg)
            else:
                m = L.mlp(p["mlp"], h, cfg)
            return x + res_scale * m
        if kind == "rec":
            h = L.apply_norm(p["ln1"], x, cfg)
            st = R.RGLRUState(**cache) if mode == "decode" else None
            r, st_new = R.rglru_block(p["rec"], h, cfg, st,
                                      return_state=(mode == "prefill"))
            if st_new is not None and cache is not None:
                _copy_into(cache, st_new._asdict())
            x = x + res_scale * r
            h = L.apply_norm(p["ln2"], x, cfg)
            return x + res_scale * L.mlp(p["mlp"], h, cfg)
        if kind == "ssm":
            h = L.apply_norm(p["ln1"], x, cfg)
            st = R.SSDState(**cache) if mode == "decode" else None
            s, st_new = R.ssd_block(p["ssm"], h, cfg, st,
                                    return_state=(mode == "prefill"))
            if st_new is not None and cache is not None:
                _copy_into(cache, st_new._asdict())
            return x + res_scale * s
        raise ValueError(kind)

    def _remat(self) -> bool:
        """Recompute layers in the backward: the config asks for it and
        autograd records this forward."""
        return self.cfg.remat and torch.is_grad_enabled()

    def _run_stacks(self, params: dict, x, *, mode="train", caches=None,
                    index=None, enc_out=None):
        for si, (kinds, n) in enumerate(self.plan):
            def group(h, gp, g, _kinds=kinds, _si=si):
                for i, kind in enumerate(_kinds):
                    cache = (None if caches is None
                             else _layer(caches[_si][f"b{i}"], g))
                    h = self._apply_block(kind, gp[f"b{i}"], h, mode=mode,
                                          cache=cache, index=index,
                                          enc_out=enc_out)
                return h

            for g, gp in enumerate(_unstack(params["stacks"][si], n)):
                if caches is None and self._remat():
                    x = checkpoint(group, x, gp, g, use_reentrant=False)
                else:
                    x = group(x, gp, g)
        return x

    # ---- embedding / head ----------------------------------------------------
    def _embed(self, params: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x = params["embed"][tokens].to(cfg.compute_dtype)
        x = x * cfg.embed_scale
        if cfg.pos_embed == "learned":
            pos = batch.get("positions")
            if pos is None:
                pos = torch.arange(tokens.shape[1], device=self.device)
            pos = torch.as_tensor(pos, device=self.device).long()
            x = x + params["pos"][pos].to(x.dtype)
        if cfg.frontend == "vision_stub" and "patches" in batch:
            patches = torch.as_tensor(batch["patches"], device=self.device)
            pe = patches.to(x.dtype) @ params["frontend"]
            x = torch.cat([pe, x], dim=1)
        return _constrain(x, "activations")

    def _head(self, params: dict, x) -> torch.Tensor:
        cfg = self.cfg
        x = L.apply_norm(params["final_norm"], x, cfg)
        if cfg.tie_embeddings:
            logits = x @ params["embed"].T
        else:
            logits = x @ params["unembed"]
        if cfg.padded_vocab != cfg.vocab_size:      # mask padded vocab
            mask = torch.arange(cfg.padded_vocab,
                                device=x.device) < cfg.vocab_size
            logits = torch.where(mask, logits, -1e30)
        return logits

    def _encode(self, params: dict, batch: dict) -> torch.Tensor:
        """The whisper encoder over stub frame embeddings (B, S_enc, D)."""
        cfg = self.cfg
        enc = params["encoder"]
        frames = torch.as_tensor(batch["frames"], device=self.device)
        x = frames.to(cfg.compute_dtype) @ enc["frontend"]
        x = x + enc["pos"][:x.shape[1]].to(x.dtype)

        def layer(h, gp):
            return self._apply_block("enc", gp["b0"], h)

        for gp in _unstack(enc["stack"], cfg.encoder_layers):
            x = (checkpoint(layer, x, gp, use_reentrant=False)
                 if self._remat() else layer(x, gp))
        return L.apply_norm(enc["final_norm"], x, cfg)

    # ---- public API ----------------------------------------------------------
    def forward(self, params: dict, batch: dict) -> torch.Tensor:
        """Teacher-forced logits (B, S, padded_vocab); a vlm batch's
        `patches` (B, P, D) come first, so S counts them."""
        enc_out = None
        if self.cfg.family == "encdec":
            enc_out = self._encode(params, batch)
        x = self._embed(params, batch)
        x = self._run_stacks(params, x, enc_out=enc_out)
        return self._head(params, x)

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy over the labels >= 0 (B, S), in
        f32 from one f32 copy of the logits; a vlm batch's patch rows are
        cut off first."""
        logits = self.forward(params, batch)
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        if self.cfg.frontend == "vision_stub" and "patches" in batch:
            logits = logits[:, batch["patches"].shape[1]:, :]
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        # a masked label reads column 0; its term is multiplied by 0
        lab = torch.take_along_dim(logits, labels.clamp_min(0)[..., None],
                                   dim=-1)[..., 0]
        mask = (labels >= 0).float()
        return ((lse - lab) * mask).sum() / mask.sum().clamp_min(1.0)

    # ---- serving ----------------------------------------------------------
    def init_cache(self, batch_size: int, seq_len: int) -> list:
        """Per stack, per block: the block's zero cache with a leading
        layer axis, (layers, B, ...) leaves: k and v (layers, B, S, KV,
        hd), the decoder's cross-attention xk and xv over `encoder_seq`
        rows, RG-LRU conv (layers, B, 3, W) and h (layers, B, W), SSD conv
        (layers, B, 3, DI + 2N) and h (layers, B, H, P, N)."""
        cfg = self.cfg
        caches = []
        for kinds, n in self.plan:
            group = {}
            for i, kind in enumerate(kinds):
                one = _block_cache(cfg, kind, batch_size, seq_len,
                                   self.device)
                group[f"b{i}"] = {
                    name: t[None].repeat((n,) + (1,) * t.dim())
                    for name, t in one.items()}
            caches.append(group)
        return caches

    def prefill(self, params: dict, batch: dict, cache: list):
        """Run the prompt (with a vlm's patches first, an encdec's frames
        through the encoder) through the model, writing its K/V at cache
        rows [0, S) and the recurrent states after it; returns (last-token
        logits (B, 1, V), cache)."""
        enc_out = None
        if self.cfg.family == "encdec":
            enc_out = self._encode(params, batch)
        x = self._embed(params, batch)
        x = self._run_stacks(params, x, mode="prefill", caches=cache,
                             index=0, enc_out=enc_out)
        return self._head(params, x[:, -1:, :]), cache

    def decode_step(self, params: dict, token, cache: list, index):
        """One decode step. token: (B, 1); index: int, or (B,) int32 per-slot
        positions on the model's device."""
        batch = {"tokens": token}
        if self.cfg.pos_embed == "learned":
            pos = torch.as_tensor(index, device=self.device)
            batch["positions"] = (pos[:, None] if pos.dim() == 1
                                  else pos[None])
        x = self._embed(params, batch)
        x = self._run_stacks(params, x, mode="decode", caches=cache,
                             index=index)
        return self._head(params, x), cache


def tree_map_tensors(fn, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, list):
        return [tree_map_tensors(fn, t) for t in tree]
    return {k: tree_map_tensors(fn, v) for k, v in tree.items()}
