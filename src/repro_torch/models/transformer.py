"""The LM, the port's subset of `repro.models.transformer`: the dense
family (`[("attn_dense",) x L]`) with its serving path, `prefill` and
`decode_step` over a KV cache.  The moe, ssm, hybrid and encdec families,
`loss` and training wait (ROADMAP.md Queue 1 item 10).

Parameters are a plain tree as in the reference (`{"embed", "final_norm",
"stacks": [...], "unembed"?}`, each stack's leaves carrying a leading
layer axis); a Python loop over that axis takes the place of `lax.scan`.
The KV cache is written in place: `prefill` and `decode_step` return the
cache they were given, updated.

    model = LM(configs.get("qwen2_1_5b"), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cache = model.init_cache(1, 2048)
    logits, cache = model.prefill(params, {"tokens": prompt[None]}, cache)
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import (ModelConfig, ParamDef, init_params,
                                       tree_map_defs)


def _block_defs(cfg: ModelConfig, kind: str) -> dict:
    if kind == "attn_dense":
        return {"ln1": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
                "ln2": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)}
    raise ValueError(kind)


def _stack(defs: Any, n: int) -> Any:
    return tree_map_defs(
        lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes, d.dtype,
                           d.init, d.scale), defs)


def _layer(tree: Any, g: int) -> Any:
    """Layer g's views of a stacked parameter or cache tree."""
    if isinstance(tree, torch.Tensor):
        return tree[g]
    return {k: _layer(v, g) for k, v in tree.items()}


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
    """The dense LM on one device (`device="cuda"` by default; "cpu" runs
    attention through the plain `attention_ref`)."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        if cfg.attn_impl == "flash_stub":
            raise NotImplementedError(
                "attn_impl='flash_stub' is the reference's dry-run stand-in; "
                "it waits for the launch and distributed slice (ROADMAP.md "
                "Queue 1 item 11)")
        if cfg.attn_impl not in ("einsum", "flash"):
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
        if cfg.pos_embed not in ("rope", "none"):
            raise NotImplementedError(
                f"pos_embed={cfg.pos_embed!r} (learned positions, whisper) is "
                f"not ported yet (ROADMAP.md Queue 1 item 10)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plan = self._layer_plan()          # [(kinds tuple, n_groups)]

    def _layer_plan(self) -> list[tuple[tuple[str, ...], int]]:
        cfg = self.cfg
        if cfg.family != "dense" or cfg.moe_experts:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported yet; "
                f"the port has the dense plan only (ROADMAP.md Queue 1 item "
                f"10)")
        return [(("attn_dense",), cfg.num_layers)]

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
    def _apply_block(self, kind: str, p: dict, x, *, cache=None, index=None):
        cfg = self.cfg
        if kind != "attn_dense":
            raise ValueError(kind)
        res_scale = cfg.residual_scale
        h = L.apply_norm(p["ln1"], x, cfg)
        kv = None if cache is None else (cache["k"], cache["v"])
        a, _ = L.attention(p["attn"], h, cfg, kv_cache=kv, cache_index=index,
                           causal=True, window=cfg.attn_window)
        x = x + res_scale * a
        h = L.apply_norm(p["ln2"], x, cfg)
        return x + res_scale * L.mlp(p["mlp"], h, cfg)

    def _run_stacks(self, params: dict, x, *, caches=None, index=None):
        for si, (kinds, n) in enumerate(self.plan):
            stack_params = params["stacks"][si]
            stack_cache = None if caches is None else caches[si]
            for g in range(n):
                gp = _layer(stack_params, g)
                for i, kind in enumerate(kinds):
                    gc = (None if stack_cache is None
                          else _layer(stack_cache[f"b{i}"], g))
                    x = self._apply_block(kind, gp[f"b{i}"], x, cache=gc,
                                          index=index)
        return x

    # ---- embedding / head ----------------------------------------------------
    def _embed(self, params: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x = params["embed"][tokens].to(cfg.compute_dtype)
        return x * cfg.embed_scale

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

    # ---- public API ----------------------------------------------------------
    def forward(self, params: dict, batch: dict) -> torch.Tensor:
        """Teacher-forced logits (B, S, padded_vocab)."""
        x = self._embed(params, batch)
        x = self._run_stacks(params, x)
        return self._head(params, x)

    # ---- serving ----------------------------------------------------------
    def init_cache(self, batch_size: int, seq_len: int) -> list:
        """Per stack, per block: zero k and v of (layers, B, S, KV, hd)."""
        cfg = self.cfg
        shape = (batch_size, seq_len, cfg.num_kv_heads, cfg.hd)
        return [{f"b{i}": {name: torch.zeros((n,) + shape,
                                             dtype=cfg.compute_dtype,
                                             device=self.device)
                           for name in ("k", "v")}
                 for i, _ in enumerate(kinds)}
                for kinds, n in self.plan]

    def prefill(self, params: dict, batch: dict, cache: list):
        """Run the prompt through the model, writing its K/V at cache rows
        [0, S); returns (last-token logits (B, 1, V), cache)."""
        x = self._embed(params, batch)
        x = self._run_stacks(params, x, caches=cache, index=0)
        return self._head(params, x[:, -1:, :]), cache

    def decode_step(self, params: dict, token, cache: list, index):
        """One decode step. token: (B, 1); index: int, or (B,) int32 per-slot
        positions on the model's device."""
        x = self._embed(params, {"tokens": token})
        x = self._run_stacks(params, x, caches=cache, index=index)
        return self._head(params, x), cache


def tree_map_tensors(fn, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, list):
        return [tree_map_tensors(fn, t) for t in tree]
    return {k: tree_map_tensors(fn, v) for k, v in tree.items()}
