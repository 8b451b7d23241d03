"""Abstract step arguments per (architecture x input shape) cell, the port
of `repro.launch.specs`.

Every stand-in is a `Placed` meta tensor: the shape and dtype of the real
argument on the meta device, with the `NamedSharding` it would have on the
mesh beside it, so the dry-run runs the step without allocating a byte.
The shape table is the reference's:

    train_4k     seq 4096,    global_batch 256   -> train_step
    prefill_32k  seq 32768,   global_batch 32    -> prefill_step
    decode_32k   cache 32768, global_batch 128   -> decode_step (1 token)
    long_500k    cache 524288, global_batch 1    -> decode_step (1 token)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.launch.mesh import (Mesh, NamedSharding, P, Placed,
                                     batch_axes, map_tree, specs, values)
from repro_torch.models.common import (ModelConfig, abstract_params,
                                       sharding_rules)
from repro_torch.models.transformer import LM
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import OptimizerConfig

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# archs whose attention is quadratic-full: long_500k is skipped
FULL_ATTENTION = {
    "llama4-maverick-400b-a17b", "arctic-480b", "minicpm-2b", "qwen3-14b",
    "qwen2-1.5b", "internvl2-1b", "whisper-small",
}


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and cfg.name in FULL_ATTENTION:
        return False, "SKIP(full-attention)"
    return True, ""


def _placed(shape, dtype, mesh: Mesh, spec: P) -> Placed:
    return Placed(torch.empty(shape, dtype=dtype, device="meta"),
                  NamedSharding(mesh, spec))


def _divshard(dim: int, mesh: Mesh, axis: str):
    return axis if dim % mesh.shape[axis] == 0 else None


def _batch_size(mesh: Mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def batch_specs(cfg: ModelConfig, mesh: Mesh, batch: int, seq: int,
                multi_pod: bool) -> dict:
    """Training / prefill batch stand-ins."""
    ba = batch_axes(multi_pod)
    bsharded = ba if batch % _batch_size(mesh, ba) == 0 \
        else (ba[:-1] if batch % mesh.shape[ba[0]] == 0 else ())
    bspec = P(bsharded if bsharded else None)
    tok_seq = seq
    if cfg.frontend == "vision_stub":
        # patches take the first frontend_tokens positions of the seq_len
        # long sequence (and of the serving cache)
        tok_seq = seq - cfg.frontend_tokens
    out = {
        "tokens": _placed((batch, tok_seq), torch.int32, mesh,
                          P(*bspec, None)),
        "labels": _placed((batch, tok_seq), torch.int32, mesh,
                          P(*bspec, None)),
    }
    if cfg.family == "encdec":
        out["frames"] = _placed((batch, cfg.encoder_seq, cfg.d_model),
                                torch.float32, mesh, P(*bspec, None, None))
    if cfg.frontend == "vision_stub":
        out["patches"] = _placed((batch, cfg.frontend_tokens, cfg.d_model),
                                 torch.float32, mesh, P(*bspec, None, None))
    return out


def cache_pspec_tree(model: LM, mesh: Mesh, batch: int, seq: int,
                     multi_pod: bool, kind: str = "decode"):
    """PartitionSpecs for the serving cache, the reference's: batch over
    the batch axes where it divides, the sequence dim over the model axis
    (prefill's full-range write is a plain copy; decode writes one row per
    sequence), recurrent widths and SSD heads over the model axis."""
    cfg = model.cfg
    ba = batch_axes(multi_pod)
    bspec: Any = ba if batch % _batch_size(mesh, ba) == 0 else (
        ba[0] if batch % mesh.shape[ba[0]] == 0 else None)
    dims = (_divshard(seq, mesh, "model"), None, None)

    out = []
    for kinds, _ in model.plan:
        group = {}
        for i, kind_i in enumerate(kinds):
            if kind_i in ("attn_dense", "attn_moe", "attn_local"):
                group[f"b{i}"] = {"k": P(None, bspec, *dims),
                                  "v": P(None, bspec, *dims)}
            elif kind_i == "dec":
                group[f"b{i}"] = {"k": P(None, bspec, *dims),
                                  "v": P(None, bspec, *dims),
                                  "xk": P(None, bspec, None, None, None),
                                  "xv": P(None, bspec, None, None, None)}
            elif kind_i == "rec":
                W = cfg.lru_width or cfg.d_model
                w = _divshard(W, mesh, "model")
                group[f"b{i}"] = {"conv": P(None, bspec, None, w),
                                  "h": P(None, bspec, w)}
            elif kind_i == "ssm":
                hshard = _divshard(cfg.ssm_heads, mesh, "model")
                group[f"b{i}"] = {"conv": P(None, bspec, None, None),
                                  "h": P(None, bspec, hshard, None, None)}
        out.append(group)
    return out


def abstract_cache(model: LM, mesh: Mesh, batch: int, seq: int,
                   multi_pod: bool, kind: str = "decode"):
    """The model's serving cache as `Placed` meta tensors (`init_cache` of
    the model, which must live on the meta device)."""
    if model.device.type != "meta":
        raise ValueError("abstract_cache needs a model on the meta device")
    shapes = model.init_cache(batch, seq)
    pspecs = cache_pspec_tree(model, mesh, batch, seq, multi_pod, kind)
    return map_tree(lambda t, spec: Placed(t, NamedSharding(mesh, spec)),
                    shapes, pspecs)


def activation_specs(cfg: ModelConfig, mesh: Mesh, multi_pod: bool,
                     batch: int | None = None, kind: str = "train",
                     expert_axis: str = "model") -> dict:
    """The reference's activation placements at each `constrain` anchor."""
    ba = batch_axes(multi_pod)
    e_ax = _divshard(cfg.moe_experts or 1, mesh, expert_axis)
    e_ax = expert_axis if e_ax else None
    if cfg.moe_2d_dispatch and kind in ("decode", "prefill"):
        # serving: expert weights stationary (2D-sharded E x D); the
        # dispatch activations shard their d_model dim over the data axis
        especs = P(e_ax, None, _divshard(cfg.d_model, mesh, "data"))
    else:
        especs = P(e_ax, None, None)
    # attention core: batch-parallel on the data axes
    attn_axes = list(ba)
    if batch is not None:
        if batch % _batch_size(mesh, ba):
            attn_axes = [a for a in ba if batch % mesh.shape[a] == 0][:1]
    aspec = P(tuple(attn_axes) if attn_axes else None, None, None, None)
    if kind == "decode":
        return {"activations": NamedSharding(mesh, P(ba, None, None))}
    return {
        "activations": NamedSharding(mesh, P(ba, None, None)),
        "moe_dispatch": NamedSharding(mesh, especs),
        "attn_act": NamedSharding(mesh, aspec),
        "attn_scores": NamedSharding(
            mesh, P(tuple(attn_axes) if attn_axes else None,
                    None, None, None, None)),
        "attn_scores_decode": NamedSharding(
            mesh, P(tuple(attn_axes) if attn_axes else None,
                    None, None, None, "model")),
        "attn_out": NamedSharding(mesh, P(ba, None, "model")),
    }


def optimizer_for(cfg: ModelConfig) -> OptimizerConfig:
    # Adafactor for the MoEs (4 B/param of state against AdamW's 12),
    # AdamW elsewhere
    if cfg.moe_experts:
        return OptimizerConfig(name="adafactor")
    return OptimizerConfig(name="adamw")


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    model: LM
    kind: str
    abstract_args: tuple            # step fn's positional args, as Placed
    step_fn: Any
    rules: dict
    batch: int = 0
    seq: int = 0

    def args(self) -> tuple:
        """The step's positional arguments: meta tensors (a decode index is
        a 0-dim int32 tensor)."""
        return tuple(values(a) for a in self.abstract_args)


def build_cell(arch: str, shape: str, mesh: Mesh, *, multi_pod: bool,
               strategy: str | None = None,
               overrides: dict | None = None) -> Cell:
    from repro_torch import configs
    from repro_torch.train.steps import (TrainConfig, make_decode_step,
                                         make_prefill_step, make_train_step)

    cfg = configs.get(arch)
    microbatches = 1
    if overrides:
        overrides = dict(overrides)
        microbatches = overrides.pop("microbatches", 1)
        cfg = dataclasses.replace(cfg, **overrides)
    spec = SHAPES[shape]
    kind, seq, batch = spec["kind"], spec["seq"], spec["batch"]
    model = LM(cfg, device="meta")
    if strategy is None:
        # the 400B-class models cannot fit TP-only; everything else TP
        strategy = "fsdp_tp" if cfg.moe_experts else "tp"
    rules = sharding_rules(strategy, multi_pod)
    params = abstract_params(model.param_defs(), rules, mesh)

    if kind == "train":
        ocfg = optimizer_for(cfg)
        state = opt_lib.abstract_state(ocfg.name, params, ocfg)
        shapes_tree = map_tree(lambda p: p.shape, params)
        ospecs = opt_lib.opt_state_pspecs(ocfg.name, shapes_tree,
                                          specs(params), mesh, zero1=True)
        state = map_tree(lambda t, sp: Placed(t, NamedSharding(mesh, sp)),
                         state, ospecs)
        batch_abs = batch_specs(cfg, mesh, batch, seq, multi_pod)
        step = make_train_step(model, TrainConfig(optimizer=ocfg,
                                                  microbatches=microbatches))
        args = (params, state, batch_abs)
    elif kind == "prefill":
        batch_abs = batch_specs(cfg, mesh, batch, seq, multi_pod)
        batch_abs.pop("labels")
        cache = abstract_cache(model, mesh, batch, seq, multi_pod,
                               kind="prefill")
        step = make_prefill_step(model)
        args = (params, batch_abs, cache)
    else:  # decode
        ba = batch_axes(multi_pod)
        bspec = P(ba if batch % _batch_size(mesh, ba) == 0 else None)
        token = _placed((batch, 1), torch.int32, mesh, P(*bspec, None))
        cache = abstract_cache(model, mesh, batch, seq, multi_pod)
        index = _placed((), torch.int32, mesh, P())
        step = make_decode_step(model)
        args = (params, token, cache, index)
    return Cell(arch=arch, shape=shape, cfg=cfg, model=model, kind=kind,
                abstract_args=args, step_fn=step, rules=rules, batch=batch,
                seq=seq)
