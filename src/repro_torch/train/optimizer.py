"""Optimizers built from scratch, the port of `repro.train.optimizer`:
AdamW and Adafactor with mixed precision (bf16 params, f32 master copy
and moments).

A state is a NamedTuple of trees shaped like the params, as the
reference's, so `train.checkpoint` writes it under the reference's leaf
names and either package restores the other's.  `update` works leaf by
leaf, and writes the state's tensors and the params in place (the
reference's trainer donates both to its jitted step) and returns them.
The ZeRO-1 placement helpers (`zero1_pspec`, `*_state_pspecs`) and
`abstract_state` (the state on the meta device) serve the dry-run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.launch.mesh import Mesh, P


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_dtype: torch.dtype = torch.float32
    # adafactor
    factored_min_dim: int = 128
    decay_rate: float = 0.8


class AdamWState(NamedTuple):
    step: torch.Tensor               # () int32
    m: Any
    v: Any
    master: Any                      # f32 master copy of the params


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any                          # row second moment (factored leaves)
    vc: Any                          # column second moment (factored)
    v: Any                           # full second moment (unfactored)
    master: Any


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the tensors of `tree` (nested dicts and lists), zipped with
    the same positions of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves(tree: Any) -> list:
    """The tensors of a nested dict/list tree, in traversal order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


def _clip(grads, max_norm):
    """f32 gradients scaled to a global norm of at most max_norm, and the
    norm before clipping."""
    gn = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gn


def _master(p: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    # a copy even when p is already f32: the master must not alias it
    return p.detach().to(cfg.master_dtype, copy=True)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


def _write_params(params, master) -> None:
    """The new params, the master cast to each param's dtype, in place."""
    with torch.no_grad():
        tree_map(lambda p, w: p.copy_(w), params, master)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def adamw_init(params, cfg: OptimizerConfig) -> AdamWState:
    def f32(p):
        return torch.zeros(p.shape, dtype=cfg.master_dtype, device=p.device)
    return AdamWState(step=_step0(params), m=tree_map(f32, params),
                      v=tree_map(f32, params),
                      master=tree_map(lambda p: _master(p, cfg), params))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: OptimizerConfig,
                 lr):
    grads, gn = _clip(grads, cfg.grad_clip)
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    def upd(g, m, v, w):
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        w.copy_(w - lr * (u + cfg.weight_decay * w))

    tree_map(upd, grads, state.m, state.v, state.master)
    _write_params(params, state.master)
    return params, AdamWState(step, state.m, state.v, state.master), gn


# --------------------------------------------------------------------------
# Adafactor (factored second moments: the memory-sane choice for the MoE
# archs, ~4 bytes/param of state against AdamW's 12)
# --------------------------------------------------------------------------
def _factored(shape, min_dim) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def adafactor_init(params, cfg: OptimizerConfig) -> AdafactorState:
    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vr(p):
        return zeros(p.shape[:-1] if _factored(p.shape, cfg.factored_min_dim)
                     else (1,), p)

    def vc(p):
        return zeros(p.shape[:-2] + p.shape[-1:]
                     if _factored(p.shape, cfg.factored_min_dim) else (1,), p)

    def vfull(p):
        return zeros((1,) if _factored(p.shape, cfg.factored_min_dim)
                     else p.shape, p)

    return AdafactorState(step=_step0(params), vr=tree_map(vr, params),
                          vc=tree_map(vc, params), v=tree_map(vfull, params),
                          master=tree_map(lambda p: _master(p, cfg), params))


@torch.no_grad()
def adafactor_update(grads, state: AdafactorState, params,
                     cfg: OptimizerConfig, lr):
    grads, gn = _clip(grads, cfg.grad_clip)
    step = state.step + 1
    t = step.float()
    beta2 = 1.0 - torch.pow(t, -cfg.decay_rate)

    def upd(g, vr, vc, v, w):
        g2 = g * g + 1e-30
        if _factored(g.shape, cfg.factored_min_dim):
            vr.copy_(beta2 * vr + (1 - beta2) * g2.mean(dim=-1))
            vc.copy_(beta2 * vc + (1 - beta2) * g2.mean(dim=-2))
            r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
            u = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :]
                     + cfg.eps)
        else:
            v.copy_(beta2 * v + (1 - beta2) * g2)
            u = g / (torch.sqrt(v) + cfg.eps)
        # update clipping (the Adafactor RMS rule), over the whole leaf:
        # every layer of a stacked leaf at once, as the reference
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        w.copy_(w - lr * (u + cfg.weight_decay * w))

    tree_map(upd, grads, state.vr, state.vc, state.v, state.master)
    _write_params(params, state.master)
    return params, AdafactorState(step, state.vr, state.vc, state.v,
                                  state.master), gn


# --------------------------------------------------------------------------
# unified facade
# --------------------------------------------------------------------------
def init(params, cfg: OptimizerConfig):
    return (adamw_init if cfg.name == "adamw" else adafactor_init)(params, cfg)


def update(grads, state, params, cfg: OptimizerConfig, lr):
    """(params, state, global grad norm before clipping); the params and
    the state's tensors are updated in place."""
    fn = adamw_update if cfg.name == "adamw" else adafactor_update
    return fn(grads, state, params, cfg, lr)


# --------------------------------------------------------------------------
# ZeRO-1: the optimizer state sharded over the data axis
# --------------------------------------------------------------------------
def zero1_pspec(param_spec: P, shape: tuple, mesh: Mesh,
                axis: str = "data") -> P:
    """Place `axis` on the first replicated dim divisible by its size;
    leaves the param's own model-parallel dims untouched."""
    n = mesh.shape[axis]
    spec = list(param_spec) + [None] * (len(shape) - len(param_spec))
    used = {a for s in spec if s for a in ((s,) if isinstance(s, str) else s)}
    if axis in used:
        return P(*spec)
    for i, (s, dim) in enumerate(zip(spec, shape)):
        if s is None and dim % n == 0 and dim >= n:
            spec[i] = axis
            return P(*spec)
    return P(*spec)


def _map_specs(fn, specs, shapes):
    """fn(spec, shape) over a params-shaped tree of specs and one of shapes
    (nested dicts and lists; a spec and a shape are leaves)."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, shapes[k]) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v, s) for v, s in zip(specs, shapes)]
    return fn(specs, tuple(shapes))


def adamw_state_pspecs(params_shapes, params_pspecs, mesh, zero1=True):
    def z(spec, shape):
        return zero1_pspec(spec, shape, mesh) if zero1 else spec
    like = _map_specs(z, params_pspecs, params_shapes)
    return AdamWState(step=P(), m=like, v=like, master=like)


def adafactor_state_pspecs(params_shapes, params_pspecs, mesh, zero1=True,
                           factored_min_dim=128):
    def z(spec, shape):
        return zero1_pspec(spec, shape, mesh) if zero1 else spec

    def row(spec, shape):
        if _factored(shape, factored_min_dim):
            return P(*list(spec)[:len(shape) - 1])
        return P()

    def col(spec, shape):
        if _factored(shape, factored_min_dim):
            s = list(spec)
            return P(*(s[:len(shape) - 2] + s[len(shape) - 1:len(shape)]))
        return P()

    def full(spec, shape):
        return z(spec, shape) if not _factored(shape, factored_min_dim) \
            else P()

    return AdafactorState(
        step=P(),
        vr=_map_specs(row, params_pspecs, params_shapes),
        vc=_map_specs(col, params_pspecs, params_shapes),
        v=_map_specs(full, params_pspecs, params_shapes),
        master=_map_specs(z, params_pspecs, params_shapes),
    )


def opt_state_pspecs(name: str, params_shapes, params_pspecs, mesh,
                     zero1: bool = True):
    if name == "adamw":
        return adamw_state_pspecs(params_shapes, params_pspecs, mesh, zero1)
    return adafactor_state_pspecs(params_shapes, params_pspecs, mesh, zero1)


def abstract_state(name: str, params_abstract, cfg: OptimizerConfig):
    """The optimizer state of params on the meta device (`init` over meta
    tensors of the params' shapes and dtypes): nothing is allocated."""
    def meta(p):
        p = getattr(p, "value", p)           # a Placed param or a tensor
        return torch.empty(p.shape, dtype=p.dtype, device="meta")
    return init(tree_map(meta, params_abstract),
                dataclasses.replace(cfg, name=name))
