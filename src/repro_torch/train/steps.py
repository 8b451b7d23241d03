"""Step functions, the port of `repro.train.steps`: training (gradients
through autograd and the optimizer, with optional microbatch
accumulation) and serving (prefill / decode).

A train step differentiates the loss with respect to every leaf of the
params (each stacked leaf once: its layers' gradients accumulate into it),
reads the rate from the schedule at the state's step BEFORE the optimizer
increments it (so a warmup schedule's first step has rate 0 and moves no
parameter, as in the reference), and updates the params and the state in
place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import OptimizerConfig, leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    microbatches: int = 1
    schedule: Callable = staticmethod(lambda step: 3e-4)


def _grads(model, params, batch) -> tuple[torch.Tensor, list]:
    """The loss and d loss / d leaf for every leaf of params (zeros for a
    leaf the batch does not reach, as jax.grad gives)."""
    ps = leaves(params)
    was = [p.requires_grad for p in ps]
    with torch.enable_grad():
        for p in ps:
            p.requires_grad_(True)
        try:
            loss = model.loss(params, batch)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        finally:
            for p, w in zip(ps, was):
                p.requires_grad_(w)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(ps, grads)]


def _split(batch: dict, m: int) -> list[dict]:
    """m microbatches: row blocks of every batch entry, in order."""
    def part(x, i):
        n = x.shape[0] // m
        return x[i * n:(i + 1) * n]
    return [{k: part(v, i) for k, v in batch.items()} for i in range(m)]


def make_train_step(model, tcfg: TrainConfig):
    ocfg = tcfg.optimizer

    def train_step(params, opt_state, batch):
        if tcfg.microbatches > 1:
            m = tcfg.microbatches
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves(params)]
            losses = []
            for mb in _split(batch, m):
                loss, grads = _grads(model, params, mb)
                for a, g in zip(acc, grads):
                    a.copy_(a + g.float() / m)
                del grads
                losses.append(loss)
            grads, loss = acc, torch.stack(losses).mean()
        else:
            loss, grads = _grads(model, params, batch)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        lr = tcfg.schedule(opt_state.step)
        params, new_state, gn = opt_lib.update(grads, opt_state, params,
                                               ocfg, lr)
        metrics = {"loss": loss, "grad_norm": gn, "lr": lr}
        return params, new_state, metrics

    return train_step


def make_prefill_step(model):
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill_step


def make_decode_step(model):
    def decode_step(params, token, cache, index):
        logits, new_cache = model.decode_step(params, token, cache, index)
        next_token = logits[:, -1, :].argmax(dim=-1).to(torch.int32)
        return next_token[:, None], new_cache
    return decode_step
