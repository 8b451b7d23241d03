"""The reference's run of a cell's first training steps, on the blocks the
program sampled (once `check.bad_sample_ids` has found them sound), from
the benchmark's initial parameters, with the rows read from the
benchmark's own feature table."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import gnn


def level_rows(table: np.ndarray, seeds: np.ndarray,
               hop_nodes: Sequence[np.ndarray],
               device: torch.device) -> list[torch.Tensor]:
    """The feature rows of every hop level, read from `table` on the host
    and copied to `device`."""
    ids = [np.asarray(seeds, np.int64)] + [np.asarray(h, np.int64)
                                           for h in hop_nodes]
    return [torch.from_numpy(table[i]).to(device) for i in ids]


def follow(model: str, params0: dict, steps: Sequence[dict],
           table: np.ndarray, labels: np.ndarray, fanouts: Sequence[int],
           heads: int, lr: float, device: torch.device, *,
           tf32: bool = False, keep_seeds: float = 1.0,
           dtype: torch.dtype = torch.float32) -> dict:
    """Run the plain step over `steps` (each with "seeds" and "hop_nodes")
    from `params0`.  Returns each step's loss, the first step's gradients,
    the parameters after the first step and after the last.

    `tf32` computes the matrix products in TF32 (the control: the nearest
    precision below the configuration's float32).  `keep_seeds` < 1 takes
    the loss over that share of each batch's seeds only (a planted fault:
    part of the batch left out, the mean taken over the rest).  `dtype`
    float64 gives a witness nearer the exact step than either float32
    side."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        params = {g: {k: v.to(device, dtype) for k, v in grp.items()}
                  for g, grp in params0.items()}
        losses, first_grads = [], None
        for step in steps:
            levels = [r.to(dtype) for r in level_rows(
                table, step["seeds"], step["hop_nodes"], device)]
            y = torch.from_numpy(
                labels[np.asarray(step["seeds"], np.int64)]).to(device)
            if keep_seeds < 1.0:
                levels, y = _leading_seeds(levels, y, fanouts, keep_seeds)
            value, grads, params = gnn.sgd_step(model, params, levels, y,
                                                fanouts, heads, lr)
            losses.append(value)
            if first_grads is None:
                first_grads, params1 = grads, params
            del levels
        return {"losses": losses, "grads": first_grads, "params1": params1,
                "params": params}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _leading_seeds(levels, y, fanouts, share):
    """The first `share` of the seeds with their own subtrees."""
    keep = max(1, int(len(y) * share))
    out, n = [], keep
    for lvl, rows in enumerate(levels):
        out.append(rows[:n])
        if lvl < len(fanouts):
            n *= fanouts[lvl]
    return out, y[:keep]
