"""Plain R-GAT training steps and the relational sampler's checks, for the
`rgat` family: torch and numpy alone, importing nothing of the measured
package.

A kept batch holds global ids, not the program's positions: the seeds,
the levels (sorted unique ids, level 0 the seeds', the last the gathered
rows) and, per hop and relation in the configuration's order, the
destinations (`dst`), the drawn sources (`src`, one row of slots per
destination, -1 where masked) and the `mask`.  Once `bad_sample_ids` finds
a batch sound, the step reads every row by id from the benchmark's own
feature table and projects every slot on its own (no projection shared
between slots naming one node).  For layer l (hop k = L - 1 - l), relation
r, destination v, head k:

    z_u = W_r x_u,  z_v = W_r x_v,
    e_vu = LeakyReLU_0.2(a_src . z_u + a_dst . z_v),
    alpha_vu = softmax over v's unmasked slots (none where it has no edge),
    m_v,r = concat_k sum_u alpha_vu z_u + b_r,
    x_v' = LeakyReLU_0.01(sum_r m_v,r) (none after the last layer),
    logits = x_seed W_out + b_out, the loss their mean cross-entropy.

Departures from MLPerf's R-GAT on IGBH (the measured package makes the
same): neighbours drawn uniformly with replacement; no dropout (0.2 there),
so that program and reference agree on a step; plain SGD, `p -= lr *
grad`, in place of Adam.

Parameters: `{"layer{l}.{relation}": {"w", "attn_src", "attn_dst", "b"},
"head": {"w", "b"}}`, weights as (d_in, d_out), drawn by `gnn.init_params`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .gnn import init_params  # noqa: F401  (the same draws, leaf by leaf)


def param_shapes(in_dim: int, hidden: int, heads: int, classes: int,
                 layers: int, relations: Sequence[str]) -> dict:
    """Shape of every leaf; `relations` are the relations' names."""
    dims = [in_dim] + [hidden] * layers
    tree: dict = {}
    for l in range(layers):
        for name in relations:
            tree[f"layer{l}.{name}"] = {
                "w": (dims[l], hidden), "attn_src": (heads, hidden // heads),
                "attn_dst": (heads, hidden // heads), "b": (hidden,)}
    tree["head"] = {"w": (hidden, classes), "b": (classes,)}
    return tree


def _positions(level: np.ndarray, ids: np.ndarray,
               device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.searchsorted(level, ids)).to(device)


def _relation(p: dict, h: torch.Tensor, level: np.ndarray, dst: np.ndarray,
              src: np.ndarray, mask: np.ndarray, heads: int) -> torch.Tensor:
    """m_v,r of every destination, slot by slot; `h` holds the rows of
    `level` (the hop's next level)."""
    n, f = src.shape
    dev = h.device
    xs = h[_positions(level, np.where(mask, src, dst[:, None]), dev)]
    zs = (xs @ p["w"]).reshape(n, f, heads, -1)                # every slot
    zd = (h[_positions(level, dst, dev)] @ p["w"]).reshape(n, heads, -1)
    e = F.leaky_relu((zs * p["attn_src"]).sum(-1)
                     + (zd * p["attn_dst"]).sum(-1)[:, None], 0.2)
    valid = torch.from_numpy(np.asarray(mask)).to(dev)[..., None]
    e = torch.where(valid, e, float("-inf"))
    e = torch.where(valid.any(dim=1, keepdim=True), e, 0.0)   # no edge: 0s
    alpha = torch.softmax(e, dim=1) * valid
    return (alpha[..., None] * zs).sum(dim=1).reshape(n, -1) + p["b"]


def logits(params: dict, x: torch.Tensor, step: dict,
           relations: Sequence[str], heads: int) -> torch.Tensor:
    """Seed logits from `x`, the feature rows of the last level."""
    levels = step["levels"]
    L = len(step["hops"])
    h = x
    for l in range(L):
        k = L - 1 - l
        out = torch.zeros(len(levels[k]), params["head"]["w"].shape[0],
                          dtype=h.dtype, device=h.device)
        for name, b in zip(relations, step["hops"][k], strict=True):
            if len(b["dst"]) == 0:
                continue
            m = _relation(params[f"layer{l}.{name}"], h, levels[k + 1],
                          b["dst"], b["src"], b["mask"], heads)
            out = out.index_add(0, _positions(levels[k], b["dst"], h.device),
                                m)
        h = F.leaky_relu(out, 0.01) if l < L - 1 else out
    seeds = _positions(levels[0], np.asarray(step["seeds"], np.int64),
                       h.device)
    return h[seeds] @ params["head"]["w"] + params["head"]["b"]


def sgd_step(params: dict, x: torch.Tensor, step: dict,
             labels: torch.Tensor, relations: Sequence[str], heads: int,
             lr: float, keep: int | None = None
             ) -> tuple[float, dict, dict]:
    """One step from `params`: (loss before the update, the gradients, zero
    for a leaf the step does not read, the updated parameters).  `keep`
    takes the loss over the first `keep` seeds alone."""
    leaves = {(g, k): v.detach().clone().requires_grad_(True)
              for g, group in params.items() for k, v in group.items()}
    tree: dict = {}
    for (g, k), v in leaves.items():
        tree.setdefault(g, {})[k] = v
    z = logits(tree, x, step, relations, heads)[:keep]
    y = labels[:keep]
    value = (torch.logsumexp(z, dim=-1)
             - z.gather(-1, y.long()[:, None])[:, 0]).mean()
    # the last layer sees the seeds' type alone: relations into other
    # types read none of its leaves there
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves.values(), torch.autograd.grad(
                 value, list(leaves.values()), allow_unused=True))]
    grad_tree: dict = {}
    new: dict = {}
    for ((g, k), v), gr in zip(leaves.items(), grads):
        grad_tree.setdefault(g, {})[k] = gr.detach()
        new.setdefault(g, {})[k] = (v - lr * gr).detach()
    return float(value.detach()), grad_tree, new


def follow(params0: dict, steps: Sequence[dict], table: np.ndarray,
           labels: np.ndarray, relations: Sequence[str], heads: int,
           lr: float, device: torch.device, *, tf32: bool = False,
           keep_seeds: float = 1.0,
           dtype: torch.dtype = torch.float32) -> dict:
    """The plain step over `steps` from `params0`: each step's loss, the
    first step's gradients, the parameters after the first step and after
    the last (`reference/follow.py`'s result).  `tf32` computes the matrix
    products in TF32 (the control), `keep_seeds` < 1 takes each loss over
    that share of the seeds (a planted fault), `dtype` float64 gives a
    witness."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        params = {g: {k: v.to(device, dtype) for k, v in grp.items()}
                  for g, grp in params0.items()}
        losses, first_grads = [], None
        for step in steps:
            x = torch.from_numpy(table[np.asarray(step["levels"][-1],
                                                  np.int64)]).to(device, dtype)
            seeds = np.asarray(step["seeds"], np.int64)
            y = torch.from_numpy(labels[seeds]).to(device)
            keep = None if keep_seeds >= 1.0 else max(
                1, int(len(seeds) * keep_seeds))
            value, grads, params = sgd_step(params, x, step, y, relations,
                                            heads, lr, keep)
            losses.append(value)
            if first_grads is None:
                first_grads, params1 = grads, params
            del x
        return {"losses": losses, "grads": first_grads, "params1": params1,
                "params": params}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class RelationalGraph:
    """The reference's reading of the per-relation CSRs: each relation's
    edges as sorted int64 keys `dst * N + src` over global ids, its
    destinations' degrees, and each node type's id range."""

    def __init__(self, types: dict, relations: Sequence[dict]):
        starts = np.concatenate([[0], np.cumsum(list(types.values()))])
        self.ranges = {t: (int(lo), int(hi)) for t, lo, hi in
                       zip(types, starts[:-1], starts[1:])}
        self.n = int(starts[-1])
        self.dst_type, self.degree, self.keys = [], [], []
        for r in relations:
            lo, _ = self.ranges[r["dst"]]
            deg = np.diff(r["indptr"])
            rows = np.repeat(np.arange(lo, lo + len(deg), dtype=np.int64),
                             deg)
            keys = rows * self.n + r["indices"].astype(np.int64)
            if np.any(keys[1:] <= keys[:-1]):
                keys = np.unique(keys)
            self.dst_type.append(r["dst"])
            self.degree.append(deg)
            self.keys.append(keys)

    def has_edges(self, rel: int, dst: np.ndarray,
                  src: np.ndarray) -> np.ndarray:
        keys = self.keys[rel]
        if len(keys) == 0:
            return np.zeros(dst.shape, bool)
        q = dst.astype(np.int64) * self.n + src.astype(np.int64)
        pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
        return keys[pos] == q


def _mismatch(got: np.ndarray, want: np.ndarray) -> int:
    if got.shape != want.shape:
        return abs(len(got) - len(want)) + 1
    return int((got != want).sum())


def bad_sample_ids(graph: RelationalGraph, pool: np.ndarray, step: dict,
                   fanouts: Sequence[int], batch: int) -> int:
    """Ids of one kept batch that break what the relational sampler
    guarantees: `batch` distinct seeds from `pool`; level 0 their sorted
    union; per hop and relation, destinations exactly the level's nodes of
    the relation's destination type, `fanouts[k]` slots each, every
    unmasked slot an edge of that relation and every masked one at a
    destination with no edge in it; level k + 1 the sorted union of level
    k and the unmasked slots (so the levels are nested and sorted); and
    `all_nodes` the last level."""
    seeds = np.asarray(step["seeds"], np.int64)
    if seeds.shape != (batch,):
        return batch
    bad = batch - len(np.unique(seeds))
    pos = np.minimum(np.searchsorted(pool, seeds), len(pool) - 1)
    bad += int((pool[pos] != seeds).sum())
    levels = [np.asarray(v, np.int64) for v in step["levels"]]
    if len(levels) != len(fanouts) + 1 or len(step["hops"]) != len(fanouts):
        return bad + batch
    bad += _mismatch(levels[0], np.unique(seeds))
    for k, f in enumerate(fanouts):
        level, drawn = levels[k], [levels[k]]
        if len(step["hops"][k]) != len(graph.keys):
            bad += batch
            continue
        for j, b in enumerate(step["hops"][k]):
            lo, hi = graph.ranges[graph.dst_type[j]]
            dst = np.asarray(b["dst"], np.int64)
            want = level[(level >= lo) & (level < hi)]
            if _mismatch(dst, want):
                bad += _mismatch(dst, want)
                continue
            src = np.asarray(b["src"], np.int64)
            mask = np.asarray(b["mask"], bool)
            if src.shape != (len(dst), f) or mask.shape != src.shape:
                bad += len(dst) * f
                continue
            has_edge = (graph.degree[j][dst - lo] > 0)[:, None]
            bad += int((~mask & has_edge).sum())   # masked, yet an edge
            rows = np.broadcast_to(dst[:, None], src.shape)[mask]
            bad += int((~graph.has_edges(j, rows, src[mask])).sum())
            drawn.append(src[mask])
        bad += _mismatch(levels[k + 1], np.unique(np.concatenate(drawn)))
    bad += _mismatch(np.asarray(step["all_nodes"], np.int64), levels[-1])
    return bad
