"""Plain HGT training steps (the Heterogeneous Graph Transformer, Hu, Dong,
Wang and Sun, WWW 2020, arXiv:2003.01332, section 3, Eqs. 1-5) for the
`hgt` family: torch and numpy alone, importing nothing of the measured
package, in float32 with TF32 off.

A kept batch holds global ids, as for R-GAT (`reference/rgat.py`): the
seeds, the levels, and per hop and relation in the configuration's order
the destinations (`dst`, every node of the relation's destination type in
level k), the drawn sources (`src`, -1 where masked) and the `mask`.  Once
`rgat.bad_sample_ids` finds a batch sound, the step reads every row by id
from the benchmark's own feature table, finds each id's type by its id
range, and projects and transforms every slot on its own (no row shared
between the slots that name one node).  For layer l (hop k = L - 1 - l), a
destination t of type tau(t), a slot s of relation r with source u, head
i of width d:

    h_u  = tanh(x_u W_in,tau(u) + b_in,tau(u))   on the last level's rows
    K_s  = h_u W_K,tau(u) + b_K,tau(u),  V_s = h_u W_V,tau(u) + b_V,tau(u)
    Q_t  = h_t W_Q,tau(t) + b_Q,tau(t)
    k'_s = K^i_s W^ATT_r,i,  v'_s = V^i_s W^MSG_r,i
    e_ts = mu_r,i (Q^i_t . k'_s) / sqrt(d)
    alpha_ts = softmax over t's unmasked slots in EVERY relation into
               tau(t) together: the relations' slot grids stacked along
               the slot axis, masked slots at -inf, one softmax
    m_t  = concat_i sum_s alpha_ts v'_s       (0 where t has no slot)
    h'_t = sig(beta_tau(t)) (GELU_erf(m_t) W_A,tau(t) + b_A,tau(t))
           + (1 - sig(beta_tau(t))) h_t
    logits = h_seed W_out + b_out, the loss their mean cross-entropy.

Departures from the paper (the measured package makes the same): no
relative temporal encoding, as IGBH has no timestamps; no LayerNorm, as in
Eq. 5 and PyG's HGTConv; no dropout, and plain SGD, `p -= lr * grad`, in
place of AdamW; neighbours drawn uniformly with replacement at fixed
fanouts in place of HGSampling; the input adaptation is pyHGT's `adapt_ws`
with tanh.

Parameters: `{"adapt.{type}": {"w", "b"}, "layer{l}.{type}": {"w_k",
"b_k", "w_q", "b_q", "w_v", "b_v", "w_a", "b_a", "beta"},
"layer{l}.{relation}": {"w_att", "w_msg", "mu"}, "head": {"w", "b"}}`,
weights as (d_in, d_out), every leaf drawn from the seed (`init_params`):
biases, mu and beta too, so that a type or relation mis-indexed or left
out changes the loss.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

#: a type's leaves in one layer besides `beta`
TYPE_LEAVES = ("w_k", "b_k", "w_q", "b_q", "w_v", "b_v", "w_a", "b_a")


def param_shapes(in_dim: int, hidden: int, heads: int, classes: int,
                 layers: int, types: Sequence[str],
                 relations: Sequence[str]) -> dict:
    """Shape of every leaf; `types` and `relations` are names."""
    d = hidden // heads
    tree: dict = {f"adapt.{t}": {"w": (in_dim, hidden), "b": (hidden,)}
                  for t in types}
    for l in range(layers):
        for t in types:
            tree[f"layer{l}.{t}"] = {
                name: (hidden, hidden) if name.startswith("w") else (hidden,)
                for name in TYPE_LEAVES} | {"beta": (1,)}
        for name in relations:
            tree[f"layer{l}.{name}"] = {"w_att": (heads, d, d),
                                        "w_msg": (heads, d, d),
                                        "mu": (heads,)}
    tree["head"] = {"w": (hidden, classes), "b": (classes,)}
    return tree


def init_params(shapes: dict, generator: torch.Generator,
                device: torch.device) -> dict:
    """Leaves drawn in sorted key order from `generator` (on `device`):
    weights N(0, 1/d_in) (the relation matrices per head over d), biases
    N(0, 0.1^2), mu exp(N(0, 0.5^2)), beta N(0, 1)."""
    out: dict = {}
    for group in sorted(shapes):
        out[group] = {}
        for name in sorted(shapes[group]):
            shape = shapes[group][name]
            x = torch.randn(shape, generator=generator, device=device)
            if name == "mu":
                x = torch.exp(0.5 * x)
            elif name == "beta":
                pass
            elif len(shape) == 1:
                x = 0.1 * x
            else:
                x = x / math.sqrt(shape[-2])
            out[group][name] = x
    return out


def _positions(level: np.ndarray, ids: np.ndarray,
               device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.searchsorted(level, ids)).to(device)


def _type_rows(level: np.ndarray, ranges: dict) -> dict:
    """Each type's positions in `level`, by comparing ids with its range."""
    return {t: np.flatnonzero((level >= lo) & (level < hi))
            for t, (lo, hi) in ranges.items()}


def attend(e: torch.Tensor, valid: torch.Tensor,
           v: torch.Tensor) -> torch.Tensor:
    """The joint attention of n destinations over m relations' grids of f
    slots: scores e (n, m, f, H), the mask (n, m, f), messages v (n, m, f,
    H, d).  One softmax over all m * f slots; (n, H * d)."""
    n, m, f, H = e.shape
    e = e.reshape(n, m * f, H)
    on = valid.reshape(n, m * f, 1)
    e = torch.where(on, e, float("-inf"))
    e = torch.where(on.any(dim=1, keepdim=True), e, 0.0)   # no slot: 0s
    alpha = torch.softmax(e, dim=1) * on
    return (alpha[..., None] * v.reshape(n, m * f, H, -1)).sum(1).reshape(
        n, -1)


def _messages(p: dict, pr: dict, pq: dict, h: torch.Tensor,
              level: np.ndarray, dst: np.ndarray, src: np.ndarray,
              mask: np.ndarray, heads: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One relation's scores (n, f, H) and messages (n, f, H, d), slot by
    slot; `p` the source type's leaves, `pr` the relation's, `pq` the
    destination type's; `h` holds the rows of `level`."""
    n, f = src.shape
    dev = h.device
    d = h.shape[1] // heads
    xs = h[_positions(level, np.where(mask, src, dst[:, None]), dev)]
    ks = (xs @ p["w_k"] + p["b_k"]).reshape(n, f, heads, d)   # every slot
    vs = (xs @ p["w_v"] + p["b_v"]).reshape(n, f, heads, d)
    k2 = torch.einsum("nfhd,hde->nfhe", ks, pr["w_att"])
    v2 = torch.einsum("nfhd,hde->nfhe", vs, pr["w_msg"])
    q = (h[_positions(level, dst, dev)] @ pq["w_q"] + pq["b_q"]).reshape(
        n, 1, heads, d)
    return (q * k2).sum(-1) * pr["mu"] / math.sqrt(d), v2


def logits(params: dict, x: torch.Tensor, step: dict, types: dict,
           relations: Sequence[Sequence[str]], heads: int) -> torch.Tensor:
    """Seed logits from `x`, the feature rows of the last level.  `types`
    maps each node type to its count, in id order; `relations` lists
    (source type, name, destination type)."""
    starts = np.concatenate([[0], np.cumsum(list(types.values()))])
    ranges = {t: (int(lo), int(hi)) for t, lo, hi in
              zip(types, starts[:-1], starts[1:])}
    levels = [np.asarray(v, np.int64) for v in step["levels"]]
    L = len(step["hops"])
    dev = x.device
    h = torch.zeros(len(levels[L]), params["head"]["w"].shape[0],
                    dtype=x.dtype, device=dev)
    for t, rows in _type_rows(levels[L], ranges).items():
        if len(rows):
            p = params[f"adapt.{t}"]
            r = torch.from_numpy(rows).to(dev)
            h = h.index_copy(0, r, torch.tanh(x[r] @ p["w"] + p["b"]))
    for l in range(L):
        k = L - 1 - l
        out = torch.zeros(len(levels[k]), h.shape[1], dtype=h.dtype,
                          device=dev)
        for t, rows in _type_rows(levels[k], ranges).items():
            if len(rows) == 0:
                continue
            pt = params[f"layer{l}.{t}"]
            dst = levels[k][rows]
            into = [(s, name, b) for (s, name, dt), b in
                    zip(relations, step["hops"][k], strict=True) if dt == t]
            if into:
                es, vs, ms = [], [], []
                for s, name, b in into:
                    e, v = _messages(params[f"layer{l}.{s}"],
                                     params[f"layer{l}.{name}"], pt, h,
                                     levels[k + 1], np.asarray(b["dst"]),
                                     np.asarray(b["src"]),
                                     np.asarray(b["mask"]), heads)
                    es.append(e)
                    vs.append(v)
                    ms.append(torch.from_numpy(np.asarray(b["mask"])))
                m = attend(torch.stack(es, 1), torch.stack(ms, 1).to(dev),
                           torch.stack(vs, 1))
            else:
                m = h.new_zeros((len(dst), h.shape[1]))
            h_t = h[_positions(levels[k + 1], dst, dev)]
            gate = torch.sigmoid(pt["beta"])
            new = (gate * (F.gelu(m) @ pt["w_a"] + pt["b_a"])
                   + (1 - gate) * h_t)
            out = out.index_copy(0, torch.from_numpy(rows).to(dev), new)
        h = out
    seeds = _positions(levels[0], np.asarray(step["seeds"], np.int64), dev)
    return h[seeds] @ params["head"]["w"] + params["head"]["b"]


def sgd_step(params: dict, x: torch.Tensor, step: dict,
             labels: torch.Tensor, types: dict,
             relations: Sequence[Sequence[str]], heads: int, lr: float,
             keep: int | None = None) -> tuple[float, dict, dict]:
    """One step from `params`: (loss before the update, the gradients, zero
    for a leaf the step does not read, the updated parameters).  `keep`
    takes the loss over the first `keep` seeds alone."""
    leaves = {(g, k): v.detach().clone().requires_grad_(True)
              for g, group in params.items() for k, v in group.items()}
    tree: dict = {}
    for (g, k), v in leaves.items():
        tree.setdefault(g, {})[k] = v
    z = logits(tree, x, step, types, relations, heads)[:keep]
    y = labels[:keep]
    value = (torch.logsumexp(z, dim=-1)
             - z.gather(-1, y.long()[:, None])[:, 0]).mean()
    # the last layer sees the seeds' type alone: other types' and
    # relations' leaves are not read there
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
           labels: np.ndarray, types: dict,
           relations: Sequence[Sequence[str]], heads: int, lr: float,
           device: torch.device, *, tf32: bool = False,
           keep_seeds: float = 1.0,
           dtype: torch.dtype = torch.float32) -> dict:
    """The plain step over `steps` from `params0`: each step's loss, the
    first step's gradients, the parameters after the first step and after
    the last (`reference/follow.py`'s result).  `tf32` computes the matrix
    products in TF32 (the control), `keep_seeds` < 1 takes each loss over
    that share of the seeds (a planted fault), `dtype` float64 gives a
    witness."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
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
            value, grads, params = sgd_step(params, x, step, y, types,
                                            relations, heads, lr, keep)
            losses.append(value)
            if first_grads is None:
                first_grads, params1 = grads, params
            del x
        return {"losses": losses, "grads": first_grads, "params1": params1,
                "params": params}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
