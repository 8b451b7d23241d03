"""Plain R-GAT: the forward pass, loss and gradients of `models/rgat.py`
in float32 with nothing but torch operations (no kernel, no module of the
port), computed slot by slot: every sampled slot's row is projected on its
own, with no projection shared between slots that name the same node.

Set `torch.backends.cuda.matmul.allow_tf32 = False` (and cuDNN's) before
calling on a GPU; `sgd_step` does so for its own step.

The blocks are read by duck typing, as `sampling/relational.py` builds
them: `levels` (sorted unique global ids, levels[k] within levels[k + 1]),
`level_pos[k]` (levels[k]'s positions in levels[k + 1]), `seeds`, and
`hops[k]`, one block per relation with `relation`, `dst` (level-k
positions), `src` (level-(k + 1) positions, one row of slots per
destination) and `mask`.  For layer l (hop k = L - 1 - l), relation r, a
destination v and head k of H:

    z_u = W_r x_u,  z_v = W_r x_v,
    e_vu = LeakyReLU_0.2(a_src . z_u + a_dst . z_v),
    alpha_vu = softmax over v's unmasked slots (none where it has no edge),
    m_v,r = concat_k sum_u alpha_vu z_u + b_r,
    x_v' = LeakyReLU_0.01(sum_r m_v,r) (none after the last layer),
    logits = x_seed W_out + b_out, the loss their mean cross-entropy.

Departures from MLPerf's R-GAT on IGBH, which the program shares:
- neighbours are drawn uniformly with replacement (the port's sampling
  convention), not without;
- dropout (0.2 in MLPerf) is left out, so that program and reference agree
  on a step;
- plain SGD, `p -= lr * grad`, in place of Adam.

Parameters: `{"layer{l}.{relation}": {"w", "attn_src", "attn_dst", "b"},
"head": {"w", "b"}}`, weights as (d_in, d_out).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


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


def init_params(shapes: dict, generator: torch.Generator,
                device: torch.device) -> dict:
    """Weights N(0, 1/d_in), attention vectors N(0, 1/head_dim), biases
    zero; leaves drawn in sorted key order from `generator`."""
    out: dict = {}
    for group in sorted(shapes):
        out[group] = {}
        for name in sorted(shapes[group]):
            shape = shapes[group][name]
            if name == "b":
                out[group][name] = torch.zeros(shape, device=device)
                continue
            x = torch.randn(shape, generator=generator, device=device)
            out[group][name] = x / math.sqrt(
                shape[-1] if name.startswith("attn") else shape[0])
    return out


def _relation(p: dict, h: torch.Tensor, nxt: np.ndarray, src: np.ndarray,
              mask: np.ndarray, heads: int) -> torch.Tensor:
    """m_v,r of every destination, slot by slot."""
    n, f = src.shape
    dev = h.device
    xs = h[torch.from_numpy(src).to(dev)]                      # (n, f, d)
    zs = (xs @ p["w"]).reshape(n, f, heads, -1)
    zd = (h[torch.from_numpy(nxt).to(dev)] @ p["w"]).reshape(n, heads, -1)
    e = F.leaky_relu((zs * p["attn_src"]).sum(-1)
                     + (zd * p["attn_dst"]).sum(-1)[:, None], 0.2)
    valid = torch.from_numpy(mask).to(dev)[..., None]          # (n, f, 1)
    e = torch.where(valid, e, float("-inf"))
    e = torch.where(valid.any(dim=1, keepdim=True), e, 0.0)   # no edge: 0s
    alpha = torch.softmax(e, dim=1) * valid
    return (alpha[..., None] * zs).sum(dim=1).reshape(n, -1) + p["b"]


def logits(params: dict, x: torch.Tensor, blocks, relations: Sequence[str],
           heads: int) -> torch.Tensor:
    """Seed logits from `x`, the feature rows of the last level."""
    L = len(blocks.hops)
    h = x
    for l in range(L):
        k = L - 1 - l
        out = torch.zeros(len(blocks.levels[k]), params["head"]["w"].shape[0],
                          dtype=h.dtype, device=h.device)
        for b in blocks.hops[k]:
            if len(b.dst) == 0:
                continue
            m = _relation(params[f"layer{l}.{relations[b.relation]}"], h,
                          blocks.level_pos[k][b.dst], b.src, b.mask, heads)
            out = out.index_add(0, torch.from_numpy(b.dst).to(h.device), m)
        h = F.leaky_relu(out, 0.01) if l < L - 1 else out
    seeds = np.searchsorted(blocks.levels[0], blocks.seeds)
    return h[torch.from_numpy(seeds).to(h.device)] @ params["head"]["w"] \
        + params["head"]["b"]


def loss(params: dict, x: torch.Tensor, blocks, labels: torch.Tensor,
         relations: Sequence[str], heads: int) -> torch.Tensor:
    """Mean cross-entropy of the seeds' logits against their labels."""
    z = logits(params, x, blocks, relations, heads)
    return (torch.logsumexp(z, dim=-1)
            - z.gather(-1, labels.long()[:, None])[:, 0]).mean()


def sgd_step(params: dict, x: torch.Tensor, blocks, labels: torch.Tensor,
             relations: Sequence[str], heads: int, lr: float
             ) -> tuple[float, dict, dict]:
    """One step from `params`, TF32 off: (loss before the update, the
    gradients, zero for a leaf the step does not read, the updated
    parameters).  `params` is left as it was."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        leaves = {(g, k): v.detach().clone().requires_grad_(True)
                  for g, group in params.items() for k, v in group.items()}
        tree: dict = {}
        for (g, k), v in leaves.items():
            tree.setdefault(g, {})[k] = v
        value = loss(tree, x, blocks, labels, relations, heads)
        # a relation into a type the hop's level lacks (the last layer
        # sees the seeds' type alone) reads none of its leaves
        grads = [torch.zeros_like(v) if g is None else g
                 for v, g in zip(leaves.values(), torch.autograd.grad(
                     value, list(leaves.values()), allow_unused=True))]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    grad_tree: dict = {}
    new: dict = {}
    for ((g, k), v), gr in zip(leaves.items(), grads):
        grad_tree.setdefault(g, {})[k] = gr.detach()
        new.setdefault(g, {})[k] = (v - lr * gr).detach()
    return float(value.detach()), grad_tree, new
