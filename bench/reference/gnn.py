"""Plain GraphSAGE-mean and GAT training steps, in float32.

These are the layer equations the measured package states, written again
with nothing but torch operations: no kernel, no cache, no data plane.
A step takes the raw feature rows of every hop level (level 0 the seeds,
level l + 1 the fanouts[l] sampled neighbours of each row of level l), runs
the layers from the outermost level in, takes the mean cross-entropy of the
seeds' logits, and applies plain SGD, `p -= lr * grad`.

    GraphSAGE-mean: h' = relu(h W_self + mean(h_nbr) W_nbr + b)
    GAT (per head k, neighbours j of a destination i):
        z_i = h_i W_self,  z_j = h_j W_nbr,
        e_ij = leaky_relu(<z_i, a_src> + <z_j, a_dst>, 0.2),
        h_i' = elu(sum_j softmax_j(e_ij) z_j + b)

GAT departs from its published form (arXiv:1710.10903) as the measured
package does: separate weights for the destination and its neighbours,
attention over the sampled neighbours only (no self edge), and the heads
concatenated in every layer.

Parameters are nested dicts in the measured package's layout:
`{"layer{l}": {"w_self", "w_nbr", "b"[, "attn_src", "attn_dst"]},
"head": {"w", "b"}}`, weights as (d_in, d_out).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def param_shapes(model: str, in_dim: int, hidden: int, classes: int,
                 layers: int, heads: int) -> dict:
    """Shape of every leaf, in the measured package's layout."""
    dims = [in_dim] + [hidden] * layers
    tree: dict = {}
    for l in range(layers):
        leaf = {"w_self": (dims[l], dims[l + 1]),
                "w_nbr": (dims[l], dims[l + 1]), "b": (dims[l + 1],)}
        if model == "gat":
            leaf["attn_src"] = (heads, dims[l + 1] // heads)
            leaf["attn_dst"] = (heads, dims[l + 1] // heads)
        tree[f"layer{l}"] = leaf
    tree["head"] = {"w": (hidden, classes), "b": (classes,)}
    return tree


def init_params(shapes: dict, generator: torch.Generator,
                device: torch.device) -> dict:
    """Weights N(0, 1/d_in), attention vectors N(0, 1/head_dim), biases
    zero; leaves drawn in sorted key order from `generator` (on
    `device`)."""
    out: dict = {}
    for group in sorted(shapes):
        out[group] = {}
        for name in sorted(shapes[group]):
            shape = shapes[group][name]
            if name == "b":
                out[group][name] = torch.zeros(shape, device=device)
                continue
            x = torch.randn(shape, generator=generator, device=device)
            out[group][name] = x / math.sqrt(shape[-1] if name.startswith(
                "attn") else shape[0])
    return out


def _layer(model: str, p: dict, x_dst: torch.Tensor, x_nbr: torch.Tensor,
           fanout: int, heads: int) -> torch.Tensor:
    n = x_dst.shape[0]
    if model == "sage":
        mean = x_nbr.reshape(n, fanout, -1).mean(dim=1)
        return F.relu(x_dst @ p["w_self"] + mean @ p["w_nbr"] + p["b"])
    hd = p["w_nbr"].shape[1] // heads
    z_dst = (x_dst @ p["w_self"]).reshape(n, heads, hd)
    z_nbr = (x_nbr @ p["w_nbr"]).reshape(n, fanout, heads, hd)
    score = F.leaky_relu((z_dst * p["attn_src"]).sum(-1)[:, None, :]
                         + (z_nbr * p["attn_dst"]).sum(-1), 0.2)
    alpha = torch.softmax(score, dim=1)                  # over neighbours
    out = (alpha[..., None] * z_nbr).sum(dim=1).reshape(n, heads * hd)
    return F.elu(out + p["b"])


def logits(model: str, params: dict, levels: Sequence[torch.Tensor],
           fanouts: Sequence[int], heads: int) -> torch.Tensor:
    """Seed logits from the feature rows of every hop level."""
    L = len(fanouts)
    h = list(levels)
    for t in range(L):
        p = params[f"layer{t}"]
        h = [_layer(model, p, h[lvl], h[lvl + 1], fanouts[lvl], heads)
             for lvl in range(L - t)]
    return h[0] @ params["head"]["w"] + params["head"]["b"]


def loss(model: str, params: dict, levels: Sequence[torch.Tensor],
         labels: torch.Tensor, fanouts: Sequence[int],
         heads: int) -> torch.Tensor:
    """Mean cross-entropy of the seeds' logits against their labels."""
    z = logits(model, params, levels, fanouts, heads)
    return (torch.logsumexp(z, dim=-1)
            - z.gather(-1, labels.long()[:, None])[:, 0]).mean()


def sgd_step(model: str, params: dict, levels: Sequence[torch.Tensor],
             labels: torch.Tensor, fanouts: Sequence[int], heads: int,
             lr: float) -> tuple[float, dict, dict]:
    """One step from `params`: (loss before the update, the gradients, the
    updated parameters).  `params` is left as it was."""
    leaves = {(g, k): v.detach().clone().requires_grad_(True)
              for g, group in params.items() for k, v in group.items()}
    tree: dict = {}
    for (g, k), v in leaves.items():
        tree.setdefault(g, {})[k] = v
    value = loss(model, tree, levels, labels, fanouts, heads)
    grads = torch.autograd.grad(value, list(leaves.values()))
    grad_tree: dict = {}
    new: dict = {}
    for ((g, k), v), gr in zip(leaves.items(), grads):
        grad_tree.setdefault(g, {})[k] = gr.detach()
        new.setdefault(g, {})[k] = (v - lr * gr).detach()
    return float(value.detach()), grad_tree, new
