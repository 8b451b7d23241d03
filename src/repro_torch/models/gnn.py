"""GNN models (the paper's training domain): GraphSAGE, GCN and GAT as one
`nn.Module`, the port's counterpart of `repro.models.gnn`.

Models run on fixed-fanout sampled blocks: the loader delivers a
deduplicated feature table `feats` (U, D) for the union of sampled nodes
plus per-hop row indices into it.  The first layer aggregates straight
from the table through the `segment_mean` kernel; outer layers
reshape-mean already-transformed activations.  Parameters keep the
reference's (d_in, d_out) layout and names (`layer{l}.w_self`, ...,
`head.w`), so a reference parameter tree loads without transposes.

Layer semantics (GraphSAGE-mean):
    h_dst' = act(W_self h_dst + W_nbr mean_{n in N(dst)} h_n)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.gat_attend import gat_attend
from repro_torch.models.common import ParamDef, init_params
from repro_torch.sampling.neighbor import SampledBlocks


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    model: str = "sage"              # sage | gcn | gat
    in_dim: int = 1024
    hidden_dim: int = 128            # paper §4.1: hidden 128
    num_classes: int = 47
    fanouts: Sequence[int] = (10, 5, 5)
    num_heads: int = 4               # gat


def hop_indices(blocks: SampledBlocks) -> list[np.ndarray]:
    """Map seeds + each hop's node ids to rows of blocks.all_nodes
    (all_nodes is sorted-unique, so searchsorted is exact)."""
    table = blocks.all_nodes
    out = [np.searchsorted(table, blocks.seeds.astype(np.int64))]
    for h in blocks.hop_nodes:
        out.append(np.searchsorted(table, h))
    return [o.astype(np.int32) for o in out]


class SegmentMean(torch.autograd.Function):
    """Layer-0 neighbor mean through `ops.segment_mean`.  Features are
    inputs and the reference never differentiates through them, so the
    backward gives no gradient for `idx` and refuses one for `feats`."""

    @staticmethod
    def forward(ctx, idx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        return ops.segment_mean(idx, feats)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        if ctx.needs_input_grad[1]:
            raise RuntimeError(
                "segment_mean has no gradient with respect to the feature "
                "table; pass features that do not require grad")
        return None, None


class GNN(nn.Module):
    def __init__(self, cfg: GNNConfig, generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.cfg = cfg
        self.L = len(cfg.fanouts)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        values = init_params(self.param_defs(), generator)
        dev = resolve_device(device)
        self.layer = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(v.to(dev))
                              for k, v in values[f"layer{l}"].items()})
            for l in range(self.L))
        self.head = nn.ParameterDict(
            {k: nn.Parameter(v.to(dev)) for k, v in values["head"].items()})

    def param_defs(self) -> dict:
        cfg = self.cfg
        dims = [cfg.in_dim] + [cfg.hidden_dim] * self.L
        defs: dict = {}
        for l in range(self.L):
            d_in, d_out = dims[l], dims[l + 1]
            layer = {
                "w_self": ParamDef((d_in, d_out), ("embed", "ffn"),
                                   torch.float32, init="lecun"),
                "w_nbr": ParamDef((d_in, d_out), ("embed", "ffn"),
                                  torch.float32, init="lecun"),
                "b": ParamDef((d_out,), ("ffn",), torch.float32, init="zeros"),
            }
            if cfg.model == "gat":
                for k in ("attn_src", "attn_dst"):
                    layer[k] = ParamDef((cfg.num_heads,
                                         d_out // cfg.num_heads),
                                        (None, None), torch.float32,
                                        init="normal")
            defs[f"layer{l}"] = layer
        defs["head"] = {
            "w": ParamDef((cfg.hidden_dim, cfg.num_classes),
                          ("ffn", None), torch.float32, init="lecun"),
            "b": ParamDef((cfg.num_classes,), (None,), torch.float32,
                          init="zeros"),
        }
        return defs

    def _groups(self) -> dict:
        groups = {f"layer{l}": self.layer[l] for l in range(self.L)}
        groups["head"] = self.head
        return groups

    def param_tree(self) -> dict:
        """The parameters in the reference's layout, `{"layer0": {"w_self":
        ..., "w_nbr": ..., "b": ...}, ..., "head": {"w": ..., "b": ...}}`,
        as detached tensors that share the module's storage: the inverse of
        `load_reference_params`, and the tree `train.checkpoint.save`
        writes in the reference's format."""
        return {g: {k: p.detach() for k, p in params.items()}
                for g, params in self._groups().items()}

    @torch.no_grad()
    def load_reference_params(self, tree: dict) -> None:
        """Copy a parameter tree in the reference's layout (nested dicts of
        arrays: `repro.models.gnn.GNN.init` converted with np.asarray, or
        tensors on any device, as `param_tree` or `train.checkpoint.restore`
        give) into this module.  Layouts match, so nothing is
        transposed."""
        targets = self._groups()
        if set(tree) != set(targets):
            raise ValueError(f"parameter tree has groups {sorted(tree)}, "
                             f"model has {sorted(targets)}")
        for group, params in targets.items():
            if set(tree[group]) != set(params):
                raise ValueError(f"{group}: tree has {sorted(tree[group])}, "
                                 f"model has {sorted(params)}")
            for k, p in params.items():
                v = tree[group][k]
                if not isinstance(v, torch.Tensor):
                    v = torch.as_tensor(np.asarray(v))
                if tuple(v.shape) != tuple(p.shape):
                    raise ValueError(f"{group}.{k}: shape {tuple(v.shape)} "
                                     f"!= {tuple(p.shape)}")
                p.copy_(v.to(p.dtype))

    def _aggregate(self, x_nbr: torch.Tensor, fanout: int) -> torch.Tensor:
        n = x_nbr.shape[0] // fanout
        return x_nbr.reshape(n, fanout, -1).mean(dim=1)

    def _layer(self, p, x_dst, x_nbr_mean, x_nbr=None, fanout=None):
        cfg = self.cfg
        if cfg.model == "gcn":
            deg = 1 + (fanout or 1)
            h = (x_dst + x_nbr_mean * (fanout or 1)) / deg
            return F.relu(h @ p["w_self"] + p["b"])
        if cfg.model == "gat" and x_nbr is not None:
            H = cfg.num_heads
            n, f = x_dst.shape[0], fanout
            hd = p["w_nbr"].shape[1] // H
            zd = (x_dst @ p["w_self"]).reshape(n, H, hd)
            zn = (x_nbr @ p["w_nbr"]).reshape(n, f, H, hd)
            agg = gat_attend(zd, zn, p["attn_src"], p["attn_dst"])
            return F.elu(agg + p["b"])
        return F.relu(x_dst @ p["w_self"] + x_nbr_mean @ p["w_nbr"] + p["b"])

    def forward(self, feats: torch.Tensor,
                hop_idx: list[torch.Tensor]) -> torch.Tensor:
        """feats: (U, D) deduplicated gathered features; hop_idx: per-hop
        int32 row indices (len L+1, hop 0 = seeds).  Returns seed logits.

        After layer t the activations cover hop levels 0..L-t; layer t
        consumes level lvl+1 into level lvl.  Layer 0 aggregates straight
        from the feature table through `segment_mean`."""
        fanouts = list(self.cfg.fanouts)
        L = self.L
        # the outermost level feeds layer 0 only through segment_mean, so
        # only GAT, which also attends over the raw neighbour rows, needs
        # it materialised
        levels = L + 1 if self.cfg.model == "gat" else L
        h = [feats[hop_idx[lvl].long()] for lvl in range(levels)]
        for t in range(L):
            p = self.layer[t]
            new_h = []
            for lvl in range(L - t):
                f = fanouts[lvl]
                if t == 0:
                    idx = hop_idx[lvl + 1].reshape(-1, f)
                    nbr_mean = SegmentMean.apply(idx, feats)
                else:
                    nbr_mean = self._aggregate(h[lvl + 1], f)
                x_nbr = h[lvl + 1] if self.cfg.model == "gat" else None
                new_h.append(self._layer(p, h[lvl], nbr_mean,
                                         x_nbr=x_nbr, fanout=f))
            h = new_h
        return h[0] @ self.head["w"] + self.head["b"]

    def loss(self, feats: torch.Tensor, hop_idx: list[torch.Tensor],
             labels: torch.Tensor) -> torch.Tensor:
        logits = self.forward(feats, hop_idx)
        lse = torch.logsumexp(logits, dim=-1)
        lab = logits.gather(-1, labels.long()[:, None])[:, 0]
        return (lse - lab).mean()


def sgd_step(model: GNN, feats: torch.Tensor, hop_idx: list[torch.Tensor],
             labels: torch.Tensor, lr: float) -> torch.Tensor:
    """One plain SGD step, `p -= lr * grad` for every parameter (the step of
    examples/train_gnn_igb.py).  Returns the loss before the update.  A
    parameter the loss does not read (GCN's `w_nbr`) has no gradient and
    stays put, as under the reference's zero gradient."""
    loss = model.loss(feats, hop_idx, labels)
    model.zero_grad(set_to_none=True)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p -= lr * p.grad
    return loss.detach()
