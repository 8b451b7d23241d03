"""R-GAT, the relational graph attention network (arXiv:1904.05811) in the
form of the MLCommons MLPerf Training GNN benchmark on IGBH: GATConv with
no self-loops on each relation's bipartite block, summed over the
relations into a node type (a hetero-conv's default sum).

It runs on the relational sampler's deduplicated blocks
(`sampling/relational.py`): the loader delivers the feature rows of the
last level (`Batch.features`, one row per node), and each layer maps level
k + 1 onto level k.  For layer l, relation r from type s to type t, a
destination v of type t and head k (H heads of C = hidden / H):

    z_u = W_r x_u,   z_v = W_r x_v          (one W_r per relation and layer)
    e_vu^k = LeakyReLU_0.2(a_src,r^k . z_u^k + a_dst,r^k . z_v^k)
    alpha_vu^k = softmax over v's sampled slots in r (masked slots left out)
    m_v,r = concat_k sum_u alpha_vu^k z_u^k + b_r  (b_r where v has no r-edge)
    x_v' = LeakyReLU_0.01(sum over relations into t of m_v,r)
                                        (no activation after the last layer)
    logits = x_seed W_out + b_out

Each relation projects the rows its slots and destinations name once
(`torch.unique` of their positions) and indexes the projections by slot.
Parameters keep the reference layout, `{"layer{l}.{relation}": {"w",
"attn_src", "attn_dst", "b"}, "head": {"w", "b"}}`, weights as (d_in,
d_out), with `GNN`'s `param_tree` / `load_reference_params` contract.
`models/rgat_ref.py` is the plain reference.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.models.common import ParamDef, init_params
# `sgd_step` (p -= lr * grad) is GNN's, through `RGAT.loss`
from repro_torch.models.gnn import GNN, sgd_step  # noqa: F401
from repro_torch.sampling.relational import RelationalBlocks

#: IGBH's relations as MLPerf's loader builds them: (source type, name,
#: destination type), each forward relation with its reverse
IGBH_RELATIONS = (
    ("paper", "cites", "paper"),
    ("paper", "written_by", "author"),
    ("author", "rev_written_by", "paper"),
    ("paper", "topic", "fos"),
    ("fos", "rev_topic", "paper"),
    ("author", "affiliated_to", "institute"),
    ("institute", "rev_affiliated_to", "author"),
)


@dataclasses.dataclass(frozen=True)
class RGATConfig:
    """MLPerf's R-GAT on IGBH by default: 3 layers, hidden 512 in 4 heads
    of 128, fanouts (15, 10, 5), 1024-d inputs, 2,983 paper classes."""

    in_dim: int = 1024
    hidden_dim: int = 512
    num_heads: int = 4
    num_classes: int = 2983
    fanouts: Sequence[int] = (15, 10, 5)
    relations: Sequence[tuple[str, str, str]] = IGBH_RELATIONS


@dataclasses.dataclass
class RelationTensors:
    """One relation's block at one hop, on the device."""

    relation: int
    dst: torch.Tensor      # (n,) level-k positions of every destination
    rows: torch.Tensor     # (m,) level-k positions of those with an edge
    nxt: torch.Tensor      # (m,) their level-(k + 1) positions
    src: torch.Tensor      # (m, f) level-(k + 1) positions of the slots
    mask: torch.Tensor     # (m, f) bool


@dataclasses.dataclass
class RGATBlocks:
    """A batch's blocks in the model's form (`block_tensors`)."""

    seeds: torch.Tensor    # level-0 positions of the batch's seeds
    level_sizes: list
    hops: list             # hops[k]: a `RelationTensors` per relation


def block_tensors(blocks: RelationalBlocks,
                  device: str | torch.device) -> RGATBlocks:
    """Copy a batch's positions to `device`, keeping for the attention only
    the destinations with at least one unmasked slot (the rest get their
    relation's bias alone)."""
    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    hops = []
    for k, hop in enumerate(blocks.hops):
        out = []
        for b in hop:
            keep = b.mask.any(axis=1)
            rows = b.dst[keep]
            out.append(RelationTensors(
                relation=b.relation, dst=dev(b.dst), rows=dev(rows),
                nxt=dev(blocks.level_pos[k][rows]), src=dev(b.src[keep]),
                mask=dev(b.mask[keep])))
        hops.append(out)
    seeds = np.searchsorted(blocks.levels[0], blocks.seeds)
    return RGATBlocks(seeds=dev(seeds),
                      level_sizes=[len(v) for v in blocks.levels], hops=hops)


class RGAT(nn.Module):
    def __init__(self, cfg: RGATConfig,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        if cfg.hidden_dim % cfg.num_heads:
            raise ValueError(f"hidden_dim {cfg.hidden_dim} is not a multiple "
                             f"of num_heads {cfg.num_heads}")
        self.cfg = cfg
        self.L = len(cfg.fanouts)
        self.names = [name for _, name, _ in cfg.relations]
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        values = init_params(self.param_defs(), generator)
        dev = resolve_device(device)
        self.layer = nn.ModuleList(
            nn.ModuleDict({
                name: nn.ParameterDict(
                    {k: nn.Parameter(v.to(dev))
                     for k, v in values[f"layer{l}.{name}"].items()})
                for name in self.names})
            for l in range(self.L))
        self.head = nn.ParameterDict(
            {k: nn.Parameter(v.to(dev)) for k, v in values["head"].items()})

    def param_defs(self) -> dict:
        cfg = self.cfg
        dims = [cfg.in_dim] + [cfg.hidden_dim] * self.L
        head_dim = cfg.hidden_dim // cfg.num_heads
        defs: dict = {}
        for l in range(self.L):
            for name in self.names:
                defs[f"layer{l}.{name}"] = {
                    "w": ParamDef((dims[l], cfg.hidden_dim), ("embed", "ffn"),
                                  torch.float32, init="lecun"),
                    "attn_src": ParamDef((cfg.num_heads, head_dim),
                                         (None, None), torch.float32),
                    "attn_dst": ParamDef((cfg.num_heads, head_dim),
                                         (None, None), torch.float32),
                    "b": ParamDef((cfg.hidden_dim,), ("ffn",), torch.float32,
                                  init="zeros"),
                }
        defs["head"] = {
            "w": ParamDef((cfg.hidden_dim, cfg.num_classes), ("ffn", None),
                          torch.float32, init="lecun"),
            "b": ParamDef((cfg.num_classes,), (None,), torch.float32,
                          init="zeros"),
        }
        return defs

    def _groups(self) -> dict:
        groups = {f"layer{l}.{name}": self.layer[l][name]
                  for l in range(self.L) for name in self.names}
        groups["head"] = self.head
        return groups

    # the reference layout's contract and the loss are GNN's, over _groups
    # and forward
    param_tree = GNN.param_tree
    load_reference_params = GNN.load_reference_params
    loss = GNN.loss

    def _attend(self, p, h: torch.Tensor, b: RelationTensors
                ) -> torch.Tensor:
        """m_v,r less its bias for the destinations with an edge: each
        referenced row of `h` projected once, scores and rows indexed by
        slot."""
        H = self.cfg.num_heads
        m, f = b.src.shape
        ref, inv = torch.unique(torch.cat([b.src.reshape(-1), b.nxt]),
                                return_inverse=True)
        z = (h[ref] @ p["w"]).reshape(len(ref), H, -1)
        score_src = (z * p["attn_src"]).sum(-1)                # (R, H)
        score_dst = (z * p["attn_dst"]).sum(-1)
        i_src, i_dst = inv[:m * f].reshape(m, f), inv[m * f:]
        e = F.leaky_relu(score_src[i_src] + score_dst[i_dst][:, None], 0.2)
        e = e.masked_fill(~b.mask[..., None], float("-inf"))
        alpha = torch.softmax(e, dim=1)                        # (m, f, H)
        return torch.einsum("mfh,mfhc->mhc", alpha, z[i_src]).reshape(m, -1)

    def forward(self, feats: torch.Tensor, blocks: RGATBlocks
                ) -> torch.Tensor:
        """feats: (U, D) rows of the last level, in its order.  Returns
        the seeds' logits."""
        h = feats
        for l in range(self.L):
            k = self.L - 1 - l
            out = torch.zeros(blocks.level_sizes[k], self.cfg.hidden_dim,
                              dtype=h.dtype, device=h.device)
            for b in blocks.hops[k]:
                p = self.layer[l][self.names[b.relation]]
                out.index_add_(0, b.dst, p["b"].expand(len(b.dst), -1))
                if len(b.rows):
                    out.index_add_(0, b.rows, self._attend(p, h, b))
            h = F.leaky_relu(out, 0.01) if l < self.L - 1 else out
        return h[blocks.seeds] @ self.head["w"] + self.head["b"]
