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

z_v enters only through its score, and per head a_dst^k . (W_r^k x_v) =
x_v . (W_r^k a_dst^k): so each layer folds every relation's W_r into its
a_dst, U_r (d_in, H), and scores all of level k's rows in one product,
h[level_pos] @ [U_r ...], read from h by row (`_dst_scores`).  Each
relation then projects only the rows its slots name, once (`torch.unique`
of their positions), and indexes the projections by slot.  Parameters keep
the reference layout, `{"layer{l}.{relation}": {"w", "attn_src",
"attn_dst", "b"}, "head": {"w", "b"}}`, weights as (d_in, d_out), with
`GNN`'s `param_tree` / `load_reference_params` contract.
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
from repro_torch.kernels.relation_attend import fold_scores, relation_attend
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
    level_pos: list        # level_pos[k]: level k's positions in k + 1


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
                      level_sizes=[len(v) for v in blocks.levels], hops=hops,
                      level_pos=[dev(pos) for pos in blocks.level_pos])


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
        #: per layer of the last forward: the rows each relation projected
        #: ("projected", by name) and the rows the fold scored ("scored")
        self.last_rows: list[dict] = []

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

    def _dst_scores(self, l: int, h: torch.Tensor, pos: torch.Tensor
                    ) -> torch.Tensor:
        """a_dst,r . z_v for the rows `pos` of h, every relation r and
        head: (n, relations, H), through every relation's W_r folded into
        its a_dst,r, all in one product (`kernels.relation_attend`'s
        `fold_scores`)."""
        H = self.cfg.num_heads
        ps = [self.layer[l][name] for name in self.names]
        w = torch.stack([p["w"] for p in ps])
        ut = torch.einsum("rdhc,rhc->rhd", w.view(*w.shape[:2], H, -1),
                          torch.stack([p["attn_dst"] for p in ps]))
        return fold_scores(h, pos, ut.reshape(-1, w.shape[1]).contiguous()
                           ).view(len(pos), len(ps), H)

    def _attend(self, p, h: torch.Tensor, b: RelationTensors,
                s_dst: torch.Tensor) -> tuple[torch.Tensor, int]:
        """m_v,r less its bias for the destinations with an edge, given
        their scores `s_dst` (m, H), and the rows projected: each row of
        `h` that a slot names projected once, and the attention read from
        the projections by slot (`kernels.relation_attend`)."""
        H = self.cfg.num_heads
        ref, inv = torch.unique(b.src, return_inverse=True)
        z = (h[ref] @ p["w"]).reshape(len(ref), H, -1)
        return relation_attend(z, p["attn_src"], s_dst, inv.to(torch.int32),
                               b.mask), len(ref)

    def forward(self, feats: torch.Tensor, blocks: RGATBlocks
                ) -> torch.Tensor:
        """feats: (U, D) rows of the last level, in its order.  Returns
        the seeds' logits."""
        h = feats
        self.last_rows = []
        for l in range(self.L):
            k = self.L - 1 - l
            out = torch.zeros(blocks.level_sizes[k], self.cfg.hidden_dim,
                              dtype=h.dtype, device=h.device)
            s_dst = self._dst_scores(l, h, blocks.level_pos[k])
            rows = {"projected": {}, "scored": len(s_dst)}
            for b in blocks.hops[k]:
                name = self.names[b.relation]
                p = self.layer[l][name]
                out.index_add_(0, b.dst, p["b"].expand(len(b.dst), -1))
                if len(b.rows):
                    msg, rows["projected"][name] = self._attend(
                        p, h, b, s_dst[b.rows, b.relation])
                    out.index_add_(0, b.rows, msg)
            self.last_rows.append(rows)
            h = F.leaky_relu(out, 0.01) if l < self.L - 1 else out
        return h[blocks.seeds] @ self.head["w"] + self.head["b"]
