"""HGT, the Heterogeneous Graph Transformer (Hu, Dong, Wang and Sun, WWW
2020, arXiv:2003.01332, section 3, Eqs. 1-5), on the relational sampler's
deduplicated blocks (`sampling/relational.py`), as R-GAT runs
(`models/rgat.py`).

The loader delivers the feature rows of the last level (`Batch.features`),
and layer l maps level k + 1 onto level k, k = L - 1 - l.  Every level is
a sorted array of global ids and each node type owns one contiguous id
range (`graph/hetero.py`), so a type's rows are one contiguous slice of a
level and a typed product runs on that slice with no gather.  For a
destination t of type tau(t) in level k, its unmasked slots s in every
relation r into tau(t) (source u of type tau(u)), heads i of width d:

    h_u  = tanh(x_u W_in,tau(u) + b_in,tau(u))          input adaptation
    K_u  = h_u W_K,tau(u) + b_K,tau(u)   V_u = h_u W_V,tau(u) + b_V,tau(u)
    Q_t  = h_t W_Q,tau(t) + b_Q,tau(t)
    k'_u,r = K^i_u W^ATT_r,i   v'_u,r = V^i_u W^MSG_r,i   (per head, d x d)
    e_ts = mu_r,i (Q^i_t . k'_u,r) / sqrt(d)
    alpha_ts = softmax over ALL of t's slots, across its relations
    m_t  = concat_i sum_s alpha_ts v'_u,r                (0 without slots)
    h'_t = sig(beta_tau(t)) (GELU(m_t) W_A,tau(t) + b_A,tau(t))
           + (1 - sig(beta_tau(t))) h_t
    logits = h_seed W_out + b_out

GELU in its erf form.  Departures from the paper, in the reference alike:
no relative temporal encoding (IGBH has no timestamps), no LayerNorm (as
Eq. 5 and PyG), no dropout, and the port's uniform draws with replacement
in place of HGSampling.

Each relation projects only its distinct source rows into k' and v', by
one product each, through its source type's W_K and W_V with the
relation's per-head matrices folded in (W_K blockdiag_i(W^ATT_r,i) mu_r,i
/ sqrt(d), and W_V blockdiag_i(W^MSG_r,i)): the same arithmetic as K then
k', in one large product whose weight gradient is one large product too,
where K's own product over the level and a (rows, d) x (d, d) product per
head gave the per-head weight gradient one block a head.  The relations'
rows are stacked, and `hgt_blocks` lists each destination's slots,
relation by relation, as positions into the stack, on the host.  The
joint softmax and the weighted sum run in `kernels.hgt_attend`.
Parameters keep the reference layout, weights as (d_in, d_out):
`{"adapt.{type}": {"w", "b"}, "layer{l}.{type}": {"w_k", "b_k", "w_q",
"b_q", "w_v", "b_v", "w_a", "b_a", "beta"}, "layer{l}.{relation}":
{"w_att", "w_msg", "mu"}, "head": {"w", "b"}}`, with `GNN`'s `param_tree`
/ `load_reference_params` contract.  `bench/reference/hgt.py` is the plain
reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.graph.hetero import HeteroGraph
from repro_torch.kernels.hgt_attend import hgt_attend
from repro_torch.models.common import ParamDef, init_params
# `sgd_step` (p -= lr * grad) is GNN's, through `HGT.loss`
from repro_torch.models.gnn import GNN, sgd_step  # noqa: F401
from repro_torch.models.rgat import IGBH_RELATIONS
from repro_torch.obs import HOT_PATH, NULL_TRACER
from repro_torch.sampling.relational import RelationalBlocks

#: IGBH's node types, in the order of their id ranges
IGBH_TYPES = ("paper", "author", "institute", "fos")
#: a type's weights and biases in one layer, each (d_in, d_out) or (d_out,)
TYPE_LEAVES = ("w_k", "b_k", "w_q", "b_q", "w_v", "b_v", "w_a", "b_a")


@dataclasses.dataclass(frozen=True)
class HGTConfig:
    """The HGT paper's widths (section 4.2: 3 layers, hidden 256, 8 heads
    of 32) on IGBH's 1024-d inputs and 2,983 paper classes, at MLPerf's
    IGBH fanouts (15, 10, 5)."""

    in_dim: int = 1024
    hidden_dim: int = 256
    num_heads: int = 8
    num_classes: int = 2983
    fanouts: Sequence[int] = (15, 10, 5)
    relations: Sequence[tuple[str, str, str]] = IGBH_RELATIONS
    node_types: Sequence[str] = IGBH_TYPES


@dataclasses.dataclass
class HGTHop:
    """One hop's slot layout, on the device.

    indptr: (n_k + 1,) int32 over level k's rows; a destination's slots are
            its unmasked slots of every relation, relation by relation,
            then slot by slot
    idx:    (S,) int32, each slot's row in the relations' stacked k'/v'
    rows:   per relation with a slot, in relation order (the stacking
            order): (relation index, source type index, the distinct
            source rows as positions in the source type's slice of level
            k + 1, int64)
    """

    indptr: torch.Tensor
    idx: torch.Tensor
    rows: list


@dataclasses.dataclass
class HGTBlocks:
    """A batch in the model's form (`hgt_blocks`)."""

    seeds: torch.Tensor    # level-0 positions of the batch's seeds
    bounds: list           # bounds[k]: each type's slice of level k (T + 1)
    level_pos: list        # level_pos[k]: level k's positions in k + 1
    hops: list             # hops[k]: an `HGTHop`


def hgt_blocks(blocks: RelationalBlocks, graph: HeteroGraph,
               device: str | torch.device, tracer=None) -> HGTBlocks:
    """The batch's slot layout, built on the host and copied to `device`:
    per hop and relation the distinct source rows (marked in a level-sized
    array, ranked by its running count), each slot's row in the relations'
    stack, and a CSR over level k listing each destination's slots in
    relation order, then slot order (each relation's slots placed after
    the previous relations' in its destinations' ranges).  `tracer` gets a wall span `hgt_slots` (category
    `HOT_PATH`) and the counters `hgt.slots.<k>`, `hgt.kv_rows.<k>` and
    `hgt.dst_rows.<k>` per hop k."""
    if tracer is None:
        tracer = NULL_TRACER

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    with tracer.stage("hgt_slots", cat=HOT_PATH):
        types = {t: i for i, t in enumerate(graph.node_types)}
        starts = [graph.offsets[t] for t in graph.node_types]
        bounds = [np.searchsorted(level, starts + [graph.num_nodes]).tolist()
                  for level in blocks.levels]
        hops = []
        for k, hop in enumerate(blocks.hops):
            n, n_next = len(blocks.levels[k]), len(blocks.levels[k + 1])
            used = [(b, b.mask.sum(axis=1)) for b in hop if b.mask.any()]
            counts = np.zeros(n, np.int64)
            for b, c in used:
                counts[b.dst] += c
            indptr = np.zeros(n + 1, np.int32)
            np.cumsum(counts, out=indptr[1:])
            # each destination's next free slot: relations fill it in order
            free = indptr[:-1].astype(np.int64)
            idx = np.empty(indptr[-1], np.int32)
            seen = np.zeros(n_next, bool)
            rows, stacked = [], 0
            for b, c in used:
                src = b.src[b.mask]      # row-major: slot order in each row
                seen[:] = False
                seen[src] = True
                rank = np.cumsum(seen) - 1   # a distinct row's place
                first = np.repeat(free[b.dst] - (np.cumsum(c) - c), c)
                idx[first + np.arange(len(src))] = stacked + rank[src]
                free[b.dst] += c
                s = types[graph.relations[b.relation].src_type]
                rows.append((b.relation, s,
                             dev(np.flatnonzero(seen) - bounds[k + 1][s])))
                stacked += int(rank[-1]) + 1
            hops.append(HGTHop(indptr=dev(indptr), idx=dev(idx), rows=rows))
            m = tracer.metrics
            m.counter(f"hgt.slots.{k}").inc(len(idx))
            m.counter(f"hgt.kv_rows.{k}").inc(stacked)
            m.counter(f"hgt.dst_rows.{k}").inc(n)
        seeds = np.searchsorted(blocks.levels[0], blocks.seeds)
        return HGTBlocks(seeds=dev(seeds), bounds=bounds,
                         level_pos=[dev(p) for p in blocks.level_pos],
                         hops=hops)


class HGT(nn.Module):
    def __init__(self, cfg: HGTConfig,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        if cfg.hidden_dim % cfg.num_heads:
            raise ValueError(f"hidden_dim {cfg.hidden_dim} is not a multiple "
                             f"of num_heads {cfg.num_heads}")
        self.cfg = cfg
        self.L = len(cfg.fanouts)
        self.types = tuple(cfg.node_types)
        self.names = [name for _, name, _ in cfg.relations]
        if set(self.types) & set(self.names):
            raise ValueError(f"node types {self.types} and relations "
                             f"{self.names} share a name")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        values = init_params(self.param_defs(), generator)
        dev = resolve_device(device)

        def group(key: str) -> nn.ParameterDict:
            return nn.ParameterDict({k: nn.Parameter(v.to(dev))
                                     for k, v in values[key].items()})
        self.adapt = nn.ModuleDict({t: group(f"adapt.{t}")
                                    for t in self.types})
        self.layer = nn.ModuleList(
            nn.ModuleDict({name: group(f"layer{l}.{name}")
                           for name in (*self.types, *self.names)})
            for l in range(self.L))
        self.head = group("head")
        #: per layer of the last forward: level k's rows ("dst"), the slots
        #: ("slots") and the k'/v' rows each relation projected
        #: ("kv_rows", by name)
        self.last_rows: list[dict] = []

    def param_defs(self) -> dict:
        cfg = self.cfg
        H, d, hid = cfg.num_heads, cfg.hidden_dim // cfg.num_heads, \
            cfg.hidden_dim

        def weight(d_in: int) -> ParamDef:
            return ParamDef((d_in, hid), ("embed", "ffn"), torch.float32,
                            init="lecun")

        def bias() -> ParamDef:
            return ParamDef((hid,), ("ffn",), torch.float32, init="zeros")

        defs: dict = {f"adapt.{t}": {"w": weight(cfg.in_dim), "b": bias()}
                      for t in self.types}
        for l in range(self.L):
            for t in self.types:
                defs[f"layer{l}.{t}"] = {
                    name: weight(hid) if name.startswith("w") else bias()
                    for name in TYPE_LEAVES}
                defs[f"layer{l}.{t}"]["beta"] = ParamDef(
                    (1,), (None,), torch.float32, init="ones")
            for name in self.names:
                defs[f"layer{l}.{name}"] = {
                    "w_att": ParamDef((H, d, d), (None, None, None),
                                      torch.float32, init="lecun"),
                    "w_msg": ParamDef((H, d, d), (None, None, None),
                                      torch.float32, init="lecun"),
                    "mu": ParamDef((H,), (None,), torch.float32,
                                   init="ones"),
                }
        defs["head"] = {
            "w": ParamDef((hid, cfg.num_classes), ("ffn", None),
                          torch.float32, init="lecun"),
            "b": ParamDef((cfg.num_classes,), (None,), torch.float32,
                          init="zeros"),
        }
        return defs

    def _groups(self) -> dict:
        groups = {f"adapt.{t}": self.adapt[t] for t in self.types}
        for l in range(self.L):
            for name, params in self.layer[l].items():
                groups[f"layer{l}.{name}"] = params
        groups["head"] = self.head
        return groups

    # the reference layout's contract and the loss are GNN's, over _groups
    # and forward
    param_tree = GNN.param_tree
    load_reference_params = GNN.load_reference_params
    loss = GNN.loss

    def _typed(self, x: torch.Tensor, bounds: Sequence[int]) -> list:
        """x's slice of each type, in type order, by one `split` (whose
        backward is one concatenation, where a slice's is a zero-filled
        copy of x each)."""
        return list(x.split(np.diff(bounds).tolist()))

    def _folded(self, l: int, hop: HGTHop) -> tuple[torch.Tensor, ...]:
        """Per relation with a slot, its source type's K and V projections
        with the relation's matrices folded in: k' = h (W_K W^ATT mu /
        sqrt(d)) + b_K W^ATT mu / sqrt(d), v' = h (W_V W^MSG) + b_V W^MSG,
        each W^ATT and W^MSG block-diagonal over the heads.  Returns the
        weights (relations, d_in, hidden) and biases (relations, hidden),
        of k' and of v', folded for all the relations at once."""
        cfg, p = self.cfg, self.layer[l]
        H, hid = cfg.num_heads, cfg.hidden_dim
        d = hid // H
        src = [p[self.types[s]] for _, s, _ in hop.rows]
        rel = [p[self.names[r]] for r, _, _ in hop.rows]
        mu = torch.stack([pr["mu"] for pr in rel]) / math.sqrt(d)
        att = torch.stack([pr["w_att"] for pr in rel]) * mu[..., None, None]
        msg = torch.stack([pr["w_msg"] for pr in rel])
        out = []
        for w, b, m in (("w_k", "b_k", att), ("w_v", "b_v", msg)):
            ws = torch.stack([ps[w] for ps in src]).view(len(src), -1, H, d)
            bs = torch.stack([ps[b] for ps in src]).view(len(src), H, d)
            out.append(torch.einsum("rihd,rhde->rihe", ws, m).flatten(2))
            out.append(torch.einsum("rhd,rhde->rhe", bs, m).flatten(1))
        return tuple(out)

    def _layer(self, l: int, h: torch.Tensor, hop: HGTHop,
               bounds: Sequence[int], next_bounds: Sequence[int],
               pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Level k's rows from `h`, level k + 1's, and the rows counted."""
        cfg, p = self.cfg, self.layer[l]
        H = cfg.num_heads
        d = cfg.hidden_dim // H
        # each relation's distinct source rows, projected into k' and v'
        # at once through the folded weights
        kp, vp, counted = [], [], {}
        if hop.rows:
            wk, bk, wv, bv = self._folded(l, hop)
            hs = self._typed(h, next_bounds)
            for j, (r, s, rows) in enumerate(hop.rows):
                x = hs[s][rows]
                kp.append(torch.addmm(bk[j], x, wk[j]))
                vp.append(torch.addmm(bv[j], x, wv[j]))
                counted[self.names[r]] = len(rows)
        hk = self._typed(h[pos], bounds)                 # level k's own rows
        types = [(i, t) for i, t in enumerate(self.types) if len(hk[i])]
        q = torch.cat([torch.addmm(p[t]["b_q"], hk[i], p[t]["w_q"])
                       for i, t in types])
        empty = q.new_zeros((0, cfg.hidden_dim))
        m = hgt_attend(q.view(-1, H, d),
                       (torch.cat(kp) if kp else empty).view(-1, H, d),
                       (torch.cat(vp) if vp else empty).view(-1, H, d),
                       hop.indptr, hop.idx)
        m = self._typed(F.gelu(m), bounds)
        out = []
        for i, t in types:
            gate = torch.sigmoid(p[t]["beta"])
            out.append(gate * torch.addmm(p[t]["b_a"], m[i], p[t]["w_a"])
                       + (1 - gate) * hk[i])
        return torch.cat(out), {"dst": len(pos), "slots": len(hop.idx),
                                "kv_rows": counted}

    def forward(self, feats: torch.Tensor, blocks: HGTBlocks) -> torch.Tensor:
        """feats: (U, D) rows of the last level, in its order.  Returns
        the seeds' logits."""
        h = torch.cat([torch.tanh(torch.addmm(self.adapt[t]["b"], x,
                                              self.adapt[t]["w"]))
                       for t, x in zip(self.types, self._typed(
                           feats, blocks.bounds[self.L])) if len(x)])
        self.last_rows = []
        for l in range(self.L):
            k = self.L - 1 - l
            h, rows = self._layer(l, h, blocks.hops[k], blocks.bounds[k],
                                  blocks.bounds[k + 1], blocks.level_pos[k])
            self.last_rows.append(rows)
        return h[blocks.seeds] @ self.head["w"] + self.head["b"]
