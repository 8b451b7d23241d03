"""The `rgat` family: R-GAT (MLPerf Training's GNN model) on IGBH's typed
nodes, trained through `repro_torch`'s `GIDSDataLoader` with the relational
sampler: per-relation fixed-fanout draws into deduplicated blocks, one
1024-d feature table over every node type.  What a family module provides
is listed in `families/gnn.py`'s docstring.

The configuration names its node types and their counts (`nodes`), each
forward relation's edge count (`edges`) and every relation as (source
type, name, destination type) (`relations`); a relation named `rev_<x>`
holds the edges of `<x>` reversed.  Each forward relation is an RMAT over
(source, destination) drawn on the card with the configuration's (a, b,
c), one generator seeded with `graph.seed` drawing the relations in order:
the port's quadrant rule, `scale = ceil(log2(max(n_s, n_t)))` bits per
endpoint, each end wrapped modulo its type's count, self-loops dropped
within one type, duplicates removed, exactly the configured count kept.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bench import inputs, judge, yardstick
from bench.reference import rgat as ref
from repro_torch import core as program_core
from repro_torch.graph.hetero import HeteroGraph, Relation
from repro_torch.models.rgat import RGAT, RGATConfig, block_tensors, sgd_step
from repro_torch.obs import Tracer

kernel_sources = ("tiered_gather", "cache_access")

#: the program's spans that `--trace 1` runs copy into the run's spans
PROGRAM_SPANS = ("sample_relations", "build_blocks")


def relation_names(config: dict) -> list[str]:
    return [name for _, name, _ in config["relations"]]


def rmat_pairs(n_src: int, n_dst: int, num_edges: int, same_type: bool, *,
               a: float, b: float, c: float, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """`num_edges` distinct RMAT edges as sorted int64 keys `src * n_dst +
    dst` over local ids; `generator` lives on `device`."""
    scale = int(math.ceil(math.log2(max(n_src, n_dst, 2))))
    keys = torch.empty(0, dtype=torch.int64, device=device)
    draw = int(num_edges * 1.25) + 1024
    while keys.numel() < num_edges:
        src = torch.zeros(draw, dtype=torch.int64, device=device)
        dst = torch.zeros(draw, dtype=torch.int64, device=device)
        for _ in range(scale):
            r = torch.rand(draw, generator=generator, device=device,
                           dtype=torch.float64)
            src = (src << 1) | (r >= a + b).to(torch.int64)
            dst = (dst << 1) | (((r >= a) & (r < a + b))
                                | (r >= a + b + c)).to(torch.int64)
        src %= n_src
        dst %= n_dst
        keep = src != dst if same_type else torch.ones_like(src, dtype=bool)
        keys = torch.unique(torch.cat([keys, src[keep] * n_dst + dst[keep]]))
        del src, dst, keep
    if keys.numel() > num_edges:
        pick = torch.randperm(keys.numel(), generator=generator,
                              device=device)[:num_edges]
        keys = torch.sort(keys[pick]).values
    return keys


def _csr(rows: torch.Tensor, cols: torch.Tensor, n_rows: int,
         col_offset: int) -> tuple[np.ndarray, np.ndarray]:
    """Host CSR of (row, col) pairs already sorted by row then col: int64
    `indptr`, int32 global column ids."""
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(torch.bincount(rows, minlength=n_rows), 0, out=indptr[1:])
    return (indptr.cpu().numpy(),
            (cols + col_offset).to(torch.int32).cpu().numpy())


def type_offsets(counts: dict) -> dict:
    """Each node type's first global id, the types laid out in order."""
    return dict(zip(counts, np.cumsum([0] + list(counts.values()))
                    .tolist()))


def relation_csrs(config: dict, device: torch.device) -> list[dict]:
    """Every relation's CSR over its destination rows, listing global
    source ids: `{"src", "name", "dst", "indptr", "indices"}`."""
    counts, g = config["nodes"], config["graph"]
    offsets = type_offsets(counts)
    gen = inputs.generator(device, g["seed"])
    pairs = {}
    for s, name, t in config["relations"]:
        if name.startswith("rev_"):
            continue
        keys = rmat_pairs(counts[s], counts[t], config["edges"][name],
                          s == t, a=g["a"], b=g["b"], c=g["c"],
                          generator=gen, device=device)
        pairs[name] = (keys // counts[t], keys % counts[t])   # by src
    out = []
    for s, name, t in config["relations"]:
        if name.startswith("rev_"):
            # the forward keys run by source: this relation's destination
            dst, src = pairs[name[len("rev_"):]]
        else:
            src, dst = pairs[name]
            order = torch.argsort(dst * counts[s] + src)
            src, dst = src[order], dst[order]
        indptr, indices = _csr(dst, src, counts[t], offsets[s])
        out.append({"src": s, "name": name, "dst": t, "indptr": indptr,
                    "indices": indices})
    return out


def make_inputs(config: dict, traffic: dict, seed: int,
                device: torch.device) -> inputs.Inputs:
    counts = config["nodes"]
    rels = relation_csrs(config, device)
    n = sum(counts.values())
    # the program's typed graph over the same arrays; its union (built
    # once, kept) is the graph the data plane reads
    graph = HeteroGraph(
        counts, [Relation(r["src"], r["name"], r["dst"], r["indptr"],
                          r["indices"]) for r in rels],
        feature_dim=config["in_dim"], name=config["name"])
    union = graph.union()
    features = inputs.feature_table(n, config["in_dim"], seed, device)
    labels = torch.randint(
        0, config["num_classes"], (n,),
        generator=inputs.generator(device, inputs.stream_seed(seed, 2)),
        device=device).cpu().numpy()
    # the seeds: papers with `min_out_degree` edges over the relations
    # into paper, counted as a CSR's out-degree
    deg = sum(np.diff(r["indptr"]) for r in rels if r["dst"] == "paper")
    pool = type_offsets(counts)["paper"] + inputs.seed_pool(
        np.concatenate([[0], np.cumsum(deg)]), traffic["seed_pool"],
        config["graph"]["seed"])
    shapes = ref.param_shapes(config["in_dim"], config["hidden_dim"],
                              config["num_heads"], config["num_classes"],
                              len(config["fanouts"]), relation_names(config))
    params = ref.init_params(
        shapes, inputs.generator(device, inputs.stream_seed(seed, 3)),
        device)
    return inputs.Inputs(union.indptr, union.indices, features, labels, pool,
                         params, extras={"types": dict(counts),
                                         "relations": rels, "graph": graph})


class Program:
    """The measured package's R-GAT training loop for one cell: the
    loader's `next_batch()` over a `HeteroGraph` (sampler "relational"),
    `block_tensors` and the labels' upload, then `sgd_step`.  In traced
    runs the loader gets an `obs.Tracer`, whose `sample_relations` and
    `build_blocks` wall spans (on `time.perf_counter`, the clock of the
    run's spans) are copied into the run's spans after every step."""

    def __init__(self, cell, inp: inputs.Inputs, seed: int,
                 device: torch.device, spans):
        cfg = cell.config
        self.device, self.lr, self.spans = device, cfg["lr"], spans
        self.model = RGAT(RGATConfig(
            in_dim=cfg["in_dim"], hidden_dim=cfg["hidden_dim"],
            num_heads=cfg["num_heads"], num_classes=cfg["num_classes"],
            fanouts=tuple(cfg["fanouts"]),
            relations=tuple(tuple(r) for r in cfg["relations"])),
            device=device)
        self.model.load_reference_params(inp.params)
        loader = dict(cfg["loader"])
        ssd = getattr(program_core, loader.pop("ssd"))
        self.tracer = Tracer() if spans.enabled else None
        self._copied = 0
        self.loader = program_core.GIDSDataLoader(
            inp.extras["graph"], inp.features,
            program_core.LoaderConfig(
                **loader, batch_size=cell.traffic["batch_size"],
                fanouts=tuple(cfg["fanouts"]), sampler="relational",
                seed=inputs.stream_seed(seed, 4)),
            ssd=ssd, train_ids=inp.seed_pool, device=device,
            tracer=self.tracer)
        self.labels = torch.from_numpy(inp.labels).to(device)
        self.top = self.loader.store.tiers[0]
        if spans.enabled:
            spans.wrap(self.loader, "plan_next", "plan_next")
            spans.wrap(self.loader, "execute", "execute")

    def _copy_program_spans(self) -> None:
        wall = self.tracer.wall_spans()
        self.spans.records.extend(
            (w.name, w.wall_t0, w.wall_t0 + w.wall_dur)
            for w in wall[self._copied:] if w.name in PROGRAM_SPANS)
        self._copied = len(wall)

    def step(self, events: list | None = None):
        """One training step; returns (batch, None, loss)."""
        b = self.loader.next_batch()
        if self.tracer is not None:
            self._copy_program_spans()
        with self.spans("feed"):
            blocks = block_tensors(b.blocks, self.device)
            y = self.labels[torch.from_numpy(b.blocks.seeds).to(self.device)]
        with self.spans("model_step"):
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            loss = sgd_step(self.model, b.features, blocks, y, self.lr)
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        return b, None, loss

    def params(self) -> dict:
        return judge.cpu_tree(self.model.param_tree())

    def cache_counters(self) -> tuple[int, int] | None:
        store = getattr(self.top, "store", None)
        if store is None:
            return None
        return int(store.cache.hits), int(store.cache.misses)


def kept(b) -> dict:
    """The batch in global ids: its levels, and per hop and relation the
    destinations, the drawn sources (-1 where masked) and the mask."""
    blocks = b.blocks
    hops = [[{"dst": blocks.levels[k][r.dst],
              "src": np.where(r.mask, blocks.levels[k + 1][r.src], -1),
              "mask": r.mask} for r in hop]
            for k, hop in enumerate(blocks.hops)]
    return {"seeds": blocks.seeds, "all_nodes": blocks.all_nodes,
            "levels": blocks.levels, "hops": hops}


def bad_sample_ids(config: dict, traffic: dict, inp: inputs.Inputs,
                   kept: list[dict]) -> int:
    """`reference.rgat.bad_sample_ids` over every kept batch."""
    graph = ref.RelationalGraph(inp.extras["types"],
                                inp.extras["relations"])
    return sum(ref.bad_sample_ids(graph, inp.seed_pool, b,
                                  config["fanouts"], traffic["batch_size"])
               for b in kept)


def follow(config: dict, inp: inputs.Inputs, steps: list[dict],
           device: torch.device, *, tf32: bool = False,
           keep_seeds: float = 1.0,
           dtype: torch.dtype = torch.float32) -> dict:
    return ref.follow(inp.params, steps, inp.features, inp.labels,
                      relation_names(config), config["num_heads"],
                      config["lr"], device, tf32=tf32, keep_seeds=keep_seeds,
                      dtype=dtype)


def reordered(step: dict, config: dict) -> dict:
    """`step` with every destination's slots in reverse order: the same
    batch, summed in another order."""
    hops = [[{"dst": r["dst"],
              "src": np.ascontiguousarray(np.asarray(r["src"])[:, ::-1]),
              "mask": np.ascontiguousarray(np.asarray(r["mask"])[:, ::-1])}
             for r in hop]
            for hop in step["hops"]]
    return {**step, "hops": hops}


def step_matmul_flops(config: dict, batch: int) -> None:
    """R-GAT's products scale with the deduplicated levels' sizes, which
    the batch alone does not give: not counted (`PERF.md` §7)."""
    return None


def kernel_counts(config: dict, step, shape) -> dict:
    """Bytes `tiered_gather` (one launch a step) has to move in `step`."""
    return {"tiered_gather": (yardstick.tiered_gather_bytes(
        step.staged_rows, config["in_dim"]), 1)}
