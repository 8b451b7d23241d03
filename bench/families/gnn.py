"""The `gnn` family: GraphSAGE-mean and GAT (`"model": "sage"` or `"gat"`)
on one homogeneous graph, trained through `repro_torch`'s
`GIDSDataLoader` on fixed-fanout neighbour samples.  A configuration that
names no `"family"` is of this one.

What every family module provides, and what the harness calls it for
(`bench/README.md`, "Adding to it"):

- `kernel_sources`: the package's CUDA sources the training path launches,
  built before set-up's clock reads "build";
- `make_inputs(config, traffic, seed, device)`: the graph, features,
  labels, seed pool and initial parameters (`inputs.Inputs`);
- `Program(cell, inputs, seed, device, spans)`: the program under test,
  with `step(events)` returning (batch, what `kernel_counts` reads, loss),
  `params()`, `cache_counters()` and `top` (the data plane's top tier);
- `kept(batch)`: what the checks keep of a batch: "seeds" (the trained
  ids), "all_nodes" (the ids of `batch.features`' rows, in order) and
  whatever `bad_sample_ids` and `follow` read besides;
- `bad_sample_ids(config, traffic, inputs, kept)`: ids of the kept
  batches that break what the sampler guarantees;
- `follow(config, inputs, steps, device, *, tf32, keep_seeds, dtype)`: the
  plain reference's run of the kept steps (`reference/follow.py`'s result);
- `reordered(step, config)`: a kept step summed in another order, for
  `bench.control --witness`;
- `step_matmul_flops(config, batch)`: a step's matrix-product operations
  at `batch` seeds;
- `kernel_counts(config, step, shapes)`: per kernel, the bytes it has to
  move in one window step and its launches there.

Only a family module and its reference (`reference/<name>.py`, which
imports nothing of the program) know the model.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench import inputs, judge, rmat, yardstick
from bench.reference import check
from bench.reference import follow as reference_run
from bench.reference import gnn as ref_gnn
from repro_torch import core as program_core
from repro_torch.graph.csr import CSRGraph
from repro_torch.models.gnn import GNN, GNNConfig, hop_indices, sgd_step

kernel_sources = ("segment_mean", "tiered_gather", "cache_access")


def heads(config: dict) -> int:
    """Attention heads of a configuration's model (1 where it has none)."""
    return config.get("num_heads", 1)


def make_inputs(config: dict, traffic: dict, seed: int,
                device: torch.device) -> inputs.Inputs:
    g = config["graph"]
    n, dim = config["nodes"], config["in_dim"]
    indptr, indices = rmat.rmat_csr(
        n, config["edges"], a=g["a"], b=g["b"], c=g["c"],
        generator=inputs.generator(device, g["seed"]), device=device)
    features = inputs.feature_table(n, dim, seed, device)
    labels = torch.randint(
        0, config["num_classes"], (n,),
        generator=inputs.generator(device, inputs.stream_seed(seed, 2)),
        device=device).cpu().numpy()
    pool = inputs.seed_pool(indptr, traffic["seed_pool"], g["seed"])
    shapes = ref_gnn.param_shapes(
        config["model"], dim, config["hidden_dim"], config["num_classes"],
        len(config["fanouts"]), heads(config))
    params = ref_gnn.init_params(
        shapes, inputs.generator(device, inputs.stream_seed(seed, 3)),
        device)
    return inputs.Inputs(indptr, indices, features, labels, pool, params)


class Program:
    """The measured package's training loop for one cell, as
    `examples/train_gnn_igb_torch.py` drives it: `next_batch()`,
    `hop_indices` and the upload of indices and labels, then `sgd_step`."""

    def __init__(self, cell, inp: inputs.Inputs, seed: int,
                 device: torch.device, spans):
        cfg = cell.config
        self.device, self.lr, self.spans = device, cfg["lr"], spans
        # every field of the model's and the loader's configuration that the
        # configuration file sets reaches the program; the rest keep the
        # program's defaults
        model_fields = {f.name for f in dataclasses.fields(GNNConfig)}
        model_cfg = {k: v for k, v in cfg.items() if k in model_fields}
        model_cfg["fanouts"] = tuple(cfg["fanouts"])
        self.model = GNN(GNNConfig(**model_cfg), device=device)
        self.model.load_reference_params(inp.params)
        graph = CSRGraph(indptr=inp.indptr, indices=inp.indices,
                         num_nodes=len(inp.indptr) - 1,
                         feature_dim=inp.features.shape[1],
                         name=cell.config_name)
        loader = dict(cfg["loader"])
        ssd = getattr(program_core, loader.pop("ssd"))
        self.loader = program_core.GIDSDataLoader(
            graph, inp.features,
            program_core.LoaderConfig(
                **loader, batch_size=cell.traffic["batch_size"],
                fanouts=tuple(cfg["fanouts"]),
                seed=inputs.stream_seed(seed, 4)),
            ssd=ssd, train_ids=inp.seed_pool, device=device)
        self.labels = torch.from_numpy(inp.labels).to(device)
        self.top = self.loader.store.tiers[0]
        if spans.enabled:
            spans.wrap(self.loader, "plan_next", "plan_next")
            spans.wrap(self.loader, "execute", "execute")

    def step(self, events: list | None = None):
        """One training step; returns (batch, host hop indices, loss)."""
        b = self.loader.next_batch()
        with self.spans("feed"):
            hi_np = hop_indices(b.blocks)
            hi = [torch.from_numpy(i).to(self.device) for i in hi_np]
            y = self.labels[torch.from_numpy(b.blocks.seeds).to(self.device)]
        with self.spans("model_step"):
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            loss = sgd_step(self.model, b.features, hi, y, self.lr)
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        return b, hi_np, loss

    def params(self) -> dict:
        return judge.cpu_tree(self.model.param_tree())

    def cache_counters(self) -> tuple[int, int] | None:
        store = getattr(self.top, "store", None)
        if store is None:
            return None
        return int(store.cache.hits), int(store.cache.misses)


def kept(b) -> dict:
    return {"seeds": b.blocks.seeds, "hop_nodes": b.blocks.hop_nodes,
            "all_nodes": b.blocks.all_nodes}


def bad_sample_ids(config: dict, traffic: dict, inp: inputs.Inputs,
                   kept: list[dict]) -> int:
    """`reference.check.bad_sample_ids` over every kept batch."""
    graph = check.Graph(inp.indptr, inp.indices)
    return sum(check.bad_sample_ids(graph, inp.seed_pool, b["seeds"],
                                    b["hop_nodes"], b["all_nodes"],
                                    config["fanouts"], traffic["batch_size"])
               for b in kept)


def follow(config: dict, inp: inputs.Inputs, steps: list[dict],
           device: torch.device, *, tf32: bool = False,
           keep_seeds: float = 1.0,
           dtype: torch.dtype = torch.float32) -> dict:
    return reference_run.follow(
        config["model"], inp.params, steps, inp.features, inp.labels,
        config["fanouts"], heads(config), config["lr"], device, tf32=tf32,
        keep_seeds=keep_seeds, dtype=dtype)


def reordered(step: dict, config: dict) -> dict:
    """`step` with each row's sampled neighbours in reverse order, every
    subtree moved with its root: the same batch, summed in another
    order."""
    perm = np.arange(len(step["seeds"]))
    hops = []
    for f, nodes in zip(config["fanouts"], step["hop_nodes"]):
        perm = (perm[:, None] * f + np.arange(f - 1, -1, -1)).reshape(-1)
        hops.append(np.asarray(nodes)[perm])
    return {**step, "hop_nodes": hops}


def step_matmul_flops(config: dict, batch: int) -> int:
    return yardstick.step_matmul_flops(
        config["model"], batch, config["fanouts"], config["in_dim"],
        config["hidden_dim"], config["num_classes"])


def kernel_counts(config: dict, step, hop_idx: list[np.ndarray]) -> dict:
    """Bytes `segment_mean` (one launch a hop) and `tiered_gather` (one a
    step) have to move in `step`, from its shapes (`yardstick`)."""
    fanouts, dim = config["fanouts"], config["in_dim"]
    seen = np.zeros(step.staged_rows, bool)
    total = 0
    for lvl, f in enumerate(fanouts):
        idx = hop_idx[lvl + 1]
        seen[:] = False
        seen[idx] = True
        total += yardstick.segment_mean_bytes(
            len(idx) // f, f, int(seen.sum()), dim)
    return {"segment_mean": (total, len(fanouts)),
            "tiered_gather": (yardstick.tiered_gather_bytes(
                step.staged_rows, dim), 1)}
