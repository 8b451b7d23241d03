"""The `hgt` family: HGT (the Heterogeneous Graph Transformer,
arXiv:2003.01332) on IGBH's typed nodes, trained through `repro_torch`'s
`GIDSDataLoader` with the relational sampler, on exactly the `rgat`
family's inputs: the same graph, feature table, labels and seed pool
(`families/rgat.py`), with HGT's parameters in place of R-GAT's.  What a
family module provides is listed in `families/gnn.py`'s docstring; the
sampler's checks, what a batch keeps and its reordering are `rgat`'s.
"""
from __future__ import annotations

import dataclasses

import torch

from bench import inputs
from bench.families import rgat
from bench.families.rgat import bad_sample_ids, kept, reordered  # noqa: F401
from bench.reference import hgt as ref
from repro_torch import core as program_core
from repro_torch.models.hgt import HGT, HGTConfig, hgt_blocks, sgd_step
from repro_torch.obs import Tracer

kernel_sources = ("tiered_gather", "cache_access", "hgt_attend")

#: the program's spans that `--trace 1` runs copy into the run's spans
PROGRAM_SPANS = ("sample_relations", "build_blocks", "hgt_slots")
#: `hgt_attend`'s launches a layer: the forward, and the backward's
#: destination pass and row pass (the last where the layer has a slot)
FORWARD_LAUNCHES, BACKWARD_LAUNCHES = 1, 2


def make_inputs(config: dict, traffic: dict, seed: int,
                device: torch.device) -> inputs.Inputs:
    inp = rgat.make_inputs(config, traffic, seed, device)
    shapes = ref.param_shapes(config["in_dim"], config["hidden_dim"],
                              config["num_heads"], config["num_classes"],
                              len(config["fanouts"]), list(config["nodes"]),
                              rgat.relation_names(config))
    params = ref.init_params(
        shapes, inputs.generator(device, inputs.stream_seed(seed, 3)),
        device)
    return dataclasses.replace(inp, params=params)


class Program(rgat.Program):
    """The measured package's HGT training loop for one cell: the loader's
    `next_batch()` over a `HeteroGraph` (sampler "relational"),
    `hgt_blocks` and the labels' upload, then `sgd_step`.  In traced runs
    the loader and `hgt_blocks` share one `obs.Tracer`, whose
    `sample_relations`, `build_blocks` and `hgt_slots` wall spans are
    copied into the run's spans after every feed.  `params` and
    `cache_counters` are R-GAT's."""

    def __init__(self, cell, inp: inputs.Inputs, seed: int,
                 device: torch.device, spans):
        cfg = cell.config
        self.device, self.lr, self.spans = device, cfg["lr"], spans
        self.graph = inp.extras["graph"]
        self.model = HGT(HGTConfig(
            in_dim=cfg["in_dim"], hidden_dim=cfg["hidden_dim"],
            num_heads=cfg["num_heads"], num_classes=cfg["num_classes"],
            fanouts=tuple(cfg["fanouts"]),
            relations=tuple(tuple(r) for r in cfg["relations"]),
            node_types=tuple(cfg["nodes"])), device=device)
        self.model.load_reference_params(inp.params)
        loader = dict(cfg["loader"])
        ssd = getattr(program_core, loader.pop("ssd"))
        self.tracer = Tracer() if spans.enabled else None
        self._copied = 0
        self.loader = program_core.GIDSDataLoader(
            self.graph, inp.features,
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
        """One training step; returns (batch, each layer's (destinations,
        slots, k'/v' rows), loss)."""
        b = self.loader.next_batch()
        with self.spans("feed"):
            blocks = hgt_blocks(b.blocks, self.graph, self.device,
                                self.tracer)
            y = self.labels[torch.from_numpy(b.blocks.seeds).to(self.device)]
        if self.tracer is not None:
            self._copy_program_spans()
        with self.spans("model_step"):
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            loss = sgd_step(self.model, b.features, blocks, y, self.lr)
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        shape = [(r["dst"], r["slots"], sum(r["kv_rows"].values()))
                 for r in self.model.last_rows]
        return b, shape, loss


def follow(config: dict, inp: inputs.Inputs, steps: list[dict],
           device: torch.device, *, tf32: bool = False,
           keep_seeds: float = 1.0,
           dtype: torch.dtype = torch.float32) -> dict:
    return ref.follow(inp.params, steps, inp.features, inp.labels,
                      config["nodes"], config["relations"],
                      config["num_heads"], config["lr"], device, tf32=tf32,
                      keep_seeds=keep_seeds, dtype=dtype)


def step_matmul_flops(config: dict, batch: int) -> None:
    """HGT's products scale with the deduplicated levels' sizes, which the
    batch alone does not give: not counted, as for R-GAT (`PERF.md` §7)."""
    return None


def hgt_attend_bytes(n: int, slots: int, rows: int, width: int,
                     heads: int, itemsize: int = 4) -> tuple[int, int]:
    """Bytes `hgt_attend` has to move in one layer's forward and backward
    over n destinations, `slots` slots and `rows` rows of k' and v'.
    Forward: q, every k' and v' row once, indptr and idx read; out and the
    log-sum-exp written.  Backward: the same reads, out, the log-sum-exp
    and out's gradient g read; dq, dk' and dv' written.  Nothing where
    there is no destination (no launch)."""
    if n == 0:
        return 0, 0
    q = n * width * itemsize
    kv = 2 * rows * width * itemsize
    csr = (n + 1) * 4 + slots * 4
    lse = n * heads * itemsize
    forward = q + kv + csr + q + lse
    backward = (q + kv + csr + q + lse + q) + (q + kv)
    return forward, backward


def hgt_attend_launches(n: int, slots: int) -> int:
    """`hgt_attend`'s launches in one layer's forward and backward."""
    if n == 0:
        return 0
    return FORWARD_LAUNCHES + BACKWARD_LAUNCHES - (slots == 0)


def attend_counts(config: dict, shape) -> tuple[int, int]:
    """Bytes and launches of `hgt_attend` (every layer's forward and
    backward) in a step, from each layer's (destinations, slots, k'/v'
    rows)."""
    width, heads = config["hidden_dim"], config["num_heads"]
    attend = launches = 0
    for n, slots, rows in shape:
        attend += sum(hgt_attend_bytes(n, slots, rows, width, heads))
        launches += hgt_attend_launches(n, slots)
    return attend, launches


def kernel_counts(config: dict, step, shape) -> dict:
    """`tiered_gather`'s bytes and launch in `step`, as R-GAT's, and
    `hgt_attend`'s (`attend_counts`)."""
    return (rgat.kernel_counts(config, step, shape)
            | {"hgt_attend": attend_counts(config, shape)})
