"""One run of a cell: set-up, the first training steps, the measured window
and the checks.

The loop is the paper's training loop on the cell's data plane, as
`examples/train_gnn_igb_torch.py` drives it: `GIDSDataLoader.next_batch()`,
`models.gnn.hop_indices` and the upload of indices and labels, then
`models.gnn.sgd_step`.  Set-up builds one loader and one model, drives them
through the traffic's warm-up steps (the first `checked_steps` of them are
the steps the reference follows), and hands the same objects to the window.
The window starts after warm-up and ends with the first step that ends
past `--seconds`, and holds at least two steps; every step in it counts.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from repro_torch import core as program_core
from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import _build
from repro_torch.models.gnn import GNN, GNNConfig, hop_indices, sgd_step

from . import inputs as inputs_mod
from . import judge, yardstick
from . import trace as trace_mod
from .spec import Cell

#: steps a window holds at the least: a percentile of the steps' times
#: needs two
MIN_WINDOW_STEPS = 2
#: the CUDA sources the GNN training path launches
KERNEL_SOURCES = ("segment_mean", "tiered_gather", "cache_access")


@dataclasses.dataclass
class Step:
    """One step of the window."""

    wall_s: float
    seeds: int
    staged_rows: int                 # rows the top tier staged
    split_ms: dict                   # DeviceStoreTier.last_split_ms
    model_ms: float | None = None    # CUDA events around sgd_step
    segment_mean_bytes: int = 0
    tiered_gather_bytes: int = 0


@dataclasses.dataclass
class Window:
    """What a per-layer metric's reader reads."""

    config: dict
    traffic: dict
    t0: float
    t1: float
    steps: list[Step]
    spans: trace_mod.Spans
    device_trace: trace_mod.DeviceTrace | None
    cache_hits: int | None
    cache_misses: int | None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Program:
    """The measured package's training loop for one cell."""

    def __init__(self, cell: Cell, inp: inputs_mod.Inputs, seed: int,
                 device: torch.device, spans: trace_mod.Spans):
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
                seed=inputs_mod.stream_seed(seed, 4)),
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


def _kept(b, row_sums, col_sums) -> dict:
    return {"seeds": b.blocks.seeds, "hop_nodes": b.blocks.hop_nodes,
            "all_nodes": b.blocks.all_nodes, "row_sums": row_sums,
            "col_sums": col_sums}


class Reservoir:
    """A uniform sample of `size` of the window's steps, drawn from the
    seed as the steps come (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(inputs_mod.stream_seed(seed, 5))
        self.items: list[dict] = []

    def offer(self, index: int) -> int | None:
        """Where step `index` goes in the sample, or None."""
        if index < self.size:
            self.items.append({})
            return index
        j = int(self.rng.integers(0, index + 1))
        return j if j < self.size else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def setup(cell: Cell, seed: int, device: torch.device,
          spans: trace_mod.Spans):
    """Inputs, the program, and its warm-up steps.  Returns (inputs,
    program, first, checked): the checked batches of the first steps, and
    those steps' losses with the parameters after the first step
    ("params1") and after the last checked one ("params_n")."""
    cfg, traffic = cell.config, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    marks = [("start", time.perf_counter())]
    if device.type == "cuda":
        _build.build(KERNEL_SOURCES)
    marks.append(("build", time.perf_counter()))
    inp = inputs_mod.make(cfg, traffic, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("inputs", time.perf_counter()))
    prog = Program(cell, inp, seed, device, spans)
    marks.append(("program", time.perf_counter()))
    n_checked = traffic["checked_steps"]
    if not 1 <= n_checked <= traffic["warmup_steps"]:
        raise ValueError("a mix checks 1 to warmup_steps steps")
    first, checked = [], {"losses": []}
    for i in range(traffic["warmup_steps"]):
        b, _, loss = prog.step()
        if i < n_checked:
            first.append(_kept(b, *judge.checksums(b.features)))
            checked["losses"].append(float(loss))
            if i == 0:
                checked["params1"] = prog.params()
            if i == n_checked - 1:
                checked["params_n"] = prog.params()
        del b
    _sync(device)
    marks.append(("warmup", time.perf_counter()))
    print("bench: set-up s " + ", ".join(
        f"{name} {t - t_prev:.3f}"
        for (_, t_prev), (name, t) in zip(marks, marks[1:])),
        file=sys.stderr)
    return inp, prog, first, checked


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float) -> dict:
    """Set up, warm up, measure, check.  Returns the run's numbers:
    "setup_s", "window" (a `Window`), "checks", "nonfinite",
    "memory_peak_bytes"."""
    cfg, traffic = cell.config, cell.traffic
    cuda = device.type == "cuda"
    spans = trace_mod.Spans(traced)
    inp, prog, first, program = setup(cell, seed, device, spans)

    # the window
    reservoir = Reservoir(traffic["window_sample"], seed)
    steps: list[Step] = []
    losses: list[torch.Tensor] = []
    hop_idx: list[list[np.ndarray]] = []
    events: list | None = [] if (traced and cuda) else None
    # every run on the card traces its device operations: the end-to-end
    # device time per seed is read from that trace
    prof = host_anchor = None
    if cuda:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        host_anchor = trace_mod.anchor()
    counters0 = prog.cache_counters() if traced else None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        ts = time.perf_counter()
        b, hi_np, loss = prog.step(events)
        slot = reservoir.offer(len(steps))
        if slot is not None:
            reservoir.items[slot] = _kept(b, *judge.checksums(b.features))
        losses.append(loss)
        _sync(device)
        te = time.perf_counter()
        steps.append(Step(wall_s=te - ts, seeds=len(b.blocks.seeds),
                          staged_rows=len(b.blocks.all_nodes),
                          split_ms=dict(getattr(prog.top, "last_split_ms",
                                                {}))))
        if traced:
            hop_idx.append(hi_np)
        del b, hi_np, loss
        if te >= deadline and len(steps) >= MIN_WINDOW_STEPS:
            break
    t1 = te
    counters1 = prog.cache_counters() if traced else None
    dtrace = None
    if prof is not None:
        prof.stop()
        dtrace = trace_mod.device_trace(prof, host_anchor, t0, t1)
        del prof
    if events:
        for s, (a, e) in zip(steps, zip(events[::2], events[1::2])):
            s.model_ms = a.elapsed_time(e)
    if traced:
        _count_kernel_bytes(steps, hop_idx, cfg)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    nonfinite = judge.nonfinite_count(losses)
    sampled = [judge.to_host(k) for k in reservoir.items]
    first = [judge.to_host(k) for k in first]
    hits = misses = None
    if counters0 is not None and counters1 is not None:
        hits = counters1[0] - counters0[0]
        misses = counters1[1] - counters0[1]

    # the program's state goes before the reference runs
    del prog, losses, reservoir
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = judge.judge(cfg, traffic, inp, first, sampled, program,
                         nonfinite, device)
    window = Window(config=cfg, traffic=traffic, t0=t0, t1=t1, steps=steps,
                    spans=spans, device_trace=dtrace, cache_hits=hits,
                    cache_misses=misses)
    return {"setup_s": t0 - t_start, "window": window, "checks": checks,
            "nonfinite": nonfinite, "memory_peak_bytes": peak}


def _count_kernel_bytes(steps: list[Step], hop_idx: list, cfg: dict) -> None:
    """Bytes `segment_mean` and `tiered_gather` have to move in each step,
    from the step's shapes (`yardstick`)."""
    fanouts, dim = cfg["fanouts"], cfg["in_dim"]
    for s, hi in zip(steps, hop_idx, strict=True):
        seen = np.zeros(s.staged_rows, bool)
        total = 0
        for lvl, f in enumerate(fanouts):
            idx = hi[lvl + 1]
            seen[:] = False
            seen[idx] = True
            total += yardstick.segment_mean_bytes(
                len(idx) // f, f, int(seen.sum()), dim)
        s.segment_mean_bytes = total
        s.tiered_gather_bytes = yardstick.tiered_gather_bytes(
            s.staged_rows, dim)
