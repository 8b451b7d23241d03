"""One run of a cell: set-up, the first training steps, the measured window
and the checks.

The program, its inputs and what its batches are checked by come from the
cell's family (`families/<name>.py`); the loop is the same for every
family.  Set-up builds one program, drives it through the traffic's warm-up
steps (the first `checked_steps` of them are the steps the reference
follows), and hands the same object to the window.  The window starts
after warm-up and ends with the first step that ends past `--seconds`, and
holds at least two steps; every step in it counts.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from repro_torch.kernels import _build

from . import inputs as inputs_mod
from . import judge
from . import trace as trace_mod
from .spec import Cell

#: steps a window holds at the least: a percentile of the steps' times
#: needs two
MIN_WINDOW_STEPS = 2


@dataclasses.dataclass
class Step:
    """One step of the window."""

    wall_s: float
    seeds: int
    staged_rows: int                 # rows the top tier staged
    split_ms: dict                   # DeviceStoreTier.last_split_ms
    model_ms: float | None = None    # CUDA events around the model step
    #: per kernel, (bytes it has to move, launches), from the family's
    #: `kernel_counts` in traced runs
    kernels: dict = dataclasses.field(default_factory=dict)


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
    #: a step's matrix-product operations (the family's
    #: `step_matmul_flops` at the mix's batch)
    step_flops: int | None = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _kept(ids: dict, b) -> dict:
    """What the checks keep of batch `b`: its ids (the family's `kept`),
    and the checksums of its gathered rows, computed where they lie."""
    row_sums, col_sums = judge.checksums(b.features)
    return ids | {"row_sums": row_sums, "col_sums": col_sums}


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
        _build.build(cell.family.kernel_sources)
    marks.append(("build", time.perf_counter()))
    inp = cell.family.make_inputs(cfg, traffic, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("inputs", time.perf_counter()))
    prog = cell.family.Program(cell, inp, seed, device, spans)
    marks.append(("program", time.perf_counter()))
    n_checked = traffic["checked_steps"]
    if not 1 <= n_checked <= traffic["warmup_steps"]:
        raise ValueError("a mix checks 1 to warmup_steps steps")
    first, checked = [], {"losses": []}
    for i in range(traffic["warmup_steps"]):
        b, _, loss = prog.step()
        if i < n_checked:
            first.append(_kept(cell.family.kept(b), b))
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
    shapes: list = []
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
        b, shape, loss = prog.step(events)
        ids = cell.family.kept(b)
        slot = reservoir.offer(len(steps))
        if slot is not None:
            reservoir.items[slot] = _kept(ids, b)
        losses.append(loss)
        _sync(device)
        te = time.perf_counter()
        steps.append(Step(wall_s=te - ts, seeds=len(ids["seeds"]),
                          staged_rows=len(ids["all_nodes"]),
                          split_ms=dict(getattr(prog.top, "last_split_ms",
                                                {}))))
        if traced:
            shapes.append(shape)
        del b, shape, loss, ids
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
        for s, shape in zip(steps, shapes, strict=True):
            s.kernels = cell.family.kernel_counts(cfg, s, shape)
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
    checks = judge.judge(cell, inp, first, sampled, program, nonfinite,
                         device)
    window = Window(config=cfg, traffic=traffic, t0=t0, t1=t1, steps=steps,
                    spans=spans, device_trace=dtrace, cache_hits=hits,
                    cache_misses=misses,
                    step_flops=cell.family.step_matmul_flops(
                        cfg, traffic["batch_size"]))
    return {"setup_s": t0 - t_start, "window": window, "checks": checks,
            "nonfinite": nonfinite, "memory_peak_bytes": peak}
