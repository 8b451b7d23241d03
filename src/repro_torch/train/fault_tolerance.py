"""Fault-tolerance runtime, the port of `repro.train.fault_tolerance`: step
watchdog, straggler flagging and a restart loop.

The data plane's contributions compose with it:
  * the GIDS accumulator's dispatch-ahead queue absorbs stragglers: a host
    whose storage or preprocessing stalls for fewer than merge_depth
    iterations never stalls the card;
  * the sampler's RNG state is checkpointed with the model
    (`GIDSDataLoader.state_dict`), so a restart replays the exact sample
    stream.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class WatchdogConfig:
    step_timeout_factor: float = 5.0   # flag a step slower than 5x median
    min_history: int = 16
    checkpoint_every: int = 100
    max_step_history: int = 256


class StepWatchdog:
    """Tracks step latencies; flags stragglers against the rolling median
    and drives the checkpoint cadence."""

    def __init__(self, cfg: WatchdogConfig | None = None,
                 clock: Callable[[], float] = time.monotonic):
        # `clock` is injectable so tests (and virtual-time harnesses) can
        # feed deterministic step durations instead of wall time
        self.cfg = cfg or WatchdogConfig()
        self.clock = clock
        self.history: list[float] = []
        self.flagged: list[tuple[int, float]] = []
        self._t0: float | None = None
        self._step = 0

    def start_step(self, step: int) -> None:
        self._step = step
        self._t0 = self.clock()

    def end_step(self) -> bool:
        """Returns True if this step was a straggler."""
        if self._t0 is None:
            raise RuntimeError("end_step() without a matching start_step()")
        dt = self.clock() - self._t0
        straggler = False
        if len(self.history) >= self.cfg.min_history:
            if dt > self.cfg.step_timeout_factor * self.median_step_s:
                self.flagged.append((self._step, dt))
                straggler = True
        self.history.append(dt)
        if len(self.history) > self.cfg.max_step_history:
            self.history.pop(0)
        return straggler

    def should_checkpoint(self, step: int) -> bool:
        return step > 0 and step % self.cfg.checkpoint_every == 0

    @property
    def median_step_s(self) -> float:
        """The upper median of the step history (0 before any step)."""
        if not self.history:
            return 0.0
        return sorted(self.history)[len(self.history) // 2]


def run_with_restarts(make_state: Callable, train_one: Callable,
                      total_steps: int, *, ckpt_dir, save_every: int = 50,
                      inject_failure_at: int | None = None):
    """Crash-safe training loop: builds state, optionally simulates
    one hard failure, restarts from the latest commit and carries on.

    make_state(restore_step | None) -> (state, start_step)
    train_one(state, step)          -> state
    """
    state, start = make_state(ckpt.latest_step(ckpt_dir))
    step = start
    while step < total_steps:
        if inject_failure_at is not None and step == inject_failure_at:
            inject_failure_at = None          # fail exactly once
            state, start = make_state(ckpt.latest_step(ckpt_dir))
            step = start
            continue
        state = train_one(state, step)
        step += 1
        if step % save_every == 0 or step == total_steps:
            ckpt.save(ckpt_dir, step, state)
    return state, step
