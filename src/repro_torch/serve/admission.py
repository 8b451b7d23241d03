"""SLO-aware admission and batching for the GNN serve plane, the port's
copy of `repro.serve.admission`.

The training loader merges a FIXED lookahead depth of batches because epochs
have no deadlines; online serving merges *in-flight requests* instead, and
the binding constraint is the oldest staged request's SLO.  `SLOBatcher`
forms windows over an arrival-ordered stream under the
`DeadlineWindowPolicy` (core/accumulator.py):

  * the window keeps admitting compatible requests while the next arrival
    lands before `close_by = oldest.arrival + oldest.deadline -
    safety * est_service(n)` — i.e. while waiting for it cannot by itself
    cost the oldest request its SLO;
  * the depth cap (`DeadlineWindowConfig.max_window`) keeps the same
    buffer-memory guard the training accumulator's `max_merge_iters` has;
  * a backlogged engine (busy past `close_by`) keeps admitting until the
    accelerator frees up — batching is free when service can't start anyway
    (work conservation);
  * expired requests — ones whose deadline has already passed before they
    could even be staged — are shed at admission rather than sampled,
    gathered, and delivered dead (`shed_expired`); shed requests count
    against goodput, not against served-latency percentiles.

All requests in one `next_window` call are "compatible": same fanouts,
same model — the engine owns one (model, fanouts) pair and every stream
request targets it — and the same tenant: the engine hands this batcher
one tenant's pending queue at a time, so windows are tenant-pure and a
noisy tenant's arrivals can never inflate another tenant's window.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.core.accumulator import DeadlineWindowPolicy

from .workload import ServeRequest


@dataclasses.dataclass
class WindowDecision:
    """One formed window: the staged requests (arrival order), the requests
    shed at admission, the virtual time service may begin (before the
    engine's sampling-completion adjustment), and why the window closed."""

    staged: list[ServeRequest]
    shed: list[ServeRequest]
    start_s: float
    hit_cap: bool


class SLOBatcher:
    """Deadline-bounded window formation over a virtual-time stream."""

    def __init__(self, policy: DeadlineWindowPolicy,
                 shed_expired: bool = True):
        self.policy = policy
        self.shed_expired = shed_expired

    def _expired(self, req: ServeRequest, earliest_start_s: float) -> bool:
        return (self.shed_expired
                and earliest_start_s > req.arrival_s + req.deadline_s)

    def next_window(self, pending: deque[ServeRequest],
                    busy_until_s: float) -> WindowDecision | None:
        """Form the next window from the arrival-ordered `pending` queue.
        `busy_until_s` is when the accelerator frees up — service can never
        start earlier, and requests already hopeless by then are shed."""
        shed: list[ServeRequest] = []
        oldest: ServeRequest | None = None
        while pending:
            req = pending.popleft()
            if self._expired(req, max(busy_until_s, req.arrival_s)):
                shed.append(req)
                continue
            oldest = req
            break
        if oldest is None:
            return (WindowDecision(staged=[], shed=shed, start_s=busy_until_s,
                                   hit_cap=False) if shed else None)

        staged = [oldest]
        hit_cap = False
        while True:
            if self.policy.full(len(staged)):
                hit_cap = True
                break
            close_by = self.policy.close_by(
                oldest.arrival_s, oldest.deadline_s, len(staged))
            bound = max(close_by, busy_until_s)   # work conservation: admit
            if not pending:                       # while the engine is busy
                break
            nxt = pending[0]
            if nxt.arrival_s > bound:
                break
            pending.popleft()
            if self._expired(nxt, max(bound, nxt.arrival_s)):
                shed.append(nxt)
                continue
            staged.append(nxt)

        last_arrival = staged[-1].arrival_s
        if hit_cap:
            # a full window starts as soon as the engine can take it
            start = max(busy_until_s, last_arrival)
        else:
            # the controller waited for arrivals until the slack ran out —
            # it has no oracle for the next arrival time, so the window
            # opens exactly when the oldest request's slack is spent
            close_by = self.policy.close_by(
                oldest.arrival_s, oldest.deadline_s, len(staged))
            start = max(busy_until_s, last_arrival, close_by)
        return WindowDecision(staged=staged, shed=shed, start_s=start,
                              hit_cap=hit_cap)
