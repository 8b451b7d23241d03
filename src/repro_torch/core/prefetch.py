"""Prefetch telemetry, the port's subset of `repro.core.prefetch`:
`PrefetchStats`, which the serve engine reports its admission overlap in.
`PrefetchEngine` waits for the host planes (ROADMAP.md Queue 1 item 1).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PrefetchStats:
    """Engine telemetry: how much modelled prep time the overlap hid."""

    staged_batches: int = 0
    consumed_batches: int = 0
    prep_s_total: float = 0.0
    exposed_s_total: float = 0.0

    @property
    def hidden_s_total(self) -> float:
        return self.prep_s_total - self.exposed_s_total

    @property
    def hidden_fraction(self) -> float:
        if self.prep_s_total <= 0:
            return 0.0
        return self.hidden_s_total / self.prep_s_total
