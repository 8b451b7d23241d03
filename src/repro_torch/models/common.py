"""Parameter-spec machinery, the port's subset of `repro.models.common`:
`ParamDef` and `init_params` for the GNN.  The LM configuration and the
sharding rules wait for the LM slice (ROADMAP.md Queue 1).

Initial values come from an explicit `torch.Generator`; they differ from
`jax.random`'s for the same seed, so parity tests carry the reference's
parameters over instead (`models.gnn.GNN.load_reference_params`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                  # normal | zeros | ones | lecun
    scale: float = 1.0

    def initializer(self, generator: torch.Generator) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype)
        if self.init == "lecun":
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            std = math.sqrt(1.0 / fan_in)
        else:
            std = 0.02 * self.scale
        return (torch.randn(self.shape, generator=generator,
                            dtype=torch.float32) * std).to(self.dtype)


ParamTree = Any  # nested dict[str, ParamDef | ParamTree]


def init_params(defs: ParamTree, generator: torch.Generator) -> Any:
    """Materialise a ParamDef tree on the CPU, leaves drawn in sorted-key
    order from `generator` (a CPU generator, so values do not depend on
    the device they are moved to)."""
    if isinstance(defs, ParamDef):
        return defs.initializer(generator)
    return {k: init_params(defs[k], generator) for k in sorted(defs)}
