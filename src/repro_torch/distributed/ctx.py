"""Activation-sharding context, the port of `repro.distributed.ctx`.

Models are mesh-agnostic; launchers install a spec table here and model
code calls `constrain(x, name)` at the reference's anchor points (after
the embedding, around attention, at the MoE dispatch).  The port runs
each model on one device, where every placement is a replica, so
`constrain` returns `x` itself, inside a context or not; the table is
kept so that the dry-run and its tests read the same specs the reference
installs.
"""
from __future__ import annotations

import contextlib

_SPECS: dict | None = None


@contextlib.contextmanager
def activation_sharding(specs: dict):
    global _SPECS
    prev, _SPECS = _SPECS, specs
    try:
        yield
    finally:
        _SPECS = prev


def constrain(x, name: str):
    """`x` itself: a one-device tensor already satisfies every placement."""
    return x


def current_specs() -> dict | None:
    return _SPECS
