"""PyTorch/CUDA port of the GIDS data plane and GNN training loop.

Counterpart of the JAX package `repro`, module for module.  It imports
torch and numpy only.  Entry points run on the card (`device="cuda"`)
unless the caller passes `device="cpu"`, which selects each kernel's plain
PyTorch version; without a card they raise.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
