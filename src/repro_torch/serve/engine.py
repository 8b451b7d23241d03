"""Batched serving engine, the port of `repro.serve.engine`: slot-based
continuous batching over `LM.prefill` / `LM.decode_step` on one card.

GIDS principles carry over to serving:
  * the request queue is the accumulator's dispatch-ahead pool — admissions
    are batched so the decode step always runs at full slot occupancy;
  * per-slot KV cache blocks are the software-cache lines: the slot pool is
    a data-plane tier (`KVSlotTier`, built through the "serve-kv"
    `DataPlaneSpec` preset) — a request "hits" while it holds a slot, a
    finished request's slot is "safe to evict" and recycled;
  * admission staging gets the training loop's overlap pricing: per tick,
    the modelled prefill/staging cost of admitted requests is discounted by
    the decode compute it ran behind (`overlap_exposed`), and
    `overlap_stats` reports how much of the admission prep the decode loop
    hid.

The reference rebuilds its cache functionally; here the engine's cache is
updated in place on the card: a prefilled request's rows are copied into
its slot of the engine cache (`Tensor.copy_`), and each decode step writes
one K/V row per slot into that cache (`LM.decode_step`).  With
`attn_impl="flash"` every attention layer of every prefill and decode step
runs the CUDA `flash_attention` kernel.

Every decoder-only family is served (dense, moe, hybrid, ssm, and vlm with
text-only requests, as the reference's `_admit` passes only tokens): each
cache leaf has a leading (layers, slots) pair of axes, so the splice copies
KV rows and RG-LRU or SSD states alike, and the `serve-kv` tier prices a
slot at all of them.  An encoder-decoder needs its frames at prefill,
which a `Request` does not carry: it runs through `LM.prefill` /
`LM.decode_step` directly (examples/serve_decode_torch.py).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.dataplane import DataPlaneSpec
from repro_torch.core.prefetch import PrefetchStats
from repro_torch.core.storage_sim import overlap_exposed
from repro_torch.core.tiers import KVSlotTier
from repro_torch.models.transformer import LM


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    kv_key: int = -1                # slot-pool key, assigned at admission


@dataclasses.dataclass
class EngineConfig:
    slots: int = 4                  # concurrent sequences (batch dim)
    max_seq: int = 256
    eos_token: int = -1             # -1: never stops early
    # modelled timing for the overlap accounting (0 = don't model)
    admit_cost_s: float = 0.0       # prefill/staging cost per admission
    decode_cost_s: float = 0.0      # compute cost of one decode tick


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree if isinstance(tree, list) else tree.values()
    return [t for sub in items for t in _leaves(sub)]


class ServeEngine:
    """Admit -> prefill-into-slot -> step-decode loop.

    Decode runs over ALL slots every step (static shapes); empty slots
    compute garbage that is never read.
    """

    def __init__(self, model: LM, params, cfg: EngineConfig,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if model.cfg.family == "encdec":
            raise ValueError(
                f"{model.cfg.name}: an encoder-decoder's prefill needs frames,"
                f" which requests do not carry; use LM.prefill / decode_step")
        if model.device.type != self.device.type:
            raise ValueError(f"engine on {self.device}, model on "
                             f"{model.device}")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.cache = model.init_cache(cfg.slots, cfg.max_seq)
        kv_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(self.cache))
        (self.kv_slots,) = DataPlaneSpec.preset("serve-kv").build_stack(
            slots=cfg.slots,
            bytes_per_slot=kv_bytes // max(cfg.slots, 1))
        assert isinstance(self.kv_slots, KVSlotTier)
        self.positions = np.zeros(cfg.slots, np.int32)   # next write index
        self.active: list[Optional[Request]] = [None] * cfg.slots
        self.queue: deque[Request] = deque()
        self._admit_seq = 0      # slot-pool key: admission order, not the
                                 # caller-supplied rid (rids may collide)
        self.overlap_stats = PrefetchStats()  # admission prep vs decode hide
        self._next_tok = np.zeros((cfg.slots, 1), np.int32)

    # -- steps -------------------------------------------------------------------
    @torch.inference_mode()
    def _decode(self) -> np.ndarray:
        # per-slot decode positions (continuous batching — each slot
        # advances independently)
        token = torch.from_numpy(self._next_tok).to(self.device)
        index = torch.from_numpy(self.positions).to(self.device)
        logits, self.cache = self.model.decode_step(self.params, token,
                                                    self.cache, index)
        return logits[:, -1, :].argmax(dim=-1).cpu().numpy()

    @torch.inference_mode()
    def _prefill(self, prompt: np.ndarray):
        sub_cache = self.model.init_cache(1, self.cfg.max_seq)
        tokens = torch.from_numpy(
            np.asarray(prompt, np.int32)[None, :]).to(self.device)
        logits, sub_cache = self.model.prefill(self.params,
                                               {"tokens": tokens}, sub_cache)
        return int(logits[0, -1].argmax()), sub_cache

    @torch.inference_mode()
    def _splice(self, slot: int, sub_cache) -> None:
        """Copy a prefilled request's cache rows into its slot, in place."""
        for full, one in zip(_leaves(self.cache), _leaves(sub_cache)):
            full[:, slot].copy_(one[:, 0])

    # -- admission -------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> list[Request]:
        """Admit queued requests into free slots; returns requests that
        finished AT prefill (max_new_tokens=1 or EOS on the first token) —
        they never occupy a slot for decoding."""
        retired = []
        while self.queue:
            slot = self.kv_slots.acquire(self._admit_seq)
            if slot is None:                   # pool full: stay queued
                break
            assert self.active[slot] is None, \
                "slot pool and active list out of sync"
            req = self.queue.popleft()
            req.kv_key = self._admit_seq
            self._admit_seq += 1
            tok, sub_cache = self._prefill(req.prompt)
            req.generated.append(tok)
            if (len(req.generated) >= req.max_new_tokens
                    or tok == self.cfg.eos_token):
                req.done = True
                retired.append(req)
                self.kv_slots.release(req.kv_key)
                continue
            self._splice(slot, sub_cache)
            self._next_tok[slot, 0] = tok
            self.positions[slot] = len(req.prompt)
            self.active[slot] = req
        return retired

    # -- main loop ---------------------------------------------------------------
    def step(self) -> list[Request]:
        """One engine tick: admit waiting requests, one decode step for all
        active slots, retire finished requests.  Returns retired.

        Overlap accounting: the modelled staging cost of this tick's
        admissions overlaps the decode compute of requests already in flight
        *before* the tick — a cold-start admission has no decode to hide
        behind and is fully exposed — so only the excess is hidden, exactly
        like the training loader's prefetch pricing."""
        was_decoding = any(r is not None for r in self.active)
        admitted_before = self._admit_seq
        retired = self._admit()
        n_admitted = self._admit_seq - admitted_before
        prep_s = n_admitted * self.cfg.admit_cost_s
        compute_s = self.cfg.decode_cost_s if was_decoding else 0.0
        # staged_batches counts admissions; consumed_batches is left at 0 —
        # serve has no per-batch consumer, only the prep/exposed totals and
        # hidden_fraction carry meaning here
        self.overlap_stats.staged_batches += n_admitted
        self.overlap_stats.prep_s_total += prep_s
        self.overlap_stats.exposed_s_total += \
            overlap_exposed(prep_s, compute_s)
        if not any(r is not None for r in self.active):
            return retired
        tok_np = self._decode()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            t = int(tok_np[slot])
            req.generated.append(t)
            self.positions[slot] += 1
            if (len(req.generated) >= req.max_new_tokens
                    or t == self.cfg.eos_token
                    or self.positions[slot] >= self.cfg.max_seq - 1):
                req.done = True
                retired.append(req)
                self.active[slot] = None
                self.kv_slots.release(req.kv_key)  # slot safe-to-evict
            else:
                self._next_tok[slot, 0] = t
        return retired

    def run_until_drained(self, max_ticks: int = 1000) -> list[Request]:
        """Step until queue and slots are empty.  If `max_ticks` runs out
        first, raise `EngineNotDrained` carrying the retired requests and
        the unfinished count — silently returning a partial result would
        let callers drop queued/active work on the floor."""
        out = []
        for _ in range(max_ticks):
            out.extend(self.step())
            if not self.queue and all(r is None for r in self.active):
                return out
        unfinished = len(self.queue) + sum(r is not None for r in self.active)
        if unfinished:
            raise EngineNotDrained(unfinished, out, max_ticks)
        return out


class EngineNotDrained(RuntimeError):
    """`run_until_drained` exhausted its tick budget with work still queued
    or decoding.  `retired` holds the requests that DID finish (the engine
    keeps its state, so calling `run_until_drained` again continues)."""

    def __init__(self, unfinished: int, retired: list[Request],
                 max_ticks: int):
        super().__init__(
            f"engine not drained after {max_ticks} ticks: {unfinished} "
            f"request(s) still queued or decoding ({len(retired)} retired)")
        self.unfinished = unfinished
        self.retired = retired
