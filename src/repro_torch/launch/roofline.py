"""Roofline terms of a step, counted as it runs, the port of
`repro.launch.roofline` for one NVIDIA H100 SXM (80 GB HBM3, 700 W):

    peak bf16 compute : 989 TFLOP/s (dense, tensor cores)
    HBM bandwidth     : 3.35 TB/s
    NVLink 4          : 450 GB/s per direction

    compute_term    = flops / PEAK_FLOPS
    memory_term     = hbm_bytes / HBM_BW
    collective_term = collective_bytes / LINK_BW

The reference models a TPU's fused HLO.  The port has no HLO: its step
runs as eager PyTorch, one kernel per aten operation and nothing fused, and
that is the traffic the card really moves.  So the terms are counted from
the operations themselves while the step runs (on the meta device in the
dry-run, where nothing is allocated):

  * `OpCounter` (a `TorchDispatchMode`) sums, for every aten operation that
    is not a view (nor an alias such as `_unsafe_view`), the bytes of its tensor operands and of its results (an
    in-place operation reads and writes its target, `copy_` only writes
    it; an indexed read or write counts its whole table), and tracks the
    bytes of the live storages the step's operations allocated (their
    high-water is the step's temporary memory);
  * `torch.utils.flop_counter.FlopCounterMode` counts the FLOPs of the
    matrix products, attention and convolutions (element-wise work is not
    counted, as the reference's HLO cost counts it only marginally).
    Remat's recomputed forward runs inside the backward, so it is counted.

Collective bytes are not measured (one process runs the step): the dry-run
reckons them from the placements of the params
(`repro_torch.launch.dryrun.collective_bytes`).  They
are a model of what the placements imply, not a count of any collective
library's traffic.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

#: operations that allocate without writing (their result is counted when
#: a later operation writes it)
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Bytes moved by the non-view aten operations run inside it, by
    operation name, and the high-water of the live storages they
    allocated (`peak_bytes`, from `live_bytes` when it was entered)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.by_op: dict[str, int] = {}
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = WeakIdKeyDictionary()

    def _freed(self, n: int) -> None:
        self.live_bytes -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._freed, n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        name = func.overloadpacket.__name__
        operands = list(_tensors((args, kwargs)))
        results = list(_tensors(out))
        inputs = {id(t.untyped_storage()) for t in operands}
        fresh = [t for t in results if id(t.untyped_storage()) not in inputs]
        for t in fresh:
            self._track(t)
        if name in _NO_TRAFFIC or (results and not fresh
                                   and not func._schema.is_mutable):
            return out          # allocates only, or aliases its input
        n = sum(_nbytes(t) for t in operands)
        if name == "copy_":          # the target is written, not read
            n -= _nbytes(args[0])
        n += sum(_nbytes(t) for t in results)
        self.bytes += n
        self.by_op[name] = self.by_op.get(name, 0) + n
        self.ops += 1
        return out


@dataclasses.dataclass
class Count:
    flops: int
    hbm_bytes: int
    temp_peak_bytes: int
    ops: int
    by_op: dict


def count(fn, *args, **kwargs) -> tuple[object, Count]:
    """Run fn(*args, **kwargs) under both counters; (its output, the
    counts).  The output is kept alive until the counts are read, so the
    temporary high-water includes what the step returns."""
    flops = FlopCounterMode(display=False)
    ops = OpCounter()
    with flops, ops:
        out = fn(*args, **kwargs)
    return out, Count(flops=flops.get_total_flops(), hbm_bytes=ops.bytes,
                      temp_peak_bytes=ops.peak_bytes, ops=ops.ops,
                      by_op=dict(ops.by_op))


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    compute_term: float
    memory_term: float
    collective_term: float
    bottleneck: str
    step_time_s: float          # max of the three terms (overlap-optimistic)
    model_flops: float = 0.0
    useful_ratio: float = 0.0   # MODEL_FLOPS / (flops * chips)

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(flops: float, hbm_traffic: float, coll_total: float, *,
            model_flops: float = 0.0, chips: int = 256) -> Roofline:
    """The three terms of per-device counts against one card's peaks."""
    ct = flops / PEAK_FLOPS
    mt = hbm_traffic / HBM_BW
    lt = coll_total / LINK_BW
    terms = {"compute": ct, "memory": mt, "collective": lt}
    bottleneck = max(terms, key=terms.get)
    return Roofline(
        flops=flops, hbm_bytes=hbm_traffic, coll_bytes=coll_total,
        compute_term=ct, memory_term=mt, collective_term=lt,
        bottleneck=bottleneck, step_time_s=max(terms.values()),
        model_flops=model_flops,
        useful_ratio=(model_flops / (flops * chips)) if flops else 0.0,
    )
