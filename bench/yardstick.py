"""The benchmark's arithmetic, kept apart from the program it measures: the
card's published peaks, the percentile, the operation and byte counts of
a training step, and the shares of a peak computed from them.

Peaks are NVIDIA's data sheet for one H100 SXM (dense): float32 outside
the tensor cores 67 TFLOP/s, TF32 495 TFLOP/s, HBM3 3.35 TB/s.  They hold
at the card's full 700 W; the run prints the card's power limit beside
every share.
"""
from __future__ import annotations

import statistics
from typing import Sequence

F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
HBM_BYTES_PER_S = 3.35e12

#: the peak for the precision a configuration states
PEAK_FLOPS_PER_S = {"float32": F32_FLOPS_PER_S, "tf32": TF32_FLOPS_PER_S}


def percentile(values: Sequence[float], q: int) -> float:
    """The q-th percentile (1 <= q <= 99) of every value, by linear
    interpolation between closest ranks (`statistics.quantiles`,
    'inclusive')."""
    if len(values) < 2:
        raise ValueError(f"a percentile needs two values, got {len(values)}")
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def level_sizes(batch: int, fanouts: Sequence[int]) -> list[int]:
    """Rows at each hop level of a fixed-fanout sample: level 0 holds the
    seeds, level l + 1 holds fanouts[l] rows for each row of level l."""
    sizes = [batch]
    for f in fanouts:
        sizes.append(sizes[-1] * f)
    return sizes


def step_matmul_flops(model: str, batch: int, fanouts: Sequence[int],
                      in_dim: int, hidden: int, classes: int) -> int:
    """Matrix-product operations of one training step, forward and
    backward, with no recomputation.

    Layer t maps hop levels 0 .. L-t-1 from width d_in to d_out.  The
    backward takes each weight's gradient (as many operations as the
    forward product) and, from layer 1 on, the input's gradient too;
    layer 0's inputs are feature rows, which take no gradient.
    GraphSAGE-mean multiplies every destination row and its neighbour
    mean; GAT multiplies every destination row and every neighbour row."""
    n = level_sizes(batch, fanouts)
    L = len(fanouts)
    dims = [in_dim] + [hidden] * L
    total = 0
    for t in range(L):
        rows = 0
        for lvl in range(L - t):
            rows += n[lvl]                                   # W_self
            rows += n[lvl] if model == "sage" else n[lvl + 1]  # W_nbr
        fwd = 2 * rows * dims[t] * dims[t + 1]
        total += fwd * (2 if t == 0 else 3)
    head = 2 * batch * hidden * classes
    total += head * 3
    return total


def segment_mean_bytes(n_dst: int, fanout: int, n_unique_src: int,
                       dim: int, itemsize: int = 4) -> int:
    """Bytes `segment_mean` has to move for one call: its (n_dst, fanout)
    int32 indices and each distinct source row read once, its (n_dst, dim)
    means written once."""
    return (n_dst * fanout * 4 + n_unique_src * dim * itemsize
            + n_dst * dim * itemsize)


def tiered_gather_bytes(rows: int, dim: int, itemsize: int = 4) -> int:
    """Bytes `tiered_gather` has to move for one call over `rows`
    requests: the int32 slot of each, its row read once (from the row
    store or the staged rows) and written once."""
    return rows * 4 + 2 * rows * dim * itemsize


def share_of_peak(work: float, seconds: float, peak_per_s: float) -> float:
    """Work done over `seconds` as a percentage of what the peak rate would
    do in that time."""
    return 100.0 * work / (seconds * peak_per_s)
