"""The benchmark's graph: an RMAT stand-in for IGB's edges, drawn on the
device from a seed.

The quadrant rule is the port's RMAT (`(a, b, c) = (0.57, 0.19, 0.19)`,
`scale = ceil(log2 N)` bits per endpoint, ids wrapped modulo N, self-loops
dropped), frozen here so that a later change to the program cannot move
the yardstick.  It draws on the card in a few large calls, so set-up stays
short, removes duplicate edges, and keeps exactly `num_edges` of them: the
published edge count of the graph it stands for.

Returns a host CSR (`indptr` int64, `indices` int32, each row sorted), the
form the loader reads.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def rmat_csr(num_nodes: int, num_edges: int, *, a: float, b: float,
             c: float, generator: torch.Generator,
             device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """(indptr, indices) of `num_edges` distinct RMAT edges over
    `num_nodes` nodes; `generator` lives on `device`."""
    scale = int(math.ceil(math.log2(max(num_nodes, 2))))
    keys = torch.empty(0, dtype=torch.int64, device=device)
    draw = int(num_edges * 1.25) + 1024
    while keys.numel() < num_edges:
        src = torch.zeros(draw, dtype=torch.int64, device=device)
        dst = torch.zeros(draw, dtype=torch.int64, device=device)
        for _ in range(scale):
            r = torch.rand(draw, generator=generator, device=device,
                           dtype=torch.float64)
            src_bit = (r >= a + b).to(torch.int64)
            dst_bit = (((r >= a) & (r < a + b)) | (r >= a + b + c)).to(
                torch.int64)
            src = (src << 1) | src_bit
            dst = (dst << 1) | dst_bit
        src %= num_nodes
        dst %= num_nodes
        keep = src != dst
        keys = torch.unique(torch.cat([keys, src[keep] * num_nodes
                                       + dst[keep]]))
        del src, dst, keep
    if keys.numel() > num_edges:
        pick = torch.randperm(keys.numel(), generator=generator,
                              device=device)[:num_edges]
        keys = torch.sort(keys[pick]).values
    src = keys // num_nodes
    indices = (keys % num_nodes).to(torch.int32)
    counts = torch.bincount(src, minlength=num_nodes)
    indptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return indptr.cpu().numpy(), indices.cpu().numpy()
