"""Dataset registry, the port's copy of `repro.graph.datasets`: the paper's
Tables 2 and 3 with their true row counts, each materialised here as an
RMAT stand-in of `exec_nodes` nodes with the same average degree.

Byte and request projections use the true counts; execution uses the
scaled graph.
"""
from __future__ import annotations

import dataclasses
import functools

from .csr import CSRGraph
from .synthetic import rmat_graph


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_nodes: int
    num_edges: int
    feature_dim: int
    heterogeneous: bool = False
    feature_dtype_bytes: int = 4
    # execution scale: nodes actually instantiated when materialised here
    exec_nodes: int = 0

    @property
    def feature_bytes(self) -> int:
        return self.num_nodes * self.feature_dim * self.feature_dtype_bytes

    @property
    def avg_degree(self) -> int:
        return max(1, self.num_edges // max(1, self.num_nodes))

    def materialize(self, seed: int = 0) -> CSRGraph:
        n = self.exec_nodes or self.num_nodes
        return rmat_graph(n, self.avg_degree, self.feature_dim, seed=seed,
                          name=self.name)


# ---- paper Table 2 (real-world) -------------------------------------------
OGBN_PAPERS100M = DatasetSpec("ogbn-papers100M", 111_059_956, 1_615_685_872,
                              128, exec_nodes=200_000)
IGB_FULL = DatasetSpec("IGB-Full", 269_364_174, 3_995_777_033, 1024,
                       exec_nodes=200_000)
MAG240M = DatasetSpec("MAG240M", 244_160_499, 1_728_364_232, 768,
                      heterogeneous=True, exec_nodes=200_000)
IGBH_FULL = DatasetSpec("IGBH-Full", 547_306_935, 5_812_005_639, 1024,
                        heterogeneous=True, exec_nodes=200_000)

# ---- paper Table 3 (micro-benchmarks) --------------------------------------
IGB_TINY = DatasetSpec("IGB-tiny", 100_000, 547_416, 1024,
                       exec_nodes=100_000)
IGB_SMALL = DatasetSpec("IGB-small", 1_000_000, 12_070_502, 1024,
                        exec_nodes=250_000)
IGB_MEDIUM = DatasetSpec("IGB-medium", 10_000_000, 120_077_694, 1024,
                         exec_nodes=500_000)
IGB_LARGE = DatasetSpec("IGB-large", 100_000_000, 1_223_571_364, 1024,
                        exec_nodes=500_000)

REGISTRY = {d.name: d for d in [
    OGBN_PAPERS100M, IGB_FULL, MAG240M, IGBH_FULL,
    IGB_TINY, IGB_SMALL, IGB_MEDIUM, IGB_LARGE,
]}


@functools.lru_cache(maxsize=8)
def load(name: str, seed: int = 0) -> CSRGraph:
    return REGISTRY[name].materialize(seed)
