# Online serving of the port: token-level LM serving (engine.py) over the
# KV slot pool tier, and multi-tenant GNN inference (gnn_engine.py) over
# the shared data plane, with its request streams (workload.py) and
# deadline-bounded admission (admission.py).
from repro_torch.core.tiers import KVSlotTier, TenantCacheTier
from .admission import SLOBatcher, WindowDecision
from .engine import EngineConfig, EngineNotDrained, Request, ServeEngine
from .gnn_engine import (BrownoutController, GNNServeConfig, GNNServeEngine,
                         RequestRecord, ServeResult, WindowTrace)
from .workload import (ServeRequest, TenantSpec, generate_stream,
                       mmpp_arrivals, poisson_arrivals, tenant_hot_set)

__all__ = [
    "BrownoutController",
    "EngineConfig", "EngineNotDrained", "GNNServeConfig", "GNNServeEngine",
    "KVSlotTier", "Request", "RequestRecord", "SLOBatcher", "ServeEngine",
    "ServeRequest", "ServeResult", "TenantCacheTier", "TenantSpec",
    "WindowDecision", "WindowTrace", "generate_stream", "mmpp_arrivals",
    "poisson_arrivals", "tenant_hot_set",
]
