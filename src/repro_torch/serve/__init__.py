# Token-level LM serving (engine.py) over the KV slot pool tier.  The GNN
# serve engine, its workloads and admission control wait for ROADMAP.md
# Queue 1 item 9.
from repro_torch.core.tiers import KVSlotTier
from .engine import EngineConfig, EngineNotDrained, Request, ServeEngine

__all__ = ["EngineConfig", "EngineNotDrained", "KVSlotTier", "Request",
           "ServeEngine"]
