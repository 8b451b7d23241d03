# The GIDS data plane of the port: the host planes' window-buffered cache
# (software_cache.py) with its row store on the device, and the
# device-resident cache metadata and row store (cache_device.py,
# device_store.py), behind the tier stack (tiers.py) declared by a
# DataPlaneSpec (dataplane.py) and driven by the loader (pipeline.py) and
# its prefetch engine (prefetch.py); the tiered topology store
# (topology.py) behind the priced sampler; the sharded and cluster
# namespaces (sharding.py, hosts.py), the fault plane (faults.py) and the
# feedback controllers (feedback.py), the serve plane's tenant cache and
# quota controller, and the deadline-bounded serving window policy.
from .accumulator import (AccumulatorConfig, DeadlineWindowConfig,
                          DeadlineWindowPolicy, DynamicAccessAccumulator,
                          MergedWindow, merge_window)
from .constant_buffer import ConstantBuffer
from .dataplane import (BuildContext, DataPlane, DataPlaneSpec, TierSpec,
                        register_tier_kind, tier)
from .faults import (BrownoutEvent, FailoverRouter, FaultInjector,
                     FaultSchedule, FaultedBurstResult, FlakyReadsEvent,
                     HedgePolicy, OutageEvent, RetryPolicy)
from .feature_store import (CoalescedReport, FeatureStore, GatherReport,
                            TieredFeatureStore)
from .feedback import (AmortizedCost, MigrationEvent, QuotaController,
                       RefreshEvent, ShardHealthMonitor, ShardRebalancer,
                       TopologyRefresher, TouchTable)
from .hosts import (NIC_100GBE, NIC_400GBE, TPU_ICI, CoPartitionedPlacement,
                    HostLinkSpec, HostShardTier, cut_edge_fraction,
                    default_hosts, requester_hosts)
from .pipeline import Batch, BatchPlan, GIDSDataLoader, LoaderConfig
from .prefetch import PrefetchEngine, PrefetchStats
from .sharding import (AdaptivePlacement, MetisLitePlacement,
                       PlacementPolicy, ReplicatedPlacement, make_placement,
                       placement_names, register_placement)
from .software_cache import CacheStats, WindowBufferedCache, run_trace
from .storage_sim import (INTEL_OPTANE, SAMSUNG_980PRO, HostBurstResult,
                          SSDSpec, ShardedBurstResult, StorageTimeline,
                          coalesce_lines, coalesce_lines_by_shard,
                          model_burst, price_sharded_burst,
                          required_accesses, simulate_burst)
from .tiers import (ConstantBufferTier, DeviceCacheTier, GatherPlan,
                    KVSlotTier, ShardedStorageTier, StorageTier,
                    TenantCacheTier, Tier, build_plan, record_tier_metrics)
from .topology import (TieredTopologyStore, TopologyGatherReport,
                       admission_names, host_sampling_time, make_admission,
                       register_admission)
