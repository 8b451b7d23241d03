# The GIDS data plane of the port: the host planes' window-buffered cache
# (software_cache.py) with its row store on the device, and the
# device-resident cache metadata and row store (cache_device.py,
# device_store.py), behind the tier stack (tiers.py) declared by a
# DataPlaneSpec (dataplane.py) and driven by the loader (pipeline.py) and
# its prefetch engine (prefetch.py); the tiered topology store
# (topology.py) behind the priced sampler.
from .accumulator import (AccumulatorConfig, DynamicAccessAccumulator,
                          MergedWindow, merge_window)
from .constant_buffer import ConstantBuffer
from .dataplane import (BuildContext, DataPlane, DataPlaneSpec, TierSpec,
                        register_tier_kind, tier)
from .feature_store import CoalescedReport, GatherReport, TieredFeatureStore
from .pipeline import Batch, BatchPlan, GIDSDataLoader, LoaderConfig
from .prefetch import PrefetchEngine, PrefetchStats
from .software_cache import CacheStats, WindowBufferedCache, run_trace
from .storage_sim import (INTEL_OPTANE, SAMSUNG_980PRO, SSDSpec,
                          StorageTimeline, simulate_burst)
from .tiers import DeviceCacheTier
from .topology import (TieredTopologyStore, TopologyGatherReport,
                       admission_names, host_sampling_time, make_admission)
