"""The PyTorch port's counterpart of quickstart.py: the GIDS dataloader and
every plane the quickstart drives, through `repro_torch`.

A synthetic power-law graph streams mini-batches through the `mmap`,
`bam`, `gids` and `gids-async` data planes; then sharded storage over 4
SSD queues, adaptive placement under a hot-set rotation, the topology
plane's priced sampling, online GNN serving of two tenants, the fault
plane's brownout recovery (loader and serve engine), the namespace
partitioned across 4 hosts, and 8 traced batches exported as a Chrome
trace (trace.json).  Every number it prints is the reference's priced
model time except the wall-clock column of the last section; the feature
rows of each batch are tensors on `--device`.

    PYTHONPATH=src python examples/quickstart_torch.py             # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

On a CUDA device the kernels are built from src/repro_torch/kernels/csrc at
first use (nvcc, sm_90a); `--device cpu` runs their plain PyTorch versions.
Without a card, the default raises.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (DataPlaneSpec, GIDSDataLoader, LoaderConfig,
                              SAMSUNG_980PRO)
from repro_torch.graph.synthetic import rmat_graph

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
DEVICE = resolve_device(ap.parse_args().device)

graph = rmat_graph(num_nodes=100_000, avg_degree=12, feature_dim=256,
                   seed=0)
features = np.random.default_rng(0).standard_normal(
    (graph.num_nodes, 256)).astype(np.float32)

print(f"graph: {graph.num_nodes:,} nodes, {graph.num_edges:,} edges, "
      f"features {features.nbytes/2**20:.0f} MiB")
print(f"registered data planes: {', '.join(DataPlaneSpec.names())}\n")

TRAIN_STEP_S = 2e-3          # pretend model compute, for the async overlap

for name in ("mmap", "bam", "gids", "gids-async"):
    spec = DataPlaneSpec.preset(name)
    loader = GIDSDataLoader(
        graph, features,
        LoaderConfig(batch_size=1024, fanouts=(10, 5), data_plane=spec,
                     cache_lines=8192, window_depth=8, cbuf_fraction=0.1),
        ssd=SAMSUNG_980PRO, device=DEVICE)
    prep, exposed = [], []
    for _ in range(10):
        # a prefetching plane (gids-async) stages the next batches ahead and
        # only prep in excess of the train step reaches the critical path
        batch = loader.next_batch(compute_s=TRAIN_STEP_S)
        prep.append(batch.prep_time_s)
        exposed.append(batch.exposed_prep_s)
    r = batch.report
    hit = loader.store.cache.stats.hit_ratio if loader.store.cache else 0.0
    tiers = " ".join(f"{t}={n}" for t, n in zip(r.tier_names, r.tier_counts))
    print(f"[{name:10s}] prep {np.mean(prep)*1e3:8.2f} ms/iter "
          f"(exposed {np.mean(exposed)*1e3:6.2f} ms) | "
          f"tier split {tiers} | cache hit {hit:.2f} | "
          f"lookahead depth {batch.merge_depth}")

print("\nfeatures gathered for the last batch:",
      tuple(batch.features.shape))

# -- sharded storage: the namespace striped across 4 SSD queues ---------------
# Same bytes, same blocks — only the storage pricing changes: each shard
# drains its own queue and the batch completes at the slowest one.  The
# degree-aware policy stripes hot high-degree nodes across shards so the
# power-law head never hammers a single queue.
for placement in ("hash", "degree"):
    loader = GIDSDataLoader(
        graph, features,
        LoaderConfig(batch_size=1024, fanouts=(10, 5),
                     data_plane="gids-sharded", n_shards=4,
                     placement=placement,
                     cache_lines=8192, window_depth=8, cbuf_fraction=0.1),
        ssd=SAMSUNG_980PRO, device=DEVICE)
    prep = [loader.next_batch().prep_time_s for _ in range(10)]
    r = loader.store.last_plan
    burst = loader.timeline.shard_burst
    print(f"[gids-sharded/{placement:6s}] prep {np.mean(prep)*1e3:6.2f} "
          f"ms/iter | rows/shard {r.shard_counts().tolist()} | "
          f"straggler shard {burst.straggler} "
          f"(imbalance {burst.imbalance:.3f})")

# -- adaptive placement: the telemetry loop, closed ---------------------------
# A hot-set rotation keyed to the static degree table (epoch e trains the
# nodes the degree deal put on shard e) is the adversarial drift: one queue
# drains while three idle.  With `placement="adaptive"` a TouchTable learns
# the measured touches, and when the priced saving beats the priced
# migration cost the rebalancer re-stripes the hot set — the cost amortized
# into subsequent batches, so the win below is net of the migration IOs.
from repro_torch.core import make_placement

small = rmat_graph(num_nodes=10_000, avg_degree=12, feature_dim=64, seed=1)
small_feats = np.random.default_rng(0).standard_normal(
    (small.num_nodes, 64)).astype(np.float32)
table = make_placement("degree", 4, degrees=np.diff(small.indptr)).table
hot_sets = [np.nonzero(table == s)[0] for s in range(4)]
print()
for placement in ("degree", "adaptive"):
    loader = GIDSDataLoader(small, small_feats, LoaderConfig(
        batch_size=256, fanouts=(2,), data_plane="gids-merged-sharded",
        cache_lines=512, window_depth=4, n_shards=4, placement=placement,
        seed=7, rebalance_interval=4, migration_horizon=64), device=DEVICE)
    prep, imb_trace = 0.0, []
    for epoch in range(2):
        loader.train_ids = hot_sets[epoch]
        for _ in range(32):
            prep += loader.next_batch().exposed_prep_s
            imb_trace.append(loader.timeline.shard_burst.imbalance)
    print(f"[rotation/{placement:8s}] exposed prep {prep*1e3:6.2f} ms "
          f"over 2 epochs | queue imbalance at epoch ends "
          f"{imb_trace[31]:.2f}, {imb_trace[63]:.2f}")
    if placement == "adaptive":
        for ev in loader.rebalancer.events:
            # settled imbalance: end of the epoch the migration landed in
            settled = imb_trace[min(((ev.burst - 1) // 32 + 1) * 32,
                                    len(imb_trace)) - 1]
            print(f"  migration @burst {ev.burst}: imbalance "
                  f"{ev.imbalance_before:.2f} before -> {settled:.2f} "
                  f"settled, {ev.n_moved} rows moved for "
                  f"{ev.cost_s*1e6:.0f} us (modelled saving "
                  f"{ev.predicted_saving_s*1e6:.1f} us/batch)")

# -- topology plane: sampling itself becomes a priced, tiered stage -----------
# `gids-topo` partitions the CSR adjacency into 4 KB edge pages placed by a
# degree-aware admission policy: GPU-resident hot adjacency, a pinned-host
# middle, and storage-backed CSR pages.  Blocks and features are
# bit-identical to `gids` with the same seed — but plan_next() is now priced
# like execute(): every hop reports its edge-page tier split and the
# modelled sampling time folds into prep/exposed prep.
loader = GIDSDataLoader(
    graph, features,
    LoaderConfig(batch_size=1024, fanouts=(10, 5), data_plane="gids-topo",
                 topo_gpu_fraction=0.25, topo_host_fraction=0.5,
                 cache_lines=8192, window_depth=8, cbuf_fraction=0.1),
    ssd=SAMSUNG_980PRO, device=DEVICE)
batch = loader.next_batch()
topo = loader.topo
print(f"\n[gids-topo] adjacency pages (hbm, host, storage) = "
      f"{topo.tier_pages()} | prep {batch.prep_time_s*1e6:.1f} us "
      f"(sampling {batch.sample_time_s*1e6:.1f} us of it)")
for r in batch.blocks.hop_reports:
    print(f"  hop {r.hop}: {r.n_edge_reads} edge reads -> "
          f"pages hbm={r.pages_by_tier[0]} host={r.pages_by_tier[1]} "
          f"storage={r.pages_by_tier[2]} "
          f"({r.n_storage_ios} coalesced IOs, "
          f"{r.coalesce_factor:.0f} reads/IO) | {r.time_s*1e6:.1f} us")

# -- serve plane: the same data plane, online ---------------------------------
# Two tenants (one steady, one bursty MMPP) fire requests at a shared
# GNNServeEngine.  Admission forms deadline-bounded windows — a window
# closes when the oldest request's SLO slack is spent — and each window is
# one merged gather (cross-request dedup + 4KB-line coalescing) plus one
# batched forward.  The `serve-gnn` plane partitions the cache per tenant,
# so the bursty tenant cannot evict the steady tenant's hot set.
from repro_torch.serve import GNNServeConfig, GNNServeEngine, TenantSpec, \
    generate_stream

tenants = (
    TenantSpec("steady", hot_fraction=0.03, hot_prob=0.9, mean_seeds=4),
    TenantSpec("bursty", hot_fraction=0.5, hot_prob=0.2, mean_seeds=8,
               arrival="mmpp", burst_factor=8.0, burst_fraction=0.1),
)
stream = generate_stream(graph.num_nodes, tenants, offered_qps=8_000,
                         n_requests=300, seed=11)
engine = GNNServeEngine(graph, features, GNNServeConfig(
    tenants=2, cache_lines=8192, seed=3), device=DEVICE)
res = engine.run(stream)
bd = res.mean_breakdown_s()
print(f"\n[serve-gnn] offered {res.offered_qps():,.0f} qps -> goodput "
      f"{res.goodput_qps():,.0f} qps | p50 {res.p50_s()*1e6:.0f} us "
      f"p99 {res.p99_s()*1e6:.0f} us | mean window {res.mean_window:.1f}")
print(f"  latency breakdown: wait {bd['queue_wait_s']*1e6:.0f} us, "
      f"sample {bd['sample_s']*1e6:.0f} us, "
      f"gather {bd['gather_s']*1e6:.0f} us, "
      f"forward {bd['forward_s']*1e6:.0f} us")
for t, spec in enumerate(tenants):
    print(f"  tenant {spec.name:6s}: p99 {res.p99_s(tenant=t)*1e6:6.0f} us "
          f"| cache hit {engine._tenant_tier.hit_ratio(t):.2f}")

# -- fault plane: detection -> hedge -> failover -> drain ---------------------
# A seeded FaultSchedule keys faults to the loader's priced-burst index:
# here shard 2 of 4 browns out 25x for 40 bursts.  The unreplicated plane
# eats the straggler queue; with 2-way chained declustering the injector
# hedges the straggler's residual onto the replica, the health monitor
# flags the queue from its priced per-row drains, plan-time failover
# routes fresh lines away, and the adaptive rebalancer emits a priced
# "drain" migration off the sick shard.  Data is bit-identical either
# way — faults perturb timing and routing, never bytes.
from repro_torch.core import BrownoutEvent, FaultSchedule

chaos = FaultSchedule(events=(
    BrownoutEvent(shard=2, start=0, end=40, multiplier=25.0),))
runs = {}
for mode, extra in (("naive", dict(placement="degree")),
                    ("hedged", dict(placement="adaptive",
                                    replication_factor=2,
                                    rebalance_interval=4,
                                    migration_horizon=64))):
    loader = GIDSDataLoader(small, small_feats, LoaderConfig(
        batch_size=256, fanouts=(2,), data_plane="gids-merged-sharded",
        cache_lines=512, window_depth=4, n_shards=4, seed=7,
        fault_schedule=chaos, **extra), device=DEVICE)
    runs[mode] = (sum(loader.next_batch().exposed_prep_s
                      for _ in range(48)), loader)

t_naive, t_hedged = runs["naive"][0], runs["hedged"][0]
hl = runs["hedged"][1]
inj, router = hl.fault_injector, hl.store.tiers[-1].router
print(f"\n[faults/brownout] shard 2 browns out 25x: exposed prep "
      f"{t_naive*1e3:.2f} ms naive -> {t_hedged*1e3:.2f} ms hedged "
      f"({t_naive/t_hedged:.2f}x recovered)")
print(f"  recovery timeline: hedge fires @burst {inj.first_hedge_burst} "
      f"({inj.n_hedged_bursts} bursts, {inj.hedge_saving_s*1e6:.0f} us "
      f"saved) | monitor flags @burst {hl.health.first_flag_burst} | "
      f"failover reroutes @burst {router.first_reroute_burst} "
      f"({router.n_rerouted} lines)")
for ev in hl.rebalancer.events:
    if ev.reason == "drain":
        print(f"  drain @burst {ev.burst}: {ev.n_moved} rows off shard 2 "
              f"for {ev.cost_s*1e6:.0f} us")

# -- serve plane under brownout: degrade, don't die ---------------------------
# The same schedule axis plugs into the online engine.  A persistent 10x
# brownout on one serve shard would triple the victim p99; with
# `brownout=True` the BrownoutController watches per-row gather pressure
# and climbs a priced ladder — shrink fanouts, serve recently-gathered
# neighborhoods stale (same bytes, zero burst), shed as a last resort —
# holding p99 near fault-free at a small, accounted-for shed fraction.
wide_feats = np.random.default_rng(0).standard_normal(
    (small.num_nodes, 512)).astype(np.float32)
reqs = list(generate_stream(
    small.num_nodes,
    [TenantSpec(name="t0", deadline_s=3e-3, mean_seeds=8)],
    offered_qps=500, n_requests=150, seed=3))
sick = FaultSchedule(events=(
    BrownoutEvent(shard=0, start=3, end=10_000, multiplier=10.0),))
out = {}
for mode, kw in (("fault-free", {}), ("naive", dict(fault_schedule=sick)),
                 ("controlled", dict(fault_schedule=sick, brownout=True))):
    eng = GNNServeEngine(small, wide_feats, GNNServeConfig(
        seed=5, cache_lines=256, **kw), device=DEVICE)
    out[mode] = (eng.run(reqs), eng)
free_p99 = out["fault-free"][0].p99_s()
print()
for mode in ("fault-free", "naive", "controlled"):
    res, eng = out[mode]
    line = (f"[serve/{mode:10s}] p99 {res.p99_s()*1e3:5.2f} ms "
            f"({res.p99_s()/free_p99:.2f}x fault-free) | attainment "
            f"{res.attainment():.2f}")
    if mode == "controlled":
        line += (f" | shed {res.shed_fraction:.2f} "
                 f"(stale-served {res.n_stale_served}, "
                 f"degraded {res.n_degraded}) | ladder "
                 f"{[lv for _, lv in eng.brownout.level_trace]}")
    print(line)

# -- distributed plane: the namespace partitioned across 4 hosts --------------
# Each shard is now a HOST (NIC link + RTT + its own SSD).  Rows owned by
# the host that samples them drain locally; the rest pay a link transit,
# and the batch completes at the slowest host.  Placement is the whole
# game: hash striping scatters every community across the cluster (~75%
# of sampled edges cross hosts), while `metis-lite` grows
# degree-mass-balanced partitions along the community structure and
# co-partitioning puts each node's adjacency pages on the same host as
# its feature rows — most traffic never touches the interconnect.  Bytes
# are bit-identical either way; only modelled time and telemetry move.
from repro_torch.graph.synthetic import clustered_graph

cg = clustered_graph(20_000, 12, 64, communities=32, intra=0.9, seed=1)
cg_feats = np.random.default_rng(0).standard_normal(
    (cg.num_nodes, 64)).astype(np.float32)
print(f"\n[hosts] {cg.num_nodes:,}-node community graph on 4 hosts "
      f"(100GbE links, one NVMe each)")
for placement, co in (("hash", False), ("metis-lite", True)):
    loader = GIDSDataLoader(cg, cg_feats, LoaderConfig(
        batch_size=256, fanouts=(6, 4), data_plane="gids-hosts-merged",
        n_hosts=4, placement=placement, co_partition=co,
        cache_lines=256, window_depth=4, seed=3), ssd=SAMSUNG_980PRO,
        device=DEVICE)
    prep = [loader.next_batch().exposed_prep_s for _ in range(10)]
    tier = loader.plane.store.tiers[-1]
    burst = loader.timeline.shard_burst
    rows = loader.store.last_plan.shard_counts().tolist()
    mode = "co-partitioned" if co else "independent topo"
    print(f"[gids-hosts/{placement:10s}] exposed prep "
          f"{np.mean(prep)*1e6:6.1f} us ({mode}) | "
          f"cut edges {tier.cut_edge_fraction():.2f} | "
          f"remote rows {tier.remote_fraction():.2f}")
    print(f"  per-host rows {rows} | remote lines over the wire "
          f"{list(burst.remote_lines)} | straggler host "
          f"{burst.straggler} (imbalance {burst.imbalance:.2f})")

# -- observability plane: the whole pipeline as a span tree -------------------
# Pass a Tracer and every priced stage becomes a nested span — plan_next
# (per-hop sampling, edge-page reads), execute (merged gather, per-shard
# storage drains, fault recovery sub-events) — in both virtual (priced)
# and wall-clock time, with a MetricsRegistry accumulating counters/
# histograms alongside.  On the wall-clock track the loader's own hot
# path nests under plan_next and execute_window (category "hot_path":
# sampling, admits, the window's merge, the gather with one probe per
# tier, the reports, pricing, feedback); the file's otherData gives the
# time.perf_counter base of that track.  Tracing is bit-invisible: the
# traced loader below prices the exact same floats as the untraced ones
# above.  The export is Chrome trace-event JSON — open trace.json in
# https://ui.perfetto.dev and every batch, window, shard, and hop is a
# track you can scrub.
from repro_torch.obs import Tracer

tracer = Tracer()
loader = GIDSDataLoader(cg, cg_feats, LoaderConfig(
    batch_size=256, fanouts=(6, 4), data_plane="gids-hosts-merged",
    n_hosts=4, placement="metis-lite", co_partition=True,
    cache_lines=256, window_depth=4, seed=3),
    ssd=SAMSUNG_980PRO, tracer=tracer, device=DEVICE)
for _ in range(8):
    loader.next_batch()
tracer.write("trace.json")

spans = sorted(
    ((sp.name, sp.dur, sp.args) for root in tracer.roots()
     for sp in root.walk() if sp.dur),
    key=lambda s: -s[1])
print(f"\n[obs] 8 traced batches -> trace.json "
      f"({len(tracer.chrome_events())} events; load in ui.perfetto.dev)")
print("  top-3 spans by priced time:")
for name, dur, args in spans[:3]:
    tags = " ".join(f"{k}={v}" for k, v in sorted(args.items())
                    if isinstance(v, (int, str)))
    print(f"    {name:14s} {dur*1e6:8.2f} us  {tags}")
print("  modelled vs measured, per stage (virtual clock vs wall clock):")
m = tracer.metrics
for name in m.names():
    if not name.startswith("modelled_vs_measured."):
        continue
    pts = m.series(name).points
    modelled = sum(p["modelled_s"] for p in pts)
    measured = sum(p["measured_s"] for p in pts)
    print(f"    {name.split('.', 1)[1]:14s} modelled {modelled*1e6:8.2f} us"
          f" | simulated in {measured*1e6:8.2f} us wall"
          f" ({len(pts)} spans)")
