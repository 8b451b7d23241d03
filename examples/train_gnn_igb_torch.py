"""The PyTorch port's counterpart of train_gnn_igb.py: train a GraphSAGE on
an IGB-style synthetic graph through the port's GIDS data loader.  The
default plane is `gids-async`: the window cache's metadata on the host, its
rows on the GPU, and the prefetch engine overlapping each batch's prep
with the measured train step.  `--plane gids-device` keeps the cache
metadata and the cache access on the GPU too.

The defaults are the reference example's full width: 100k nodes, 1024-d
features, hidden 4096 (about 42M parameters), batch 512, fanouts (10, 5).

A `StepWatchdog` times every step and prints the stragglers; with
`--ckpt-dir` the parameters (in the reference's layout) and the loader's
resume point are checkpointed every 100 steps, in the format the JAX
package's `repro.train.checkpoint` reads.

    PYTHONPATH=src python examples/train_gnn_igb_torch.py --steps 300
    PYTHONPATH=src python examples/train_gnn_igb_torch.py --steps 300 \
        --ckpt-dir /path/to/ckpts
    PYTHONPATH=src python examples/train_gnn_igb_torch.py --device cpu \
        --steps 3 --nodes 5000 --feature-dim 64 --hidden 64 --batch 64

On a CUDA device the kernels are built from src/repro_torch/kernels/csrc at
first use (nvcc, sm_90a).  `--device cpu` runs their plain PyTorch versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import INTEL_OPTANE, GIDSDataLoader, LoaderConfig
from repro_torch.graph.synthetic import rmat_graph
from repro_torch.models.gnn import GNN, GNNConfig, hop_indices, sgd_step
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault_tolerance import StepWatchdog, WatchdogConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--feature-dim", type=int, default=1024)
    ap.add_argument("--hidden", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--plane", default="gids-async",
                    help="data-plane preset (gids-async overlaps prep with "
                         "the measured train step)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rng = np.random.default_rng(0)
    graph = rmat_graph(args.nodes, 12, args.feature_dim, seed=0,
                       name="igb-synthetic")
    n_classes = 47                     # IGB label space
    labels_all = rng.integers(0, n_classes, graph.num_nodes)
    feats = (np.eye(n_classes, args.feature_dim)[labels_all] * 2.0
             + 0.5 * rng.standard_normal(
                 (graph.num_nodes, args.feature_dim))).astype(np.float32)

    cfg = GNNConfig(model="sage", in_dim=args.feature_dim,
                    hidden_dim=args.hidden, num_classes=n_classes,
                    fanouts=(10, 5))
    gnn = GNN(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in gnn.parameters())
    print(f"GraphSAGE params: {n_params/1e6:.1f}M "
          f"(hidden {args.hidden}, features {args.feature_dim}) on {dev}")

    loader = GIDSDataLoader(
        graph, feats,
        LoaderConfig(batch_size=args.batch, fanouts=cfg.fanouts,
                     data_plane=args.plane, cache_lines=1 << 14,
                     window_depth=8, cbuf_fraction=0.1),
        ssd=INTEL_OPTANE, device=dev)
    labels_dev = torch.from_numpy(labels_all).to(dev)

    def hit_ratio() -> float:
        if loader.store.cache is not None:          # the host planes' cache
            return loader.store.cache.stats.hit_ratio
        top = loader.store.tiers[0]
        if not hasattr(top, "store"):                # no cache on this plane
            return 0.0
        hits, misses = int(top.store.cache.hits), int(top.store.cache.misses)
        return hits / max(hits + misses, 1)

    t0 = time.time()
    losses, prep_times, exposed_times = [], [], []
    last_step_s = 0.0     # measured compute the prefetch overlapped with
    watchdog = StepWatchdog(WatchdogConfig(checkpoint_every=100))
    for it in range(args.steps):
        watchdog.start_step(it)
        b = loader.next_batch(compute_s=last_step_s)
        hi = [torch.from_numpy(i).to(dev) for i in hop_indices(b.blocks)]
        y = labels_dev[torch.from_numpy(b.blocks.seeds).to(dev)]
        ts = time.perf_counter()
        losses.append(sgd_step(gnn, b.features, hi, y, args.lr).item())
        if it > 0:       # step 0 pays the first kernel builds and launches
            last_step_s = time.perf_counter() - ts   # .item() synchronised
        if watchdog.end_step():
            print(f"iter {it:4d} STRAGGLER: step took "
                  f"{watchdog.flagged[-1][1]*1e3:.1f} ms "
                  f"(median {watchdog.median_step_s*1e3:.1f} ms)")
        prep_times.append(b.prep_time_s)
        exposed_times.append(b.exposed_prep_s)
        if it % 25 == 0 or it == args.steps - 1:
            print(f"iter {it:4d} loss {losses[-1]:.4f} "
                  f"prep {np.mean(prep_times[-25:])*1e3:.2f} ms "
                  f"(exposed {np.mean(exposed_times[-25:])*1e3:.2f} ms, "
                  f"priced) cache_hit {hit_ratio():.2f} "
                  f"redirect {loader.accumulator.redirect_rate:.2f}")
        if args.ckpt_dir and watchdog.should_checkpoint(it):
            ckpt_lib.save(args.ckpt_dir, it, gnn.param_tree(),
                          {"loader": loader.state_dict()})

    print(f"\n{args.steps} steps in {time.time()-t0:.1f}s | "
          f"loss {np.mean(losses[:10]):.3f} -> {np.mean(losses[-10:]):.3f} | "
          f"{len(watchdog.flagged)} straggler steps")


if __name__ == "__main__":
    main()
