"""The fig13 and fig14 priced headline keys recorded in BENCH_pr10.json,
computed through the port on the CPU: the same loaders as
benchmarks/fig13_e2e.py `headline()` (synthetic 20k-node stand-in, Samsung
980 Pro, 24 iterations, warm-up 8, a fixed modelled train step of 5 ms,
the priced row width set to 64 after the build) and
benchmarks/fig14_overlap.py `headline()`.  Every key must be equal, not
close: each is a priced float of the storage model."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.core import (SAMSUNG_980PRO, GIDSDataLoader,  # noqa: E402
                              LoaderConfig)
from repro_torch.graph.datasets import DatasetSpec  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402

BENCH = json.loads((Path(__file__).resolve().parents[1]
                    / "BENCH_pr10.json").read_text())
T_TRAIN, ITERS, WARMUP = 0.005, 24, 8
PLANES = ("mmap", "bam", "gids", "gids-async", "gids-merged")


@pytest.fixture(scope="module")
def fig13():
    ds = DatasetSpec("smoke", 20_000, 240_000, 64, exec_nodes=20_000)
    out = {}
    for m in PLANES:
        g = ds.materialize()
        dl = GIDSDataLoader(
            g, np.zeros((g.num_nodes, 1), np.float32),
            LoaderConfig(batch_size=512, fanouts=(10, 5), data_plane=m,
                         cache_lines=1 << 13, window_depth=8,
                         cbuf_fraction=0.1 if m.startswith("gids") else 0.0),
            ssd=SAMSUNG_980PRO, device="cpu")
        dl.store.feature_dim = ds.feature_dim     # priced width, not staged
        preps = []
        for _ in range(ITERS):
            b = dl.next_batch(compute_s=T_TRAIN)
            preps.append(b.exposed_prep_s)
        out[f"{m}_exposed_prep_us"] = float(np.mean(preps[WARMUP:])) * 1e6
        out[f"{m}_e2e_s"] = float(np.mean(preps[WARMUP:])) + T_TRAIN
    rep = b.report                    # the last gids-merged batch
    out.update(merged_window_batches=rep.window_batches,
               merged_window_requests=rep.window_requests,
               merged_unique_rows=rep.n_unique,
               merged_duplicate_rows_eliminated=rep.n_duplicate,
               merged_dedup_factor=rep.dedup_factor,
               merged_storage_unique_rows=rep.n_storage_unique,
               merged_coalesced_ios=rep.n_storage_lines,
               merged_coalesce_factor=rep.coalesce_factor)
    return out


@pytest.mark.parametrize("key", [
    *(f"{m}_exposed_prep_us" for m in PLANES),
    *(f"{m}_e2e_s" for m in PLANES),
    "merged_window_batches", "merged_window_requests", "merged_unique_rows",
    "merged_duplicate_rows_eliminated", "merged_dedup_factor",
    "merged_storage_unique_rows", "merged_coalesced_ios",
    "merged_coalesce_factor"])
def test_fig13_headline_key(fig13, key):
    assert fig13[key] == BENCH["fig13_e2e"][key]


def test_fig14_raw_and_overlapped_prep():
    """fig14's raw prep (the synchronous gids plane's mean over batches
    2-11) and the gids-async plane's exposed prep at twice that compute."""
    g = rmat_graph(20_000, 12, 32, seed=1)
    feats = np.zeros((g.num_nodes, 32), np.float32)

    def run(plane, compute_s):
        dl = GIDSDataLoader(g, feats, LoaderConfig(
            batch_size=256, fanouts=(5, 5), data_plane=plane,
            cache_lines=4096, window_depth=4, seed=3), device="cpu")
        return [dl.next_batch(compute_s=compute_s) for _ in range(12)]

    sync = run("gids", 0.0)
    raw = float(np.mean([b.prep_time_s for b in sync[2:]]))
    assert raw * 1e6 == BENCH["fig14_overlap"]["raw_prep_us"]
    fast = run("gids-async", 2.0 * raw)
    exposed = float(np.mean([b.exposed_prep_s for b in fast[2:]]))
    assert exposed * 1e6 == BENCH["fig14_overlap"][
        "exposed_prep_us_at_2x_compute"]
    for a, b in zip(sync, fast, strict=True):
        assert a.report == b.report and a.prep_time_s == b.prep_time_s
