"""The readers of the device tier's host stages (`future_counts`,
`probe_wait`) and of the loader's `execute` less them, on windows built by
hand; and, on the card, the tier filling both keys on every probe."""
import numpy as np
import pytest

from bench import cell as cell_run
from bench import spec, trace

STAGES = ("future_counts", "stage_host", "probe_wait")
METRICS = ("future_counts.ms_per_step", "probe_wait.ms_per_step",
           "execute_rest.ms_per_step")


def _window(splits, executes=None) -> cell_run.Window:
    """A window of one step per split, t0 0 and t1 100; `executes` are the
    (start, end) of the host spans around `execute`, in seconds."""
    spans = trace.Spans(True)
    for s, e in executes or ():
        spans.records.append(("execute", s, e))
        spans.records.append(("plan_next", e, e + 0.01))
    steps = [cell_run.Step(wall_s=1.0, seeds=1024, staged_rows=10,
                           split_ms=dict(sp)) for sp in splits]
    return cell_run.Window(config={}, traffic={}, t0=0.0, t1=100.0,
                           steps=steps, spans=spans, device_trace=None,
                           cache_hits=None, cache_misses=None)


def _split(fc, stage, wait):
    return {"future_counts": fc, "stage_host": stage, "h2d": 7.5,
            "cache_access": 0.1, "gather": 0.1, "fill": 0.1,
            "probe_wait": wait}


SPLITS = [_split(120.0, 18.0, 8.0), _split(100.0, 20.0, 9.0),
          _split(110.0, 16.0, 7.0)]
#: execute spans of 160, 150 and 140 ms, and one that ends past t1
EXECUTES = [(1.0, 1.16), (2.0, 2.15), (3.0, 3.14), (99.95, 100.2)]


@pytest.fixture(scope="module")
def readers():
    return {m: spec.load_reader(m) for m in METRICS}


def test_readers_give_the_means_and_the_execute_remainder(readers):
    w = _window(SPLITS, EXECUTES)
    assert readers["future_counts.ms_per_step"](w) == pytest.approx(110.0)
    assert readers["probe_wait.ms_per_step"](w) == pytest.approx(8.0)
    # execute 450 ms over 3 steps (the span past t1 is not the window's),
    # less the mean of the three stages, 110 + 18 + 8
    assert readers["execute_rest.ms_per_step"](w) == pytest.approx(
        150.0 - 136.0)


@pytest.mark.parametrize("missing", STAGES)
def test_a_step_without_its_keys_reads_nothing(readers, missing):
    """The parent's device tier fills neither new key: its readings are
    None, not a mean over some steps."""
    splits = [dict(s) for s in SPLITS]
    del splits[1][missing]
    w = _window(splits, EXECUTES)
    assert readers["execute_rest.ms_per_step"](w) is None
    for m in ("future_counts", "probe_wait"):
        got = readers[f"{m}.ms_per_step"](w)
        assert (got is None) == (m == missing)
    parent = [{k: v for k, v in s.items() if k not in ("future_counts",
                                                       "probe_wait")}
              for s in SPLITS]
    assert all(r(_window(parent, EXECUTES)) is None
               for r in readers.values())


def test_no_spans_or_no_steps_read_nothing(readers):
    # an untraced run keeps no spans; a CPU run fills no split
    assert readers["execute_rest.ms_per_step"](_window(SPLITS)) is None
    no_execute = _window(SPLITS)
    no_execute.spans.records.append(("plan_next", 1.0, 1.1))
    assert readers["execute_rest.ms_per_step"](no_execute) is None
    for r in readers.values():
        assert r(_window([{}, {}], EXECUTES)) is None
        assert r(_window([], EXECUTES)) is None


@pytest.mark.chip
def test_device_tier_fills_the_new_keys_on_every_probe(cuda_device):
    """A tiny `gids-device` loader on the card: every probe's split holds
    `future_counts` and `probe_wait` beside the keys it always had, each a
    time."""
    from repro_torch.core import GIDSDataLoader, LoaderConfig
    from repro_torch.graph.synthetic import rmat_graph

    g = rmat_graph(4000, 12, 64, seed=7)
    feats = np.random.default_rng(3).standard_normal(
        (g.num_nodes, 64)).astype(np.float32)
    loader = GIDSDataLoader(g, feats, LoaderConfig(
        batch_size=256, fanouts=(5, 5), data_plane="gids-device",
        cache_lines=1024, window_depth=4), device=cuda_device)
    tier = loader.store.tiers[0]
    probe_rows, splits = tier._probe_rows, []

    def recorded(*args, **kwargs):
        hits = probe_rows(*args, **kwargs)
        splits.append(dict(tier.last_split_ms))
        return hits
    tier._probe_rows = recorded
    for _ in range(6):
        loader.next_batch()
    assert len(splits) == 6
    for split in splits:
        assert set(split) == {"future_counts", "stage_host", "h2d",
                              "cache_access", "gather", "fill", "probe_wait"}
        assert all(v >= 0.0 for v in split.values())
