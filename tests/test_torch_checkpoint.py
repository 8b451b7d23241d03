"""The port's checkpointing and fault-tolerance runtime
(repro_torch.train.checkpoint, repro_torch.train.fault_tolerance) beside
the JAX package's: twins of the reference's roundtrip, atomic-commit,
retention, corrupt-.tmp, restart and watchdog tests; the on-disk format
byte for byte; and the GNN's parameters restored across the packages."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import typing  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import GIDSDataLoader as JLoader  # noqa: E402
from repro.core import LoaderConfig as JConfig  # noqa: E402
from repro.graph.synthetic import rmat_graph as jrmat  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.core import GIDSDataLoader, LoaderConfig  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402
from repro_torch.models.gnn import GNN, GNNConfig, hop_indices  # noqa: E402
from repro_torch.sampling.neighbor import host_sample_blocks  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.fault_tolerance import (StepWatchdog,  # noqa: E402
                                               WatchdogConfig,
                                               run_with_restarts)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((8, 16)).astype(np.float32),
            rng.standard_normal(16).astype(np.float32))


def _tree(seed=0):
    """The reference test's tree in torch: f32 matrix, bf16 vector, int32
    scalar."""
    w, b = _arrays(seed)
    return {"layer": {"w": torch.from_numpy(w),
                      "b": torch.from_numpy(b).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _jtree(seed=0):
    w, b = _arrays(seed)
    return {"layer": {"w": jnp.asarray(w, jnp.float32),
                      "b": jnp.asarray(b, jnp.bfloat16)},
            "step": jnp.asarray(7, jnp.int32)}


def _leaves(tree):
    return list(ckpt._flatten(tree).values())


# -- twins of tests/test_checkpoint.py --------------------------------------------

def test_roundtrip_bitwise(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 10, tree, {"note": "x"})
    like = {"layer": {k: torch.zeros_like(v)
                      for k, v in tree["layer"].items()},
            "step": torch.zeros_like(tree["step"])}
    restored, extra = ckpt.restore(tmp_path, 10, like)
    assert extra == {"note": "x"}
    for a, b in zip(_leaves(tree), _leaves(restored), strict=True):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_atomic_commit_no_tmp_left(tmp_path):
    ckpt.save(tmp_path, 3, _tree())
    assert not list(tmp_path.glob("*.tmp"))
    assert (tmp_path / "step_00000003" / "manifest.json").exists()


def test_latest_and_retention(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, _tree(s))
    assert ckpt.latest_step(tmp_path) == 5
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(kept) == 3                     # keep last 3
    assert kept[-1] == "step_00000005"


def test_corrupt_tmp_is_ignored(tmp_path):
    ckpt.save(tmp_path, 9, _tree())
    # a crashed writer leaves a .tmp dir behind: it must not be visible
    (tmp_path / "step_00000011.tmp").mkdir()
    assert ckpt.latest_step(tmp_path) == 9


def test_run_with_restarts_reaches_target(tmp_path):
    calls = {"made": 0}

    def make_state(restore_step):
        calls["made"] += 1
        if restore_step is None:
            return torch.zeros(()), 0
        restored, _ = ckpt.restore(tmp_path, restore_step, torch.zeros(()))
        return restored, restore_step

    def train_one(state, step):
        return state + 1.0

    final, steps = run_with_restarts(make_state, train_one, 20,
                                     ckpt_dir=tmp_path, save_every=5,
                                     inject_failure_at=12)
    assert steps == 20
    assert float(final) == 20.0
    assert calls["made"] == 2                 # initial + one restart


def test_restore_onto_a_mesh_places_the_leaves(tmp_path):
    """`shardings=` (ROADMAP.md Queue 1 item 11) places a leaf on the host
    mesh as a DTensor; a None sharding restores its leaf as without."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import NamedSharding, P, make_host_mesh
    tree = _tree()
    ckpt.save(tmp_path, 1, tree)
    try:
        got, _ = ckpt.restore(tmp_path, 1, tree, shardings={
            "layer": None,
            "step": NamedSharding(make_host_mesh("cpu"), P())})
        assert isinstance(got["step"], DTensor)
        assert torch.equal(got["step"].to_local(), tree["step"])
        for k, v in tree["layer"].items():
            assert not isinstance(got["layer"][k], DTensor)
            assert torch.equal(got["layer"][k], v)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_restore_takes_the_like_leaf_dtype(tmp_path):
    """Each leaf comes back in its `like` leaf's dtype (and device)."""
    tree = _tree()
    ckpt.save(tmp_path, 2, tree)
    like = {"layer": {"w": torch.zeros(8, 16, dtype=torch.float64),
                      "b": torch.zeros(16, dtype=torch.float32)},
            "step": torch.zeros((), dtype=torch.int64)}
    restored, _ = ckpt.restore(tmp_path, 2, like)
    assert restored["layer"]["w"].dtype == torch.float64
    assert torch.equal(restored["layer"]["w"],
                       tree["layer"]["w"].double())
    assert torch.equal(restored["layer"]["b"], tree["layer"]["b"].float())
    assert int(restored["step"]) == 7


# -- the on-disk format is the reference's ------------------------------------------

def _loader_states():
    """The same loader state from each package, 3 batches in (PCG64 state
    as plain JSON integers)."""
    feats = np.random.default_rng(0).standard_normal((1500, 8)) \
        .astype(np.float32)
    kw = dict(batch_size=32, fanouts=(3,), data_plane="gids",
              cache_lines=128, cache_ways=4, window_depth=2, seed=4)
    ref = JLoader(jrmat(1500, 6, 8, seed=2), feats, JConfig(**kw))
    port = GIDSDataLoader(rmat_graph(1500, 6, 8, seed=2), feats,
                          LoaderConfig(**kw), device="cpu")
    for _ in range(3):
        ref.next_batch()
        port.next_batch()
    return ref.state_dict(), port.state_dict()


@pytest.mark.parametrize("with_list", [False, True])
def test_format_is_the_reference_byte_for_byte(tmp_path, with_list):
    """The same seeded tree and extra state, saved by each package: the
    same manifest.json text and the same .npy bytes."""
    jstate, tstate = _loader_states()
    jtree, ttree = _jtree(), _tree()
    if with_list:
        w2 = np.arange(6, dtype=np.float32).reshape(2, 3)
        jtree["stack"] = [jnp.asarray(w2), jnp.asarray(w2[0], jnp.bfloat16)]
        ttree["stack"] = [torch.from_numpy(w2),
                          torch.from_numpy(w2[0]).to(torch.bfloat16)]
    jdir = jckpt.save(tmp_path / "ref", 5, jtree, {"loader": jstate})
    tdir = ckpt.save(tmp_path / "port", 5, ttree, {"loader": tstate})
    jman = (jdir / "manifest.json").read_text()
    assert (tdir / "manifest.json").read_text() == jman
    manifest = json.loads(jman)
    assert isinstance(manifest["extra"]["loader"]["rng"]["state"]["state"],
                      int)
    files = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in tdir.iterdir()) == files
    assert len(files) == len(manifest["leaves"]) + 1
    for name in files:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name


def test_extra_state_keeps_numpy_values(tmp_path):
    """Numpy arrays and scalars in the extra state (a sharded plane's
    placement table, the fault plane's EMAs) come back with their type,
    dtype, shape and values; the rest of the state is JSON as before."""
    extra = {"table": np.arange(7, dtype=np.int16),
             "nested": {"ema": np.linspace(0.0, 1.0, 4),
                        "empty": np.zeros(0, np.int64),
                        "grid": np.eye(3, dtype=np.float32)},
             "pair": [np.float64(0.1) / 3, np.int64(-5)],
             "rng": {"state": 2 ** 100 + 1}, "name": "x", "none": None}
    d = ckpt.save(tmp_path, 3, _tree(), extra)
    assert sorted(p.name for p in (d / "extra").iterdir()) \
        == [f"{i}.npy" for i in range(6)]
    _, got = ckpt.restore(tmp_path, 3, _tree())
    flat_want, flat_got = _flat_state(extra), _flat_state(got)
    assert flat_got.keys() == flat_want.keys()
    for k, want in flat_want.items():
        assert type(flat_got[k]) is type(want), k
        if isinstance(want, np.ndarray):
            assert flat_got[k].dtype == want.dtype
            np.testing.assert_array_equal(flat_got[k], want)
        else:
            assert flat_got[k] == want, k


def _flat_state(state, prefix=""):
    """A state's leaves by path (lists and tuples alike)."""
    if isinstance(state, dict):
        items = state.items()
    elif isinstance(state, (list, tuple)):
        items = enumerate(state)
    else:
        return {prefix: state}
    out = {}
    for k, v in items:
        out.update(_flat_state(v, f"{prefix}/{k}"))
    return out


def test_each_package_restores_the_others_tree(tmp_path):
    jtree, ttree = _jtree(1), _tree(1)
    jckpt.save(tmp_path / "ref", 1, jtree)
    ckpt.save(tmp_path / "port", 1, ttree)
    t_from_j, _ = ckpt.restore(tmp_path / "ref", 1, ttree)
    j_from_t, _ = jckpt.restore(tmp_path / "port", 1, jtree)
    for a, b in zip(_leaves(ttree), _leaves(t_from_j), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(j_from_t),
                    strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


class S(typing.NamedTuple):
    """An optimizer state's shape: a step and trees beside the params."""
    step: object
    m: object
    v: object


def _state_trees():
    """ROADMAP.md Queue 3 item 9's tree, ({"w"}, S(step, m, v)), in each
    package."""
    ones, zeros = np.ones((2, 3), np.float32), np.zeros((2, 3), np.float32)
    jtree = ({"w": jnp.asarray(ones)},
             S(step=jnp.asarray(1, jnp.int32), m={"w": jnp.asarray(zeros)},
               v={"w": jnp.asarray(zeros + 2)}))
    ttree = ({"w": torch.from_numpy(ones)},
             S(step=torch.tensor(1, dtype=torch.int32),
               m={"w": torch.from_numpy(zeros)},
               v={"w": torch.from_numpy(zeros + 2)}))
    return jtree, ttree


def test_namedtuple_keyed_by_field_across_packages(tmp_path):
    """A NamedTuple's items are keyed by field name, in field order, as
    the reference keys them: both packages write the leaves 0/w, 1/step,
    1/m/w and 1/v/w with the same manifest text; the port restores the
    reference's checkpoint and its own into a NamedTuple, and the
    reference restores the port's."""
    jtree, ttree = _state_trees()
    jdir = jckpt.save(tmp_path / "ref", 1, jtree)
    tdir = ckpt.save(tmp_path / "port", 1, ttree)
    jman = (jdir / "manifest.json").read_text()
    assert list(json.loads(jman)["leaves"]) == ["0/w", "1/step", "1/m/w",
                                                "1/v/w"]
    assert (tdir / "manifest.json").read_text() == jman
    like = (ttree[0], S(torch.tensor(0, dtype=torch.int32),
                        {"w": torch.zeros(2, 3)}, {"w": torch.zeros(2, 3)}))
    for src in (tmp_path / "ref", tmp_path / "port"):
        got, _ = ckpt.restore(src, 1, like)
        assert type(got[1]) is S
        for a, b in zip(_leaves(ttree), _leaves(got), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)
    j_from_t, _ = jckpt.restore(tmp_path / "port", 1, jtree)
    assert type(j_from_t[1]) is S and int(j_from_t[1].step) == 1
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(j_from_t),
                    strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the GNN's parameters across the packages -----------------------------------------

CFG = dict(model="sage", in_dim=16, hidden_dim=32, num_classes=5,
           fanouts=(4, 3))


def _gnn_inputs():
    rng = np.random.default_rng(0)
    g = rmat_graph(500, 6, 16, seed=5)
    feats = rng.standard_normal((g.num_nodes, 16)).astype(np.float32)
    blocks = host_sample_blocks(g, rng.integers(0, g.num_nodes, 16), (4, 3),
                                rng)
    return feats[blocks.all_nodes], hop_indices(blocks)


def _logits(jm, params, port, table, hi):
    j = np.asarray(jm.forward(params, jnp.asarray(table),
                              [jnp.asarray(i) for i in hi]))
    with torch.no_grad():
        t = port(torch.from_numpy(table),
                 [torch.from_numpy(i) for i in hi]).numpy()
    return j, t


def test_gnn_params_cross_restore(tmp_path):
    """The reference's parameter pytree, checkpointed by the reference,
    restores into the port's GNN through `param_tree()`; the port's
    parameters, checkpointed by the port, restore into the reference's
    pytree.  Logits agree within 1e-5 (f32) both ways, and the two
    packages write the same files for the same parameters."""
    table, hi = _gnn_inputs()
    jm = jgnn.GNN(jgnn.GNNConfig(**CFG))
    jparams = jm.init(jax.random.PRNGKey(0))
    jckpt.save(tmp_path / "ref", 1, jparams)

    port = GNN(GNNConfig(**CFG), generator=torch.Generator().manual_seed(3),
               device="cpu")
    tree, _ = ckpt.restore(tmp_path / "ref", 1, port.param_tree())
    port.load_reference_params(tree)
    j, t = _logits(jm, jparams, port, table, hi)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    ckpt.save(tmp_path / "port_same", 1, port.param_tree())
    for p in (tmp_path / "ref" / "step_00000001").iterdir():
        assert (tmp_path / "port_same" / "step_00000001" / p.name) \
            .read_bytes() == p.read_bytes(), p.name

    other = GNN(GNNConfig(**CFG), generator=torch.Generator().manual_seed(7),
                device="cpu")
    ckpt.save(tmp_path / "port", 2, other.param_tree())
    jback, _ = jckpt.restore(tmp_path / "port", 2, jparams)
    j, t = _logits(jm, jback, other, table, hi)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_param_tree_shares_storage_and_inverts_load():
    port = GNN(GNNConfig(**CFG), device="cpu")
    tree = port.param_tree()
    assert sorted(tree) == ["head", "layer0", "layer1"]
    assert sorted(tree["layer0"]) == ["b", "w_nbr", "w_self"]
    assert tree["head"]["w"].data_ptr() == port.head["w"].data_ptr()
    assert not tree["head"]["w"].requires_grad
    copy = {g: {k: v.clone() + 1 for k, v in ps.items()}
            for g, ps in tree.items()}
    port.load_reference_params(copy)
    for g, ps in port.param_tree().items():
        for k, v in ps.items():
            assert torch.equal(v, copy[g][k])


# -- twins of tests/test_fault_tolerance.py -----------------------------------------

class FakeClock:
    """Deterministic clock: each step takes whatever the test scripts."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _run_steps(wd, clock, durations, start=0):
    flags = []
    for i, dt in enumerate(durations, start):
        wd.start_step(i)
        clock.advance(dt)
        flags.append(wd.end_step())
    return flags


def test_watchdog_flags_straggler_after_warmup():
    clock = FakeClock()
    wd = StepWatchdog(WatchdogConfig(step_timeout_factor=5.0,
                                     min_history=4), clock=clock)
    flags = _run_steps(wd, clock, [0.1, 0.1, 0.1, 10.0])
    assert flags == [False] * 4
    assert _run_steps(wd, clock, [0.4], start=4) == [False]
    assert _run_steps(wd, clock, [0.6], start=5) == [True]
    assert wd.flagged == [(5, pytest.approx(0.6))]
    assert wd.median_step_s == pytest.approx(0.4)


def test_watchdog_median_tracks_drift():
    clock = FakeClock()
    wd = StepWatchdog(WatchdogConfig(step_timeout_factor=5.0, min_history=4,
                                     max_step_history=8), clock=clock)
    _run_steps(wd, clock, [0.1] * 8)
    flags = _run_steps(wd, clock, [0.45] * 8, start=8)
    assert not any(flags)
    assert wd.median_step_s == pytest.approx(0.45)
    assert len(wd.history) == 8


def test_watchdog_end_without_start_raises():
    wd = StepWatchdog(clock=FakeClock())
    with pytest.raises(RuntimeError, match="start_step"):
        wd.end_step()


def test_watchdog_checkpoint_cadence():
    wd = StepWatchdog(WatchdogConfig(checkpoint_every=50), clock=FakeClock())
    assert not wd.should_checkpoint(0)
    assert wd.should_checkpoint(50)
    assert not wd.should_checkpoint(51)
    assert wd.should_checkpoint(100)


def test_watchdog_default_clock_is_wall_time():
    wd = StepWatchdog()
    wd.start_step(0)
    assert wd.end_step() is False
    assert wd.history and wd.history[0] >= 0.0


def test_watchdog_flags_the_same_steps_as_the_reference():
    """One scripted sequence of step times through both watchdogs."""
    from repro.train.fault_tolerance import StepWatchdog as JWatchdog
    from repro.train.fault_tolerance import WatchdogConfig as JConfigW
    durations = np.random.default_rng(0).exponential(0.1, 200)
    durations[[30, 77, 150]] *= 40
    flags = []
    for wd_cls, cfg_cls in ((JWatchdog, JConfigW),
                            (StepWatchdog, WatchdogConfig)):
        clock = FakeClock()
        wd = wd_cls(cfg_cls(min_history=8, max_step_history=32), clock=clock)
        flags.append((_run_steps(wd, clock, durations), wd.flagged,
                      wd.median_step_s))
    assert flags[0] == flags[1]
    assert any(flags[1][0])
