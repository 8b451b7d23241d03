"""The port's LM token pipeline (`repro_torch.data.tokens`) and keyword
feature store (`core.feature_store.FeatureStore`) against the JAX
package's on the CPU.  Both are host numpy up to the patch rows, so the
parity class is bit for bit: batches, patch rows, the cursor, the rng,
the prefetch queue's depth and `state_dict` across a save and restore."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.feature_store import FeatureStore as JStore  # noqa: E402
from repro.core.software_cache import WindowBufferedCache as JCache  # noqa: E402
from repro.data.tokens import TokenPipeline as JPipe  # noqa: E402
from repro.data.tokens import TokenPipelineConfig as JCfg  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.core import WindowBufferedCache  # noqa: E402
from repro_torch.core.feature_store import FeatureStore  # noqa: E402
from repro_torch.data.tokens import (TokenPipeline,  # noqa: E402
                                     TokenPipelineConfig)
from repro_torch.train import checkpoint as ckpt  # noqa: E402

MODALITY = dict(batch_size=4, seq_len=32, vocab_size=100, modality_dim=16,
                modality_tokens=3)


def _pipes(shard=None, modality=True, **cfg):
    """The same pipeline in each package (patch rows from a 512 x 16
    synthetic store when `modality`)."""
    cfg = {**MODALITY, **cfg}
    if not modality:
        cfg.update(modality_dim=0, modality_tokens=0)
    jstore = JStore.synthetic(512, 16) if modality else None
    tstore = FeatureStore.synthetic(512, 16, device="cpu") if modality \
        else None
    return (JPipe(shard, JCfg(**cfg), modality_store=jstore,
                  num_tokens=1 << 14),
            TokenPipeline(shard, TokenPipelineConfig(**cfg),
                          modality_store=tstore, num_tokens=1 << 14))


def _same_batch(jb, tb):
    assert jb.keys() == tb.keys()
    for k in ("tokens", "labels"):
        assert tb[k].dtype == jb[k].dtype
        np.testing.assert_array_equal(tb[k], jb[k])
    if "patches" in jb:
        assert isinstance(tb["patches"], torch.Tensor)
        np.testing.assert_array_equal(tb["patches"].numpy(), jb["patches"])


def _same_state(js, ts):
    assert json.dumps(ts, sort_keys=True) == json.dumps(js, sort_keys=True)


def test_token_pipeline_modality_store():
    """The twin of test_pipeline.py's, with the batch equal to the
    reference's bit for bit."""
    store = FeatureStore.synthetic(512, 16, device="cpu")
    cfg = TokenPipelineConfig(batch_size=4, seq_len=32, vocab_size=100,
                              modality_dim=16, modality_tokens=3)
    pipe = TokenPipeline(None, cfg, modality_store=store, num_tokens=1 << 14)
    b = next(pipe)
    assert b["tokens"].shape == (4, 32)
    assert b["labels"].shape == (4, 32)
    assert b["patches"].shape == (4, 3, 16)
    # labels are the shifted stream
    flat = np.concatenate([b["tokens"][0], [b["labels"][0, -1]]])
    np.testing.assert_array_equal(b["labels"][0], flat[1:])
    jpipe, _ = _pipes()
    _same_batch(next(jpipe), b)


@pytest.mark.parametrize("modality", [False, True])
def test_batches_queue_and_state_match_reference(modality):
    """30 batches (past a wrap of the 16k-token shard), each equal to the
    reference's, with the same prefetch queue depth and `state_dict`
    after every batch; a pipeline restored mid-stream from the state
    delivers the rest, in each package (the synthetic shard is drawn
    from the config's seed, so it is rebuilt alike)."""
    jpipe, tpipe = _pipes(modality=modality)
    jbatches, states = [], []
    for _ in range(30):
        jb, tb = next(jpipe), next(tpipe)
        _same_batch(jb, tb)
        assert len(tpipe._queue) == len(jpipe._queue)
        _same_state(jpipe.state_dict(), tpipe.state_dict())
        jbatches.append(jb)
        states.append(tpipe.state_dict())
    assert tpipe.accumulator.redirect_rate == jpipe.accumulator.redirect_rate
    at = 11
    state = json.loads(json.dumps(states[at]))     # as a manifest holds it
    for resumed in _pipes(modality=modality):
        resumed.load_state_dict(state)
        for jb in jbatches[at + 1:]:
            got = next(resumed)
            if isinstance(resumed, TokenPipeline):
                _same_batch(jb, got)
            else:
                _same_batch(got, {k: (torch.from_numpy(v) if k == "patches"
                                      else v) for k, v in jb.items()})


def test_memmap_shard_matches_reference(tmp_path):
    """A token shard in a file, read through memmap by both packages."""
    shard = tmp_path / "shard.bin"
    np.random.default_rng(3).integers(0, 100, 5000).astype(np.int32) \
        .tofile(shard)
    jpipe, tpipe = _pipes(shard=shard, modality=False)
    for _ in range(12):
        _same_batch(next(jpipe), next(tpipe))
        _same_state(jpipe.state_dict(), tpipe.state_dict())


def test_resume_is_deterministic(tmp_path):
    """The twin of test_checkpoint.py's: 6 steps straight against 3 + a
    checkpoint through `train.checkpoint` + 3 from a rebuilt pipeline give
    the same weight, and the reference's checkpoint of the same run
    resumes the port's pipeline alike."""
    def make():
        cfg = TokenPipelineConfig(batch_size=2, seq_len=8, vocab_size=64)
        return TokenPipeline(None, cfg, num_tokens=4096)

    def step(w, batch):
        toks = torch.as_tensor(batch["tokens"], dtype=torch.float32)
        return w - torch.mean(toks) * 0.01

    pipe = make()
    w = torch.ones(())
    for _ in range(6):
        w = step(w, next(pipe))
    w_straight = float(w)

    pipe = make()
    w = torch.ones(())
    for _ in range(3):
        w = step(w, next(pipe))
    ckpt.save(tmp_path / "r", 3, {"w": w}, {"pipe": pipe.state_dict()})
    jpipe = JPipe(None, JCfg(batch_size=2, seq_len=8, vocab_size=64),
                  num_tokens=4096)
    for _ in range(3):
        next(jpipe)
    jckpt.save(tmp_path / "j", 3, {"w": jnp.asarray(w.numpy())},
               {"pipe": jpipe.state_dict()})
    for d in ("r", "j"):
        pipe2 = make()
        restored, extra = ckpt.restore(tmp_path / d, 3,
                                       {"w": torch.zeros(())})
        pipe2.load_state_dict(extra["pipe"])
        w2 = restored["w"]
        for _ in range(3):
            w2 = step(w2, next(pipe2))
        assert float(w2) == w_straight


def test_feature_store_matches_reference(tmp_path):
    """`FeatureStore.synthetic` and `memmap` hold the reference's features
    bit for bit (the memmap file byte for byte); a store with the window
    cache and constant buffer serves the reference's rows and tier split
    batch after batch, its rows on the device."""
    from repro.core.constant_buffer import ConstantBuffer as JCB
    from repro_torch.core import ConstantBuffer
    j, t = JStore.synthetic(300, 8, seed=2), FeatureStore.synthetic(
        300, 8, seed=2, device="cpu")
    np.testing.assert_array_equal(t.features, j.features)
    JStore.memmap(str(tmp_path / "j.bin"), 300, 8, create=True, seed=4)
    tm = FeatureStore.memmap(str(tmp_path / "t.bin"), 300, 8, create=True,
                             seed=4, device="cpu")
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    assert isinstance(tm.features, np.memmap)
    hot = np.arange(0, 300, 7)
    jcb, tcb = JCB(300, hot), ConstantBuffer(300, hot)
    j = JStore(j.features, cache=JCache(64, 4, window_depth=0, seed=1),
               constant_buffer=jcb)
    t = FeatureStore(t.features, cache=WindowBufferedCache(
        64, 4, window_depth=0, seed=1), constant_buffer=tcb, device="cpu")
    assert [x.name for x in t.tiers] == [x.name for x in j.tiers]
    rng = np.random.default_rng(0)
    for _ in range(5):
        ids = np.unique(rng.integers(0, 300, 60))
        jrows, jrep = j.gather(ids)
        trows, trep = t.gather(ids)
        np.testing.assert_array_equal(trows.numpy(), jrows)
        assert (trep.n_hbm_hits, trep.n_host_hits, trep.n_storage) == \
            (jrep.n_hbm_hits, jrep.n_host_hits, jrep.n_storage)
        assert trep.redirected == jrep.redirected
