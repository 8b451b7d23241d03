"""LM training in the port (`LM.loss` through autograd, `train.optimizer`,
`train.schedules`, `train.steps`, `launch.train`) against the JAX
package's on the CPU, in f32, from the reference's parameters carried
over by `load_reference_params` and its optimizer states by
`_state_from_reference`.

Parity classes: the loss, the grad norm and the optimizer moments (linear
or quadratic in the gradients) within 1e-5; the optimizer alone, fed the
same gradients, within 1e-5 for every parameter and state leaf.  A whole
step's parameters are held at 1e-5 + UPDATE_SLOPE x lr: the first AdamW
or Adafactor update of an element is g / (|g| + eps), whose slope in g
is up to 1 / eps = 1e8, so a gradient element near eps = 1e-8 turns the
f32 rounding of the gradients (~1e-9 here, the same in both packages'
arithmetic) into up to ~0.05 of that element's update.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models.transformer import LM as JLM  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import schedules as jsched  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import schedules  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.steps import (TrainConfig,  # noqa: E402
                                     make_decode_step, make_prefill_step,
                                     make_train_step)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
UPDATE_SLOPE = 0.1
B, S = 4, 16


# -- helpers -------------------------------------------------------------------------

def _models(arch, remat=False, **extra):
    """The reference's model and f32 params, and the port's with the same
    params."""
    jcfg = dataclasses.replace(jconfigs.get(arch, reduced=True),
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32, remat=remat,
                               **extra)
    tcfg = dataclasses.replace(tconfigs.get(arch, reduced=True),
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32, remat=remat,
                               **extra)
    jm = JLM(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = LM(tcfg, device="cpu")
    return jm, params, tm, tm.load_reference_params(
        jax.tree.map(np.asarray, params))


def _batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)
                                    ).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)
                                    ).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["patches"] = (rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _state_from_reference(jtree, like):
    """The reference's tree (NamedTuple states of dict/list trees) as
    tensors in `like`'s structure and dtypes."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_state_from_reference(getattr(jtree, f),
                                                  getattr(like, f))
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _state_from_reference(jtree[k], v)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_state_from_reference(j, t)
                          for j, t in zip(jtree, like, strict=True))
    return torch.from_numpy(np.array(jtree, np.float64)).to(like.dtype)


def _by_path(jtree, ttree):
    """Both trees' leaves under the checkpoint's path keys (the same keys
    in both packages), as f64 numpy."""
    jf, tf = jckpt._flatten(jtree), ckpt._flatten(ttree)
    assert jf.keys() == tf.keys()
    return {k: (np.asarray(jf[k], np.float64),
                tf[k].detach().double().numpy()) for k in jf}


def _close(a, b, atol):
    np.testing.assert_allclose(b, a, rtol=TOL, atol=atol)


def _optimizer(cfg, lr=1e-3):
    name = "adafactor" if cfg.moe_experts else "adamw"
    return (jopt.OptimizerConfig(name=name, lr=lr),
            OptimizerConfig(name=name, lr=lr))


# -- the train step against the reference ----------------------------------------------

STEP_CASES = [(arch, mb, remat) for arch in ("qwen2_1_5b", "arctic_480b")
              for mb in (1, 2) for remat in (False, True)]


@pytest.mark.parametrize("arch,microbatches,remat", STEP_CASES)
def test_train_step_matches_reference(arch, microbatches, remat):
    """One step of AdamW on a dense config and of Adafactor on a MoE
    config from the same params, state and batch, with and without
    microbatches and remat: loss, grad norm and lr, the optimizer's
    moments within TOL, and the new params and master within TOL +
    UPDATE_SLOPE x lr (the module docstring says why)."""
    jm, jparams, tm, tparams = _models(arch, remat=remat)
    jo, to = _optimizer(jm.cfg)
    lr = 1e-3
    jstep = jax.jit(jsteps.make_train_step(jm, jsteps.TrainConfig(
        optimizer=jo, microbatches=microbatches, schedule=lambda s: lr)))
    tstep = make_train_step(tm, TrainConfig(
        optimizer=to, microbatches=microbatches, schedule=lambda s: lr))
    batch = _batch(jm.cfg)
    jstate = jopt.init(jparams, jo)
    tstate = opt_lib.init(tparams, to)
    jp, js, jmet = jstep(jparams, jstate, _j(batch))
    tp, ts, tmet = tstep(tparams, tstate, _t(batch))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=TOL)
    assert np.float32(tmet["lr"]) == np.float32(jmet["lr"])
    assert int(ts.step) == int(js.step) == 1
    for key, (a, b) in _by_path((jp, js), (tp, ts)).items():
        moved = key.startswith("0/") or key.startswith("1/master/")
        _close(a, b, TOL + UPDATE_SLOPE * lr if moved else TOL)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(name):
    """The optimizer alone, fed the same gradients three times over
    (the reference's model's, scaled per step so that Adafactor's update
    RMS exceeds 1 and clips): every param and state leaf within TOL."""
    arch = "qwen2_1_5b" if name == "adamw" else "arctic_480b"
    jm, jparams, tm, tparams = _models(arch)
    jo = jopt.OptimizerConfig(name=name, lr=1e-2, factored_min_dim=16)
    to = OptimizerConfig(name=name, lr=1e-2, factored_min_dim=16)
    jgrads = jax.jit(jax.grad(jm.loss))(jparams, _j(_batch(jm.cfg)))
    jupdate = jax.jit(jopt.update, static_argnums=3)
    jstate, tstate = jopt.init(jparams, jo), opt_lib.init(tparams, to)
    for scale in (0.1, 3.0, 1.0):
        g = jax.tree.map(lambda x: x * scale, jgrads)
        tg = _state_from_reference(g, tparams)
        jparams, jstate, jgn = jupdate(g, jstate, jparams, jo,
                                       jnp.float32(1e-2))
        tparams, tstate, tgn = opt_lib.update(tg, tstate, tparams, to,
                                              torch.tensor(1e-2))
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=TOL)
    for a, b in _by_path((jparams, jstate), (tparams, tstate)).values():
        _close(a, b, TOL)


def test_adafactor_clips_the_whole_stacked_leaf():
    """Adafactor's update-RMS clip is taken over a whole stacked leaf, all
    its layers at once, as the reference takes it: a stacked (2, 4) leaf
    whose layer 1 alone would clip moves as the reference's does, and not
    as two separately clipped layers would."""
    w = np.zeros((2, 4), np.float32)
    g1 = np.array([[1e-3] * 4, [1e-3] * 4], np.float32)
    g2 = np.array([[1e-3] * 4, [1.0] * 4], np.float32)
    cfg = dict(name="adafactor", lr=1.0, weight_decay=0.0, grad_clip=1e9)
    jo, to = jopt.OptimizerConfig(**cfg), OptimizerConfig(**cfg)
    jp, tp = {"w": jnp.asarray(w)}, {"w": torch.from_numpy(w.copy())}
    js, ts = jopt.init(jp, jo), opt_lib.init(tp, to)
    for g in (g1, g2):
        jp, js, _ = jopt.update({"w": jnp.asarray(g)}, js, jp, jo,
                                jnp.float32(1.0))
        tp, ts, _ = opt_lib.update({"w": torch.from_numpy(g)}, ts, tp, to,
                                   torch.tensor(1.0))
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=TOL, atol=1e-7)
    # clipped per layer, layer 0 (RMS 1) would step to -2.0
    assert float(tp["w"][0, 0]) > -1.9


def test_first_cosine_step_moves_no_parameter():
    """The rate is read at the state's step before the optimizer increments
    it, so a cosine run's first step has lr 0 and leaves every parameter
    (and the master) as it was, in both packages, while the moments
    move."""
    kw = dict(arch="qwen2_1_5b", reduced=True, batch=2, seq=16, lr=1e-3,
              total_steps=20, schedule="cosine")
    jcfg, jm, jstep, jpipe, jo = jlaunch.build(**kw)
    tcfg, tm, tstep, tpipe, to = tlaunch.build(**kw, device="cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = tm.load_reference_params(jax.tree.map(np.asarray, jparams))
    before = {k: v.clone() for k, v in ckpt._flatten(tparams).items()}
    jstate, tstate = jopt.init(jparams, jo), opt_lib.init(tparams, to)
    jb, tb = next(jpipe), next(tpipe)
    jp2, js2, jmet = jstep(jparams, jstate, _j(jb))
    tp2, ts2, tmet = tstep(tparams, tstate, _t(tb))
    assert float(jmet["lr"]) == float(tmet["lr"]) == 0.0
    for k, v in ckpt._flatten(tp2).items():
        assert torch.equal(v, before[k]), k
        assert torch.equal(ckpt._flatten(ts2.master)[k], before[k]), k
    for k, v in jckpt._flatten(jp2).items():
        np.testing.assert_array_equal(np.asarray(v, np.float32),
                                      before[k].float().numpy())
    assert any(float(m.abs().max()) > 0 for m in opt_lib.leaves(ts2.m))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_loss_matches_reference(arch):
    """`LM.loss` and its gradient norm for every architecture (a vlm's
    patch rows cut off, whisper through its encoder) within TOL of the
    reference's; labels < 0 are masked."""
    jm, jparams, tm, tparams = _models(arch)
    batch = _batch(jm.cfg, b=2)
    batch["labels"][0, :5] = -1
    jloss, jg = jax.jit(jax.value_and_grad(jm.loss))(jparams, _j(batch))
    tloss, tg = _loss_and_grads(tm, tparams, _t(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    jgn = float(jopt._global_norm(jg))
    np.testing.assert_allclose(float(opt_lib._global_norm(tg)), jgn,
                               rtol=TOL)


def _loss_and_grads(model, params, batch):
    ps = opt_lib.leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(ps, grads)]


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "whisper_small",
                                  "recurrentgemma_2b"])
def test_remat_recomputes_the_same_forward(arch):
    """remat=True (a checkpointed layer group, and each whisper encoder
    layer) gives the loss and gradients of remat=False bit for bit."""
    batch = _t(_batch(tconfigs.get(arch, reduced=True), b=2))
    out = []
    for remat in (False, True):
        _, _, tm, tparams = _models(arch, remat=remat)
        out.append(_loss_and_grads(tm, tparams, batch))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1], strict=True):
        assert torch.equal(a, b)


# -- twins of the reference's tests ----------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_forward_and_train_step(arch):
    """The twin of test_arch_smoke.py::test_forward_and_train_step: the
    reduced config in its own dtypes, params from a seeded generator, one
    forward and one train step on the CPU."""
    cfg = tconfigs.get(arch, reduced=True)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _t(_batch(cfg, b=2, s=32))
    with torch.no_grad():
        logits = model.forward(params, batch)
    exp_s = 32 + (cfg.frontend_tokens if cfg.frontend == "vision_stub"
                  else 0)
    assert logits.shape == (2, exp_s, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())
    ocfg = OptimizerConfig(name="adafactor" if cfg.moe_experts else "adamw",
                           lr=1e-3)
    step = make_train_step(model, TrainConfig(optimizer=ocfg))
    before = [p.clone() for p in opt_lib.leaves(params)]
    new_params, new_state, metrics = step(params, opt_lib.init(params, ocfg),
                                          batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(new_state.step) == 1
    delta = sum(float((a.float() - b.float()).abs().sum())
                for a, b in zip(before, opt_lib.leaves(new_params)))
    assert delta > 0
    assert not any(p.requires_grad for p in opt_lib.leaves(new_params))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_minimizes_quadratic(name):
    """The twin of test_optimizer.py's, with gradients by autograd."""
    target = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4, 256)).astype(np.float32))
    params = {"w": torch.zeros((4, 256))}
    cfg = OptimizerConfig(name=name, lr=0.1, weight_decay=0.0,
                          factored_min_dim=4)
    state = opt_lib.init(params, cfg)

    def loss_fn(p):
        return torch.mean((p["w"] - target) ** 2)

    loss0 = float(loss_fn(params))
    for _ in range(150):
        w = params["w"].requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(params), [w])
        w.requires_grad_(False)
        params, state, _ = opt_lib.update({"w": g}, state, params, cfg,
                                          torch.tensor(0.1))
    assert float(loss_fn(params)) < 0.05 * loss0


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros((8,))}
    cfg = OptimizerConfig(name="adamw", lr=1.0, grad_clip=1.0,
                          weight_decay=0.0)
    state = opt_lib.init(params, cfg)
    huge = {"w": torch.full((8,), 1e6)}
    _, _, gn = opt_lib.update(huge, state, params, cfg, torch.tensor(1.0))
    assert float(gn) > 1e5  # reported norm is pre-clip
    clipped, _ = opt_lib._clip(huge, 1.0)
    assert clipped["w"].dtype == torch.float32
    assert float(opt_lib._global_norm(clipped)) == pytest.approx(1.0)


def test_schedules():
    cos = schedules.make("cosine", peak_lr=1.0, warmup=10, total=100)
    assert float(cos(0)) == 0.0
    assert float(cos(10)) == pytest.approx(1.0, abs=1e-3)
    assert float(cos(100)) == pytest.approx(0.1, abs=1e-3)
    w = schedules.make("wsd", peak_lr=1.0, warmup=10, total=100,
                       decay_fraction=0.2)
    assert float(w(50)) == 1.0                     # stable plateau
    assert float(w(99)) < 0.1                      # decay tail
    assert float(w(5)) == pytest.approx(0.5, abs=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("cosine", dict(peak_lr=3e-4, warmup=5, total=60)),
    ("cosine", dict(peak_lr=1.0, warmup=10, total=100, min_ratio=0.2)),
    ("wsd", dict(peak_lr=1.0, warmup=10, total=100, decay_fraction=0.2)),
    ("wsd", dict(peak_lr=3e-3, warmup=5, total=60))])
def test_schedules_match_reference(name, kw):
    """Every step of the run and past it, f32 from an int32 step: equal bit
    for bit in warmup and on the plateau (no transcendental), elsewhere
    within 1e-7 relative or 1e-7 of the peak rate (f32 cos and pow of XLA
    and torch may differ by an ulp, 1.3e-7 relative at cosine step 49 of
    60, where 1 + cos is 0.19)."""
    jfn, tfn = jsched.make(name, **kw), schedules.make(name, **kw)
    total, warmup = kw["total"], kw["warmup"]
    plateau_end = total * (1 - kw.get("decay_fraction", 1.0))
    for s in range(total + 5):
        want = np.asarray(jfn(np.int32(s)))
        got = tfn(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        if s < warmup or (name == "wsd" and s <= plateau_end):
            assert float(got) == float(want), s
        else:
            np.testing.assert_allclose(float(got), float(want), rtol=1e-7,
                                       atol=1e-7 * kw["peak_lr"])


def test_lm_training_loss_decreases():
    """The twin of test_system.py's: the trainer's `build`, a reduced qwen2
    for 60 steps on the learnable stream (next token = token + 1 mod 50),
    the loss halving."""
    cfg, model, step_fn, pipe, ocfg = tlaunch.build(
        "qwen2_1_5b", reduced=True, batch=8, seq=32, lr=3e-3,
        total_steps=60, schedule="cosine", device="cpu")
    pipe.tokens = (np.cumsum(np.ones(1 << 14)) % 50).astype(np.int32)
    params = model.init(torch.Generator().manual_seed(0))
    opt_state = opt_lib.init(params, ocfg)
    losses = []
    for _ in range(60):
        params, opt_state, m = step_fn(params, opt_state, _t(next(pipe)))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:5]), \
        (np.mean(losses[:5]), np.mean(losses[-10:]))


_BLOCK_JAX = ("import sys; sys.modules['jax'] = None; "
              "sys.modules['repro'] = None\n")


def _run_trainer(args, tmp_path):
    """`python -m repro_torch.launch.train --device cpu ...` with JAX and
    the JAX package unimportable."""
    code = _BLOCK_JAX + (
        "import runpy\n"
        f"sys.argv = ['train', '--device', 'cpu', *{args!r}]\n"
        "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=tmp_path, timeout=300)


def test_trainer_cli_resume(tmp_path):
    """The twin of test_system.py's: the trainer checkpoints and resumes,
    without JAX, and the resumed checkpoint carries the optimizer state
    under the reference's names."""
    args = ["--arch", "qwen2_1_5b", "--reduced", "--steps", "12", "--batch",
            "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "6"]
    r1 = _run_trainer(args, tmp_path)
    assert r1.returncode == 0, r1.stderr[-2000:]
    r2 = _run_trainer([a if a != "12" else "18" for a in args], tmp_path)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from step 12" in r2.stdout
    assert ckpt.latest_step(tmp_path / "ck") == 18
    import json
    leaves = json.loads((tmp_path / "ck" / "step_00000018" /
                         "manifest.json").read_text())["leaves"]
    assert {"1/step", "1/m/embed", "1/v/embed", "1/master/embed"} \
        <= leaves.keys()


def test_example_trains_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
         "--device", "cpu", "--arch", "mamba2_1_3b", "--steps", "3",
         "--batch", "2", "--seq", "16"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"steps": 3' in r.stdout


def test_trainer_state_restores_across_packages(tmp_path):
    """The reference trainer's checkpoint, (params, AdamWState), restores
    into the port's (params, AdamWState) and the port's into the
    reference's, leaf for leaf."""
    kw = dict(arch="qwen2_1_5b", reduced=True, batch=2, seq=16, lr=1e-3,
              total_steps=20, schedule="cosine")
    _, jm, jstep, jpipe, jo = jlaunch.build(**kw)
    _, tm, tstep, tpipe, to = tlaunch.build(**kw, device="cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    jstate = jopt.init(jparams, jo)
    for _ in range(6):
        jparams, jstate, _ = jstep(jparams, jstate, _j(next(jpipe)))
    jckpt.save(tmp_path / "ref", 6, (jparams, jstate))
    tparams = tm.init(torch.Generator().manual_seed(1))
    like = (tparams, opt_lib.init(tparams, to))
    (tp, ts), _ = ckpt.restore(tmp_path / "ref", 6, like)
    assert type(ts) is opt_lib.AdamWState and int(ts.step) == 6
    for a, b in _by_path((jparams, jstate), (tp, ts)).values():
        np.testing.assert_array_equal(b, a)
    ckpt.save(tmp_path / "port", 6, (tp, ts))
    (jp2, js2), _ = jckpt.restore(tmp_path / "port", 6, (jparams, jstate))
    assert type(js2) is jopt.AdamWState
    for a, b in _by_path((jp2, js2), (tp, ts)).values():
        np.testing.assert_array_equal(b, a)


# -- faults pinned and guards ---------------------------------------------------------

def test_whisper_cannot_train_through_either_trainer():
    """ROADMAP.md Queue 3 item 10: the trainers' token pipeline yields no
    `frames`, and the encoder reads them; both packages fail the same
    way on the first step."""
    kw = dict(arch="whisper_small", reduced=True, batch=2, seq=16, lr=1e-3,
              total_steps=10, schedule="cosine")
    _, jm, jstep, jpipe, jo = jlaunch.build(**kw)
    jparams = jm.init(jax.random.PRNGKey(0))
    with pytest.raises(KeyError, match="frames"):
        jstep(jparams, jopt.init(jparams, jo), _j(next(jpipe)))
    _, tm, tstep, tpipe, to = tlaunch.build(**kw, device="cpu")
    tparams = tm.init(torch.Generator().manual_seed(0))
    with pytest.raises(KeyError, match="frames"):
        tstep(tparams, opt_lib.init(tparams, to), _t(next(tpipe)))


def test_flash_attention_refuses_autograd():
    """Neither package has a backward for flash_attention: a flash model
    asked for a gradient raises on the CPU too (on the card it would
    return an output with no graph behind it), in the train step and in a
    bare forward; without a gradient it serves, and `ops.flash_attention`
    raises for any q, k or v that requires grad."""
    from repro_torch.kernels import ops
    _, _, tm, tparams = _models("qwen2_1_5b", attn_impl="flash")
    batch = _t(_batch(tm.cfg, b=2))
    step = make_train_step(tm, TrainConfig(optimizer=OptimizerConfig()))
    state = opt_lib.init(tparams, OptimizerConfig())
    with pytest.raises(NotImplementedError, match="backward"):
        step(tparams, state, batch)
    for p in opt_lib.leaves(tparams):
        p.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        tm.forward(tparams, batch)
    with torch.no_grad():
        assert torch.isfinite(tm.forward(tparams, batch)).all()
    q, k, v = (torch.randn(1, 2, 4, 8), torch.randn(1, 2, 4, 8),
               torch.randn(1, 2, 4, 8))
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(NotImplementedError, match="backward"):
            ops.flash_attention(*args)
        with torch.inference_mode():
            ops.flash_attention(*args)


def test_prefill_and_decode_steps():
    """`make_prefill_step` and `make_decode_step` give the model's prefill
    logits and the argmax of its decode step as (B, 1) int32, as the
    reference's do."""
    jm, jparams, tm, tparams = _models("qwen2_1_5b")
    batch = _batch(tm.cfg, b=2, s=8)
    jcache = jm.init_cache(2, 12)
    tcache = tm.init_cache(2, 12)
    jl, jcache = jax.jit(jsteps.make_prefill_step(jm))(jparams, _j(batch),
                                                       jcache)
    with torch.no_grad():
        tl, tcache = make_prefill_step(tm)(tparams, _t(batch), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        tok = torch.from_numpy(np.array(jnp.argmax(jl[:, -1], -1),
                                        np.int32))[:, None]
        jnext, _ = jsteps.make_decode_step(jm)(jparams, jnp.asarray(
            tok.numpy()), jcache, jnp.int32(8))
        tnext, _ = make_decode_step(tm)(tparams, tok, tcache, 8)
    assert tnext.dtype == torch.int32 and tnext.shape == (2, 1)
    np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
