"""End-to-end LM trainer, the port of `repro.launch.train`.

Runs any registered architecture (reduced or full config) with the GIDS
token pipeline, AdamW (Adafactor for the MoE archs), checkpoint/restart
and the step watchdog, on one device: the card unless `--device cpu`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_1_5b \\
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 12 --batch 2 --seq 16

Like the reference's trainer, it feeds no `frames`, so an encoder-decoder
arch (whisper-small) cannot train here: its encoder reads
`batch["frames"]` (ROADMAP.md Queue 3 item 10).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.models.transformer import LM
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import schedules
from repro_torch.train.fault_tolerance import StepWatchdog, WatchdogConfig
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.steps import TrainConfig, make_train_step


def build(arch: str, reduced: bool, batch: int, seq: int,
          lr: float, total_steps: int, schedule: str,
          microbatches: int = 1, device: str | torch.device = "cuda"):
    """(cfg, model, step_fn, pipe, ocfg) as the reference's `build`: the
    model on `device`, the optimizer by family, a schedule warming up over
    max(total // 20, 5) steps, and the token pipeline (a vlm's patch rows
    from a 4096-row synthetic `FeatureStore` on `device`)."""
    device = resolve_device(device)
    cfg = configs.get(arch, reduced=reduced)
    model = LM(cfg, device=device)
    ocfg = OptimizerConfig(name="adafactor" if cfg.moe_experts else "adamw",
                           lr=lr)
    sched = schedules.make(schedule, peak_lr=lr,
                           warmup=max(total_steps // 20, 5),
                           total=total_steps)
    tcfg = TrainConfig(optimizer=ocfg, microbatches=microbatches,
                       schedule=sched)
    step_fn = make_train_step(model, tcfg)
    pipe_cfg = TokenPipelineConfig(batch_size=batch, seq_len=seq,
                                   vocab_size=cfg.vocab_size)
    mstore = None
    if cfg.frontend == "vision_stub":
        from repro_torch.core.feature_store import FeatureStore
        mstore = FeatureStore.synthetic(4096, cfg.d_model, device=device)
        pipe_cfg = dataclasses.replace(pipe_cfg,
                                       modality_dim=cfg.d_model,
                                       modality_tokens=cfg.frontend_tokens)
    pipe = TokenPipeline(None, pipe_cfg, modality_store=mstore)
    return cfg, model, step_fn, pipe, ocfg


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg, model, step_fn, pipe, ocfg = build(
        args.arch, args.reduced, args.batch, args.seq, args.lr, args.steps,
        args.schedule, args.microbatches, device=args.device)
    device = model.device
    print(f"arch={cfg.name} family={cfg.family} "
          f"params will init on {device}")

    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    n_params = sum(x.numel() for x in opt_lib.leaves(params))
    opt_state = opt_lib.init(params, ocfg)
    start_step = 0

    if args.ckpt_dir:
        latest = ckpt_lib.latest_step(args.ckpt_dir)
        if latest is not None:
            (params, opt_state), extra = ckpt_lib.restore(
                args.ckpt_dir, latest, (params, opt_state))
            pipe.load_state_dict(extra["pipeline"])
            start_step = latest
            print(f"resumed from step {latest}")

    watchdog = StepWatchdog(WatchdogConfig(checkpoint_every=args.ckpt_every))
    losses = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        watchdog.start_step(step)
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(pipe).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))      # waits for the step
        straggler = watchdog.end_step()
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = (args.batch * args.seq) / max(watchdog.median_step_s,
                                                  1e-9)
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} tok/s {tok_s:,.0f}"
                  + (" [straggler]" if straggler else ""))
        if args.ckpt_dir and watchdog.should_checkpoint(step):
            ckpt_lib.save(args.ckpt_dir, step, (params, opt_state),
                          {"pipeline": pipe.state_dict()})

    wall = time.time() - t_start
    if args.ckpt_dir:
        ckpt_lib.save(args.ckpt_dir, args.steps, (params, opt_state),
                      {"pipeline": pipe.state_dict()})
    print(json.dumps({
        "arch": cfg.name, "params": n_params, "steps": args.steps,
        "first_loss": losses[0] if losses else None,
        "final_loss": float(np.mean(losses[-5:])) if losses else None,
        "wall_s": round(wall, 1),
    }))


if __name__ == "__main__":
    main()
