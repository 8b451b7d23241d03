"""Batched serving through the PyTorch port: prefill a prompt batch, then
greedy-decode with the KV / recurrent-state cache, for any of the ten
architectures (the counterpart of examples/serve_decode.py).

This drives `LM.prefill` / `LM.decode_step` directly on a static batch.
For continuous batching, requests admitted and retired mid-stream through
a KV slot pool, use `repro_torch.serve.ServeEngine` (every family but the
encoder-decoder, whose requests would need frames).  An encoder-decoder
batch gets stub frame embeddings (B, encoder_seq, D) and a vlm batch stub
patch embeddings (B, frontend_tokens, D), both from default_rng(0); a vlm
prompt's cache rows start after its patches, so decoding starts at
patches + prompt.

    # the reduced config on the CPU (plain PyTorch attention)
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu \
        --arch recurrentgemma_2b --batch 4 --prompt-len 32 --new-tokens 16
    # the full published width on the card, attention on the CUDA kernel
    PYTHONPATH=src python examples/serve_decode_torch.py --full \
        --arch recurrentgemma_2b --batch 8 --prompt-len 2500 --new-tokens 32
    PYTHONPATH=src python examples/serve_decode_torch.py --full \
        --arch arctic_480b --layers 1 --prompt-len 512
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.models.transformer import LM


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma_2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the full published config instead of the reduced")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (the MoE models fit one card only "
                    "at a few layers)")
    args = ap.parse_args()

    cfg = configs.get(args.arch, reduced=not args.full)
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = LM(cfg, device=args.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    B, S, T = args.batch, args.prompt_len, args.new_tokens

    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)}
    rows = S
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)) * 0.1
             ).astype(np.float32)).to(dev)
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.from_numpy(
            (rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)) * 0.1
             ).astype(np.float32)).to(dev)
        rows += cfg.frontend_tokens

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    with torch.inference_mode():
        cache = model.init_cache(B, rows + T + 64)
        sync()
        t0 = time.time()
        logits, cache = model.prefill(params, batch, cache)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        sync()
        t_prefill = time.time() - t0
        print(f"{cfg.name}: prefill {B}x{S} in {t_prefill*1e3:.1f} ms")

        out = [tok]
        t0 = time.time()
        for t in range(T - 1):
            logits, cache = model.decode_step(params, tok, cache, rows + t)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            out.append(tok)
        sync()
        dt = time.time() - t0
    gen = torch.cat(out, dim=1).cpu().numpy()
    print(f"decoded {T} tokens/seq in {dt*1e3:.1f} ms "
          f"({B*T/max(dt,1e-9):,.0f} tok/s batch-aggregate)")
    for b in range(min(B, 2)):
        print(f"  seq{b}: {gen[b].tolist()}")


if __name__ == "__main__":
    main()
