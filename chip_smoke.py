#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (written for an H100).

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. Card and set-up: the `nvidia-smi` name and power limit, TF32 off, and
   the build of every CUDA kernel of the port from src/repro_torch/kernels/
   csrc (one nvcc per source, all started together, into build/kernels/).
2. Per-kernel parity and timing at the main paths' shapes: each kernel
   against its plain PyTorch version on the same inputs (gathers, word
   gather, word reads, row-store fill, cache bucketing and cache access
   exact; segment_mean within 1e-6 in f32 and 2e-2 in bf16, also at
   fanouts 1, 3, 9 and 33 and at row widths 1000 and 1001; flash_attention
   within 3e-4 in f32 and 3e-2 in bf16, and every output row within 1e-4
   (f32) or 1e-2 (bf16) of its reference row in norm, at the sweep of
   tests/test_kernels.py, at the serving path's prefill, decode and a
   sliding-window shape, at decode edges (offsets 0 and Sk - 1, and one
   sequence) in both types, on the tensor-core path at hd 16, 32 and
   a ragged Sq of 1000 in bf16, and at recurrentgemma-2b's hd 256 (H 10,
   MQA, window 2048: a decode tick of 8 slots at offsets 64-4000 of a
   4096-row cache, a 3000-token prompt over 4096 keys) in both types, and
   at the shapes of phase 5b's other paths in both types (whisper-small's
   non-causal encoder over 4 x 1500 frames, its decoder's prompt, decode
   tick and cross-attention decode over the 1500-row memory; a decode tick
   of 8 slots over a 4096-row cache and a 1000-token prompt for
   internvl2-1b, hd 64 with 7 query heads a kv head, and for llama4 and
   arctic, hd 128 with 5 and 7); the
   build line lists every kernel function that spills (`spills`, from
   nvcc -Xptxas -v); every split-KV row (decode, one fused launch whose
   last block to arrive merges) also bit-equal to flash_combine over the
   partials that launch left in its own scratch, with every arrival
   counter back at 0, also at one split (a 64-row cache) and over
   back-to-back calls of growing B x KV; flash_combine itself within
   1e-5 in f32 and 1e-2 in bf16).  cache_access runs uniform rounds at
   B 8192 and 28000 and a round whose ids all hash into 4 sets (CACHE_ROWS),
   each with the host's time to enqueue one call; cache_bucket runs alone
   at 20,000 sets (five windows of keys) and at B 200,000
   (CACHE_BUCKET_ROWS) beside the launch floor (an empty launch under the
   same timer), at its largest set count, and refuses one more.
   frontier_read runs one batch's two hops of sampled positions through
   real topology stores (and int64 words, all-cold and all-hot stores),
   with the whole store call's host time beside the kernel's, and a bound
   that counts the cold words' 32-byte sectors at the peak PCIe Gen5 x16
   rate (the pinned H2D copy rate the run measures is printed beside it,
   `pcie_h2d_gbps`).  tiered_gather, tiered_gather_unique and
   store_fill also run as the device tier calls them (MAP_GATHER_CASES,
   MAP_UNIQUE_CASES, MAP_FILL_CASE: ~97k requests of 1024-d rows, ~74.5 %
   of them read from a compacted staged buffer through its int32 map),
   each exact against its plain version given the same map.
   relation_attend (R-GAT's attention) runs every relation's block at
   layer 0 of one 1024-seed batch of the rgat3-igbh cell, forward and
   backward each within 1e-5 of the plain formulas in float64 by norm,
   the backward bit-equal over two runs, timed beside the plain version
   and the einsum path it replaced; then one R-GAT step on that batch
   launches it forward and backward once per block with a destination
   and projects only the rows the slots name (`RGAT.last_rows`); then
   layer 0 of that batch, forward and backward, through the model's path
   (destinations scored through W folded into a_dst) and through the path
   before the fold (destination rows projected too), each held to the
   latter in float64: device ms, matrix-product ms, destination-score ms,
   rows projected.
   hgt_attend (HGT's softmax across every relation into a destination)
   runs each layer of one 1024-seed batch of the hgt3-igbh cell (its CSR
   and stacked k'/v' rows from `hgt_blocks`, 8 heads of 32), forward and
   backward each within 1e-5 of the plain formulas in float64 by norm and
   bit-equal over two runs, timed beside the plain version on the card
   against the hgt family's byte count; then one whole HGT step on that
   batch launches it forward and backward once per layer, counts its
   levels' rows, slots and distinct sources as the sampler's blocks hold
   them, and traces as many hgt_attend kernels as the family counts.
   gat_attend (GAT's attention over the fanout) runs each of the 6
   layer-levels of one 1024-seed batch of the gat3-igbs cell (the zd and
   zn GNN._layer hands it, 4 heads of 32, fanouts 10 and 5), forward and
   backward each within 1e-5 of the plain formulas in float64 and equal
   to the float32 eager chain to the bit, timed beside
   the eager chain on the card against its byte bound; then one whole GAT
   step on that batch launches it forward and backward once per
   layer-level and traces one gat_attend kernel each, its busy time beside
   the same step through the eager chain, whose parameters it equals to
   the bit.
   Times are CUDA-event medians of 20 launches after warm-up, with a 256 MB
   buffer written and a short device sleep before each launch, so that
   every launch starts from a cold L2 and the host's enqueue time is
   never timed.
3. The first main path: GraphSAGE training at the full width of
   examples/train_gnn_igb_torch.py (100k-node RMAT graph, 1024-d features,
   hidden 4096, batch 512, fanouts (10, 5)) through the `gids-device` data
   plane, for STEPS steps.  Every batch's features must equal the host
   features of its nodes bit for bit; at the PARITY steps (the cold first,
   a warm one whose hits the row store serves) every `tiered_gather` and
   `store_fill` call must equal its plain version on the same inputs,
   staged map included, the map must stage no hit, and the loss must
   agree with the loss computed through the plain versions to rtol 1e-5;
   every loss must be finite, the cache must hit, and every kernel's
   launch count over the run must be positive.  Each step prints the
   device tier's split and counts (staged rows, bytes copied).
4. The second main path: the same model and graph through
   `DataPlaneSpec.preset("gids-device", merge_execute=True, topology=True)`
   for MERGED_STEPS steps (two merged windows of 8 batches): each window's
   unique rows go through the device store once and are expanded per batch
   by `tiered_gather_unique`, and every sampling hop reads its adjacency
   words through the tiered edge-page store with one `frontier_read`
   launch (hot pages on the card, the rest read in place from the
   adjacency in pinned host memory).  Every batch's features must equal the host features bit
   for bit, every hop's words must equal `graph.indices[pos]`; at the
   first step of each window (MERGED_PARITY: the first cold, the second
   warm) every expansion and the fill must equal their plain versions on
   the same inputs, staged map included, and the loss the plain
   versions' to rtol 1e-5; every loss must
   be finite, every batch must carry priced sampling time, each of the
   path's kernels must be launched, and `frontier_read` exactly once per
   hop.  Each window prints the host time of its `frontier_gather` calls
   and their median (`frontier_call_ms`).
4b. The host planes: the same model and graph through `gids-async`
   (HOST_STEPS steps, `next_batch(compute_s=...)` given the last measured,
   synchronised train step) and `gids-merged-async` (HOST_STEPS steps, two
   merged windows consumed).  The numpy window cache decides hits and
   fills on the host; its row store on the card serves the hits through
   `tiered_gather` (`tiered_gather_unique` per batch of a merged window)
   and `store_fill` writes the lines a probe filled.  Gates: every batch's
   features equal the host features bit for bit when the batch is
   consumed, after later batches were staged; after every probe and every
   step each resident line of the row store holds its tag's row; step 0's
   loss agrees with the plain versions' (the first gather's plain version
   and `segment_mean_ref`) to rtol 1e-5; every loss is finite; every batch
   after the first (the first window on the merged plane) hits the cache;
   `exposed_prep_s <= prep_time_s`; the gather launched once per staged
   batch, `segment_mean` twice a step, and `store_fill` at all.  Each step
   prints its `next_batch` host ms split into the numpy probe, host
   staging, H2D, gather and fill of the probes it made, the train ms, the
   rows, hits and staged rows, the H2D bytes against the bytes the staged
   rows need, and the priced and exposed prep.  Then FEATURE_BATCHES
   batches each of `bam`, `mmap` and `pinned-host`, each checked bit for
   bit against the host features.
4c. Resumable training and the other samplers, at phase 3's width.
   RESUME: on `gids-async` (12 steps, checkpoint after 5, with prefetched
   batches staged) and on phase 4's merged topology plane (16 steps,
   checkpoint after 3, inside the first merged window), the steps run
   straight; then a fresh model and loader train up to the checkpoint,
   save `param_tree()` and `loader.state_dict()` through
   `repro_torch.train.checkpoint`, and a third model from another seed
   and a fresh loader restore them and train the rest.  Gates: the
   restored parameters, and every resumed batch's seeds, nodes, features
   and loss, equal the straight run's bit for bit; on the merged plane
   every hop's words equal `graph.indices[pos]`, `frontier_read` is
   launched once per hop, and the cache access, gather and fill are
   launched after the restore.  Prints the save and restore host ms and
   the bytes written.  A StepWatchdog(min_history=4) around every step
   prints its stragglers.  LADIES: fig15's sampler shape (batch 256,
   layer sizes 2048, 2048), LADIES["batches"] feature batches on `gids`
   and on `gids-device`: features bit for bit, 256 + 2048 + 2048
   requests, cache hits after the first batch; prints the sampling and
   `next_batch` ms.  SAMPLER: `device_sample_blocks` on fig7's IGB tiny,
   small and medium graphs (100k, 250k, 500k nodes), batch 512, fanouts
   (10, 5), seeds from `default_rng(0)`, a CUDA generator seeded 0: every
   call's shapes, dtype and neighbour-or-self-loop ids checked on the
   host; the median of 20 device calls and of 5 host calls, and their
   ratio; and the card's busy time for one call, measured with the
   launches queued behind a device-side sleep (with the host's enqueue
   time and the sleep's length beside it).
4d. The sharded, cluster, fault and adaptive planes, at phase 3's width.
   A (FAULT_PLANE): `gids-sharded` over 4 shards with the `adaptive`
   placement, 2-way replication and `fault_schedule()` (a 10x brownout of
   shard 2, an outage of shard 0, flaky reads on shard 1, hedged reads),
   FAULT["steps"] steps whose epochs of FAULT["epoch"] batches, counted in
   sampling order, draw their seeds from one shard of the degree table
   each.  B (CLUSTER_PLANE): `gids-hosts-merged` with `topology=True` over
   4 hosts, the metis-lite placement co-partitioned (built once and
   registered as METIS_BUILT), `topo_admission="adaptive"`, two merged
   windows of 8.  Gates: features bit for bit; on B every hop's words
   equal `graph.indices[pos]` with one `frontier_read` a hop, and some
   hops read after the topology refresh, whose device page table and hot
   pages must hold the new placement; step 0's loss within rtol 1e-5 of
   the plain versions'; finite losses; exposed prep <= prep; the priced
   sequence (prep, sampling, exposed prep, shard and remote rows and
   lines) equal, float for float, to a features-only twin loader's on the
   CPU; at least one committed migration, faulted burst and rerouted read
   on A and one topology refresh on B; the gather launched once a batch
   and `segment_mean` twice a step.  On A the state saved after
   FAULT["resume_at"] steps carries `tier_state` and `fault_state`, goes
   through `train.checkpoint` and comes back equal, and a fresh card
   loader and a fresh CPU twin restored from it deliver the remaining
   batches: nodes and features as the straight run's, `tiered_gather` and
   `store_fill` launched once a batch, priced prep equal to each other's.
   Prints each step's `next_batch` host ms
   split as in phase 4b with the host ms of pricing and feedback, each
   burst's prep, straggler, imbalance (remote fraction on B), the
   migrations, refreshes, hedged bursts and rerouted reads, and the
   metis-lite build seconds and cut-edge fraction.
4e. The observability plane and online GNN serving, at phase 3's width.
   First traced twins of two earlier paths, features only: phase 4's
   merged topology plane (TRACED[TRACED_MERGED] batches) and phase 4d's
   plane A (TRACED[TRACED_FAULT]), each loader run from the same seed
   untraced and with a `repro_torch.obs.Tracer`.  Gates: prep floats,
   blocks and features bit-equal; every batch span equal to its
   `prep_time_s` within RECONCILE_EPS; the trace written by `Tracer.write`
   into a temporary directory passes `validate_trace`; plane A's trace
   holds fault-recovery spans and `controller.*` counters; on phase 4's
   plane one `frontier_read` per sampled hop.  Then the GNN serve engine
   (`repro_torch.serve.GNNServeEngine`, `INTEL_OPTANE` pricing, fanouts
   (10, 5)) with the GraphSAGE of phase 3 on the card, each run beside a
   CPU twin (the same engine on `device="cpu"` over a clone of the same
   stream): S1 `serve-gnn` merged, 2 tenants, quotas (3, 1), adaptive
   quotas, GNN_SERVE["requests"] requests of benchmarks/fig_serve_load.py's
   two tenant mixes at GNN_SERVE["qps"] of virtual time, traced, then
   again untraced; S2 its first GNN_SERVE["per_request"] requests served
   per request (`tiered_gather`); S3 benchmarks/fig_faults.py's serve
   scenario (shard 0 browns out 10x from burst 3, the brownout ladder on,
   a 256-line cache, without the model: the ladder shrinks the fanouts
   the GNN is built for); S4 `serve-gnn-shared` merged over
   GNN_SERVE["shared"] requests.  Gates: every record's priced floats,
   the p50, p99, goodput, attainment, hit ratios and quota trace equal
   the twin's; every kept row (stale rows too) equals the host features
   of its nodes bit for bit; the first GNN_SERVE["logits"] served
   requests' logits of S1 agree within rtol 1e-5 with the same forward
   through `segment_mean_ref`; the row store is coherent after every run,
   right after each repartition and after the probe that follows it; S1
   repartitions at least once; its request spans equal their latency
   within RECONCILE_EPS and its written trace validates; the untraced S1
   gives the traced run's records; S3 serves at least one request stale
   and sheds one; `frontier_read` is launched once per sampled hop.
   Prints each S1 window's wall ms split into sampling, tenant probe,
   host staging, H2D, gather, fill and forward, each run's medians,
   requests served per wall second, peak memory, the priced p99 and
   goodput (model time), and the `modelled_vs_measured` medians.
5. LM serving at the full published width of qwen2-1.5b (28 layers,
   d_model 1536, 12 heads, GQA kv 2, hd 128, d_ff 8960, padded vocab
   153600, 1,546,270,208 parameters) with `attn_impl="flash"`, weights
   drawn on the card from a fixed CUDA generator.  Gates in f32 with TF32
   off: teacher-forced logits of one GATE["prompt"]-token prompt through
   `forward`, and through `prefill` plus GATE["steps"] decode steps, on the
   flash path against the einsum path's `forward` within GATE["tol"]; then
   3 prompts through a 2-slot `ServeEngine` give the tokens of
   single-request greedy decoding.  Then it serves in bf16 (the config's
   dtypes): SERVE["requests"] requests with prompt lengths from
   `default_rng(0).integers(64, 1025, 16)` and SERVE["new_tokens"] new
   tokens each through `EngineConfig(slots=8, max_seq=2048)`.  Every
   request must retire with its tokens, the slot pool must end empty,
   every logit must be finite, and `flash_attention` must have launched
   exactly 28 x (prefills + decode ticks) times and `flash_combine` never
   (every tick's split-KV attention merges in its own launch).  Prints
   prefill ms per request against prompt length, decode ms per tick,
   tokens/s and peak
   memory.  After the counted run, `torch.profiler` traces one 1024-token
   prefill and PROFILE_TICKS decode ticks at 8 active slots and prints the
   card's busy time per tick and its top kernels.
5b. The other LM families at full width, each model built, served and
   freed before the next (FAMILIES, FAMILY_GATES).  f32 gates with TF32
   off, as phase 5's: recurrentgemma-2b at full width and depth over a
   2300-token prompt (its local window of 2048 masks in prefill and
   decode; one engine prompt of 2100 tokens) and arctic-480b at 1 layer
   (top-2 MoE with the dense residual, capacity factor E / k: lossless
   routing, so that engine and greedy tokens may be held equal): flash
   against
   einsum logits and prefill + 16 decode steps within 1e-3, engine tokens
   equal to greedy decoding.  Then bf16 through ServeEngine with
   `attn_impl="flash"`, 8 slots: recurrentgemma-2b, mamba2-1.3b and
   internvl2-1b (text requests) at full width and depth, and
   llama4-maverick at 2 layers (one dense, one MoE) and arctic at 1 at
   full width with their published capacity factors, over phase 5's 16
   prompt lengths with the last one 3000, 4096 rows; internvl2 also decodes
   a static batch of 4 prompts with 256 patches each; whisper-small
   prefills 4 x 1500 frames and decodes 32 tokens through the raw steps.
   Gates: every request retires with its tokens, the slot pool ends
   empty, every logit is finite, and `flash_attention` launched exactly
   (attention layers) x (prefills + decode steps) (+ 12 encoder layers a
   whisper prefill and 12 cross-attention layers a whisper decode step)
   and `flash_combine` never.  Prints each model's
   parameters, init seconds and peak, prefill ms by prompt length, decode
   ms per tick, tokens/s and peak memory.
5c. LM training (TRAIN, TRAIN_RESUME, TRAIN_GATE, TRAIN_FAMILIES).  An
   f32 gate with TF32 off: one train step of the reduced qwen2 from
   parameters drawn on the card, its loss and grad norm within 1e-5
   relative of a plain f32 re-computation of qwen2's loss written in the
   phase.  Then qwen2-1.5b at full published width and depth through
   `repro_torch.launch.train.build` (bf16 weights, AdamW with f32 master,
   m and v, remat, the trainer's cosine schedule warming up over 5 steps),
   batch 8 x 1024, TRAIN["steps"] steps on tests/test_system.py:25's
   learnable stream through the TokenPipeline.  Gates: the published
   parameter count; the first step (rate 0) moves no parameter; every
   loss and grad norm finite; the mean of the last 5 losses below half
   the first 5's; no kernel of the port launched (training runs the
   einsum attention).  Prints the median step ms after the first,
   tokens/s, `mfu` (6 N tokens over the step time at 989 TFLOP/s), the
   resident and peak memory, and each step's forward+backward and
   optimizer ms by CUDA events.  The resume gate, deterministic
   algorithms on: the same model cut to 2 layers, 12 steps straight, and
   6 + `train.checkpoint` save + restore into a model from another seed
   and a fresh pipeline + 6; every parameter and optimizer-state leaf and
   every later loss bit-equal to the straight run's (prints save and
   restore ms and the bytes written to a temporary directory, which
   phase 6d restores from and then deletes).  One step of recurrentgemma-2b, mamba2-1.3b, internvl2-1b
   (patches from `FeatureStore.synthetic` through the pipeline),
   whisper-small (frames drawn here) and arctic-480b (Adafactor) at their
   reduced configs in bf16: finite loss and grad norm, every leaf moved.
   Last, a flash-configured model asked for a gradient must raise.
   Phase 5c also starts examples/quickstart_torch.py --device cpu in a
   background process (phase 6e's twin) and keeps the gradients of one
   more full-width step (phase 6c's input).
6. The launch and distributed modules.  6a: the meta-device dry-run
   (`repro_torch.launch.dryrun.run_cell`) over DRYRUN_CELLS, each
   record's status, bottleneck, compute / memory / collective terms, peak
   GiB per device and useful ratio; gates: the expected statuses, finite
   positive terms.  6b: phase 5c's own step built as a `Cell` by hand
   (qwen2-1.5b full, batch 8 x 1024, AdamW, remat, the trainer's
   schedule) on `make_host_mesh()` and costed on meta; its predicted
   compute, memory and step terms and peak beside phase 5c's measured
   step, peak and matmul / element-wise busy ms.  Gates: the roofline's
   step is at most the measured one; the counted FLOPs lie within
   [6 N T, 9 N T + the einsum attention's].  6c:
   `compress_grads` over phase 5c's gradient tree (bf16, f32 error),
   COMPRESS["calls"] times with error feedback, each call timed by CUDA
   events against its bytes bound (two passes over g and e, one write of
   each output: 20 B an element) and the eager byte count; gates: every
   leaf's residual within s/2 + 1e-7, the telescoping bound of
   tests/test_optimizer.py:66-83, COMPRESS["cpu_leaves"] bit-equal to the
   port's CPU run on the same inputs, `psum_compressed` over the host mesh
   the identity.  6d: phase 5c's 2-layer resume checkpoint restored with
   `shardings=` (the tp param specs and their ZeRO-1 AdamW specs) onto
   the host mesh: every leaf a DTensor on the card, placed as its spec,
   bit-equal to the tree that was saved.  6e: examples/quickstart_torch.py
   --device cuda in this process: every line it prints but the wall-clock
   ones equal to the CPU twin's, and the host planes' kernels launched.
7. One JSON line `{"kernels": [...]}` and, last, one JSON line naming the
   device.

    python3 chip_smoke.py --plant-fault band_edge|full_lo

builds flash_attention.cu with a known fault planted (FAULTS) into a
temporary directory, and shows that phase 2's bf16 gate passes the sound
kernel and rejects the faulty one on the same inputs.

    python3 chip_smoke.py --segment-mean-variants

times the segment_mean kernel beside copies of it built with another
order of its work, another batch of loads in flight or another scalar
chunk, and beside the block-per-destination kernel it replaced
(SEGMENT_MEAN_VARIANTS), in turns on the same inputs at every phase-2
segment_mean row.

    python3 chip_smoke.py --flash-decode-variants

times the fused split-KV decode beside the two-launch path it replaced
(the split kernel with its merge compiled out, then flash_combine), in
turns on the same inputs at every split-KV row of phase 2, and gates the
split-KV instances' register spills (SPLIT_SPILL_LIMIT).

    python3 chip_smoke.py --cache-variants

times cache_access (its walk launched early through programmatic dependent
launch) and its one-launch cache_bucket beside copies built with the walk
launched in plain stream order, with the match in every group of the
placement pass, with 32-bit counters where the sort uses 16-bit ones,
and with clusters of 1, 4 and 16 blocks (CACHE_VARIANTS), in turns at
every CACHE_ROWS row, each exact against access_ref.

    python3 chip_smoke.py --cache-ab [TREE]

builds the kernels of TREE, a directory inside this checkout (default:
the checkout itself; for example an earlier commit unpacked with `git
archive` into a git-ignored directory), runs
phase 2's cache rows and phase 3's path against that tree's package, and
phase 3 again under `torch.profiler`: the device operations and the cache
kernels' launches and device ms per step.  Run it on two trees in turns
(A, B, B, A) in one call to compare them on one card.

    python3 chip_smoke.py --tier-ab [TREE]

builds the kernels of TREE (as --cache-ab) and runs phases 3 and 4
against its package: each step's and each merged window's device-tier
split and counts (rows, hits, staged rows, bytes copied, where the tree's
tier keeps them), the launches, and every row kernel held against its
plain version on the path's inputs at the PARITY and MERGED_PARITY steps.
Run it on two trees in turns in one call to compare them on one card.

    python3 chip_smoke.py --relation-attend

builds the kernels and runs phase 2's relation_attend rows alone (the
kernel rows, the step's launches and rows, layer 0 both ways).

    python3 chip_smoke.py --hgt-attend

builds the kernels and runs phase 2's hgt_attend rows alone (a row a
layer, the step's launches, rows and traced kernels).

    python3 chip_smoke.py --gat-attend

builds the kernels and runs phase 2's gat_attend rows alone (a row a
layer-level, the step's launches, traced kernels and busy time).

The script imports torch, numpy and the port (src/repro_torch, or
TREE/src with --cache-ab) only, and for the relation_attend, hgt_attend
and gat_attend rows the benchmark's graph generators and byte counts
(bench/families/rgat.py, bench/families/hgt.py, bench/rmat.py,
bench/inputs.py) and the rgat3-igbh, hgt3-igbh and gat3-igbs
configurations.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
STEPS = 8
MERGED_STEPS = 16
#: phase 3's steps whose row kernels are held against their plain versions
#: on the path's inputs: the cold first and a warm one; phase 4's: the
#: first step of each of its two merged windows of 8 batches
PARITY = (0, STEPS - 1)
MERGED_PARITY = (0, 8)
#: the full width of examples/train_gnn_igb_torch.py, where phases 3 and 4
#: train, and the card they train on
FULL = dict(nodes=100_000, dim=1024, hidden=4096, batch=512,
            cache_lines=1 << 14)
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12       # f32 outside the tensor cores, same
BF16_FLOPS_PER_S = 989e12     # bf16 tensor cores, dense, same
#: PCIe Gen5 x16, one direction, after 128b/130b encoding (the data sheet's
#: 128 GB/s counts both directions): the peak for reads of host memory
PCIE_H2D_BYTES_PER_S = 63e9
#: phase 5: the f32 gate and the bf16 serving run
GATE = dict(prompt=512, steps=16, tol=1e-3)
SERVE = dict(slots=8, max_seq=2048, requests=16, new_tokens=32)
PROFILE_TICKS = 4
REPS, WARMUP = 20, 3
SLEEP_CYCLES = 1_000_000      # ~0.5 ms of device time before each timed call


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# -- phase 1 -------------------------------------------------------------------

def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def card_and_build(torch):
    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    for name in _build.SOURCES:
        _build.library(name)
    seconds = time.perf_counter() - t0
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": round(seconds, 3),
          "compiled": sorted(logs), "ptxas": ptxas,
          "spills": {name: ptxas_spills(log) for name, log in logs.items()}})


def ptxas_spills(log: str) -> dict:
    """The functions of one nvcc -Xptxas -v report that spill: mangled name
    -> its 'N bytes stack frame, N bytes spill stores, N bytes spill loads'
    line."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif fn and "spill stores" in line:
            counts = [int(w) for w in line.replace(",", " ").split()
                      if w.isdigit()]
            if any(counts[1:]):       # spill stores or loads
                out[fn] = line.strip()
            fn = None
    return out


# -- phase 2 -------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of one call, over REPS calls after WARMUP,
    with `setup()` (untimed) and an L2 flush before each call.  A short
    device-side sleep after the flush keeps the card busy while the host
    enqueues the call, so the events time the device's work and never the
    wrapper's Python (the flush alone did not always cover it)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, setup=None, reps=REPS) -> float:
        torch = self.torch
        args = setup() if setup else ()
        for _ in range(WARMUP):
            fn(*args)
            args = setup() if setup else ()
        times = []
        for _ in range(reps):
            args = setup() if setup else ()
            self.flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def host_ms(fn, setup, reps=3) -> float:
    times = []
    for _ in range(reps):
        args = setup()
        t0 = time.perf_counter()
        fn(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes: int, flops: int = 0,
          flops_per_s: float = F32_FLOPS_PER_S) -> dict:
    """The least time the card could take for the work: the bytes it must
    move over the memory rate, or its operations over the peak rate for
    their type (f32 on the vector units by default), whichever is
    larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


SUMMARY_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")


def summary(rows: list[dict]) -> dict:
    """One kernel's numbers per training step: the sum over the launches
    a step makes at the main path's shapes."""
    return {"ms": sum(r["kernel_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                         else "operations"),
            "library_ms": (None if rows[0]["library_ms"] is None
                           else sum(r["library_ms"] for r in rows)),
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


#: segment_mean's rows: (B, F, D), the first two layer 0's aggregations
#: per training step over an (8192, 1024) table; then fanouts across the
#: kernel's batch of 8 neighbours (1, 3, 9, 33), a 1000-wide row (16-byte
#: loads) and a 1001-wide one (the scalar path)
SEGMENT_MEAN_CASES = ((512, 10, 1024), (5120, 5, 1024), (512, 1, 1024),
                      (512, 3, 1024), (512, 9, 1024), (512, 33, 1024),
                      (512, 10, 1000), (512, 10, 1001))


def kernel_segment_mean(torch, timer, gen):
    """SEGMENT_MEAN_CASES in f32 and bf16 over 8192-row tables, within 1e-6
    (f32) and 2e-2 (bf16) of the plain version; the main path's numbers
    are the first two cases in f32."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    N = 8192
    tables = {D: torch.randn((N, D), generator=gen, device="cuda")
              for D in sorted({c[2] for c in SEGMENT_MEAN_CASES})}
    main = []
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        for B, Fo, D in SEGMENT_MEAN_CASES:
            feats = tables[D].to(dtype)
            idx = torch.randint(0, N, (B, Fo), generator=gen, device="cuda",
                                dtype=torch.int32)
            out = ops.segment_mean(idx, feats)
            want = ref.segment_mean_ref(idx, feats)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            check(torch.allclose(out.float(), want.float(), rtol=tol,
                                 atol=tol),
                  f"segment_mean {dtype} ({B},{Fo},{D}) max_abs_err {err}")
            idx64 = idx.long()
            nbytes = (int(torch.unique(idx).numel()) * D
                      * feats.element_size()
                      + B * D * feats.element_size() + idx.numel() * 4)
            row = {"phase": "kernel", "name": "segment_mean",
                   "dtype": str(dtype).removeprefix("torch."),
                   "shape": [B, Fo, N, D], "max_abs_err": err,
                   "kernel_ms": timer(lambda: ops.segment_mean(idx, feats)),
                   "plain_ms": timer(
                       lambda: ref.segment_mean_ref(idx, feats)),
                   "library_ms": timer(lambda: F.embedding_bag(
                       idx64, feats, mode="mean")),
                   **bound(nbytes, flops=B * Fo * D + B * D)}
            emit(row)
            if dtype == torch.float32 and len(main) < 2:   # the main path's
                main.append(row)
            del feats
    return summary(main)


#: the device tier's shapes at the benchmark cells' widths: ~97k requests a
#: step, about a quarter served from a 32,768-line row store of 1024-d rows
#: and the rest (MAP_MISS) read from the compacted staged buffer through
#: its map; then a ragged bf16 row.  tiered_gather: (B, L, D, dtype);
#: tiered_gather_unique: (U, L, D, N, dtype), N rows of one batch;
#: store_fill: (L, B, D)
MAP_MISS = 0.745
MAP_GATHER_CASES = ((97_000, 32_768, 1024, "float32"),
                    (1001, 512, 1001, "bfloat16"))
MAP_UNIQUE_CASES = ((97_000, 32_768, 1024, 48_500, "float32"),
                    (28_000, 16_384, 1000, 8191, "bfloat16"))
MAP_FILL_CASE = (32_768, 97_000, 1024)


def _served_slots(torch, gen, B, L):
    """(B,) int32 serve slots: a row-store line for about 1 - MAP_MISS of
    the requests, -1 (read from the staged buffer) for the rest."""
    slots = torch.randint(0, L, (B,), generator=gen, device="cuda",
                          dtype=torch.int32)
    miss = torch.rand((B,), generator=gen, device="cuda") < MAP_MISS
    return slots.masked_fill(miss, -1)


def _compacted(torch, gen, slots, D, dtype):
    """(staged, staged_map) as the device tier hands them to the kernels:
    one random row for each request with slot -1, compacted in request
    order, and each request's row in that buffer (-1 elsewhere)."""
    need = slots < 0
    staged = torch.randn((int(need.sum()), D), generator=gen,
                         device="cuda").to(dtype)
    order = need.to(torch.int32).cumsum(0, dtype=torch.int32) - 1
    return staged, torch.where(need, order, -1).to(torch.int32)


def kernel_tiered_gather(torch, timer, gen):
    """B = 8192 requests, about half hits, over a 16384-line row store of
    1024-d f32 rows; then ragged widths and an odd B, exact."""
    from repro_torch.kernels import ops, ref
    main = None
    for B, L, D, dtype in ((8192, 16384, 1024, torch.float32),
                           (8191, 4096, 1000, torch.float32),
                           (1001, 512, 1001, torch.float32),
                           (1001, 512, 1001, torch.bfloat16)):
        cache = torch.randn((L, D), generator=gen, device="cuda").to(dtype)
        staged = torch.randn((B, D), generator=gen, device="cuda").to(dtype)
        slots = torch.randint(0, L, (B,), generator=gen, device="cuda",
                              dtype=torch.int32)
        miss = torch.rand((B,), generator=gen, device="cuda") < 0.5
        slots = slots.masked_fill(miss, -1)
        out = ops.tiered_gather(slots, cache, staged)
        want = ref.tiered_gather_ref(slots, cache, staged)
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"tiered_gather ({B},{L},{D}) {dtype}")
        nbytes = 2 * B * D * cache.element_size() + B * 4
        row = {"phase": "kernel", "name": "tiered_gather",
               "dtype": str(dtype).removeprefix("torch."),
               "shape": [B, L, D], "max_abs_err": 0.0,
               "kernel_ms": timer(lambda: ops.tiered_gather(slots, cache,
                                                            staged)),
               "plain_ms": timer(lambda: ref.tiered_gather_ref(slots, cache,
                                                               staged)),
               "library_ms": None, **bound(nbytes)}
        emit(row)
        main = main or summary([row])        # the first is the main path's
    for B, L, D, dtype in MAP_GATHER_CASES:
        dtype = getattr(torch, dtype)
        cache = torch.randn((L, D), generator=gen, device="cuda").to(dtype)
        slots = _served_slots(torch, gen, B, L)
        staged, staged_map = _compacted(torch, gen, slots, D, dtype)
        out = ops.tiered_gather(slots, cache, staged, staged_map)
        want = ref.tiered_gather_ref(slots, cache, staged, staged_map)
        torch.cuda.synchronize()
        check(torch.equal(out, want),
              f"tiered_gather with a staged map ({B},{L},{D}) {dtype}")
        M = staged.shape[0]
        nbytes = 2 * B * D * cache.element_size() + B * 4 + M * 4
        emit({"phase": "kernel", "name": "tiered_gather",
              "dtype": str(dtype).removeprefix("torch."), "staged_map": True,
              "shape": [B, L, D], "staged_rows": M, "max_abs_err": 0.0,
              "kernel_ms": timer(lambda: ops.tiered_gather(
                  slots, cache, staged, staged_map)),
              "plain_ms": timer(lambda: ref.tiered_gather_ref(
                  slots, cache, staged, staged_map)),
              "library_ms": None, **bound(nbytes)})
    return main


def kernel_tiered_gather_unique(torch, timer, gen):
    """One batch's expansion of a merged window: U = 28000 unique rows,
    about half hits in a 16384-line row store of 1024-d f32 rows, N = 8192
    output rows through a unique inverse; then a ragged width with an odd
    N, and bf16; exact."""
    from repro_torch.kernels import ops, ref
    main = None
    for U, L, D, N, dtype in ((28000, 16384, 1024, 8192, torch.float32),
                              (28000, 16384, 1000, 8191, torch.float32),
                              (28000, 16384, 1024, 8192, torch.bfloat16)):
        cache = torch.randn((L, D), generator=gen, device="cuda").to(dtype)
        staged = torch.randn((U, D), generator=gen, device="cuda").to(dtype)
        slots = torch.randint(0, L, (U,), generator=gen, device="cuda",
                              dtype=torch.int32)
        miss = torch.rand((U,), generator=gen, device="cuda") < 0.5
        slots = slots.masked_fill(miss, -1)
        # a batch's rows are distinct unique rows of its window
        inverse = torch.randperm(U, generator=gen, device="cuda")[:N] \
            .to(torch.int32)
        out = ops.tiered_gather_unique(slots, cache, staged, inverse)
        want = ref.tiered_gather_unique_ref(slots, cache, staged, inverse)
        torch.cuda.synchronize()
        check(torch.equal(out, want),
              f"tiered_gather_unique ({U},{L},{D},{N}) {dtype}")
        nbytes = 2 * N * D * cache.element_size() + 8 * N
        row = {"phase": "kernel", "name": "tiered_gather_unique",
               "dtype": str(dtype).removeprefix("torch."),
               "shape": [U, L, D, N], "max_abs_err": 0.0,
               "kernel_ms": timer(lambda: ops.tiered_gather_unique(
                   slots, cache, staged, inverse)),
               "plain_ms": timer(lambda: ref.tiered_gather_unique_ref(
                   slots, cache, staged, inverse)),
               "library_ms": None, **bound(nbytes)}
        emit(row)
        main = main or summary([row])        # the first is the main path's
    for U, L, D, N, dtype in MAP_UNIQUE_CASES:
        dtype = getattr(torch, dtype)
        cache = torch.randn((L, D), generator=gen, device="cuda").to(dtype)
        slots = _served_slots(torch, gen, U, L)
        staged, staged_map = _compacted(torch, gen, slots, D, dtype)
        inverse = torch.randperm(U, generator=gen, device="cuda")[:N] \
            .to(torch.int32)
        out = ops.tiered_gather_unique(slots, cache, staged, inverse,
                                       staged_map)
        want = ref.tiered_gather_unique_ref(slots, cache, staged, inverse,
                                            staged_map)
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"tiered_gather_unique with a staged "
                                      f"map ({U},{L},{D},{N}) {dtype}")
        from_staged = int((slots[inverse.long()] < 0).sum())
        nbytes = 2 * N * D * cache.element_size() + 8 * N + 4 * from_staged
        emit({"phase": "kernel", "name": "tiered_gather_unique",
              "dtype": str(dtype).removeprefix("torch."), "staged_map": True,
              "shape": [U, L, D, N], "staged_rows": staged.shape[0],
              "max_abs_err": 0.0,
              "kernel_ms": timer(lambda: ops.tiered_gather_unique(
                  slots, cache, staged, inverse, staged_map)),
              "plain_ms": timer(lambda: ref.tiered_gather_unique_ref(
                  slots, cache, staged, inverse, staged_map)),
              "library_ms": None, **bound(nbytes)})
    return main


def kernel_frontier_gather(torch, timer, gen):
    """The two hops of one batch on the topology plane: hop 1 (P = 830
    unique pages, N = 15070 reads) and hop 0 (P = 210, N = 2950) over the
    H = 278 hot pages of 1024 int32 words, about a third of the pages hot;
    then int64 words and a zero-budget store (one dummy hot row, every slot
    -1); exact.  Bytes count what the reads need: inverse and offset per
    read, one slot per page, each distinct word once, the output."""
    from repro_torch.kernels import ops, ref
    rows = []
    for H, P, N, dtype in ((278, 830, 15070, torch.int32),
                           (278, 210, 2950, torch.int32),
                           (278, 830, 15070, torch.int64),
                           (1, 830, 15070, torch.int32)):
        W = 1024
        hot = torch.randint(0, 1 << 30, (H, W), generator=gen,
                            device="cuda").to(dtype)
        staged = torch.randint(0, 1 << 30, (P, W), generator=gen,
                               device="cuda").to(dtype)
        slots = torch.randint(0, H, (P,), generator=gen, device="cuda",
                              dtype=torch.int32)
        if H == 1:
            slots.fill_(-1)
        else:
            slots = slots.masked_fill(
                torch.rand((P,), generator=gen, device="cuda") < 0.66, -1)
        inverse = torch.randint(0, P, (N,), generator=gen, device="cuda",
                                dtype=torch.int32)
        offsets = torch.randint(0, W, (N,), generator=gen, device="cuda",
                                dtype=torch.int32)
        args = (slots, hot, staged, inverse, offsets)
        out = ops.tiered_frontier_gather(*args)
        want = ref.frontier_gather_ref(*args)
        torch.cuda.synchronize()
        check(out.dtype == dtype and torch.equal(out, want),
              f"frontier_gather ({H},{P},{N}) {dtype}")
        w = hot.element_size()
        words = int(torch.unique(inverse.long() * W + offsets).numel())
        nbytes = N * 8 + P * 4 + words * w + N * w
        row = {"phase": "kernel", "name": "frontier_gather",
               "dtype": str(dtype).removeprefix("torch."),
               "shape": [H, W, P, N], "max_abs_err": 0.0,
               "kernel_ms": timer(lambda: ops.tiered_frontier_gather(*args)),
               "plain_ms": timer(lambda: ref.frontier_gather_ref(*args)),
               "library_ms": None, **bound(nbytes)}
        emit(row)
        rows.append(row)
    return summary(rows[:2])                 # the two hops of one batch


def pcie_h2d_gbps(torch) -> float:
    """The card's pinned host-to-device copy rate in GB/s: the median of 5
    CUDA-event timed copies of 256 MB."""
    n = 256 << 20
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return n / (statistics.median(times[1:]) * 1e-3) / 1e9


def _hop_positions(np, graph):
    """The edge positions of one batch's two hops, as the sampler hands
    them to `frontier_gather`: 512 seeds, fanouts (10, 5)."""
    from repro_torch.sampling.neighbor import run_sample_hops
    rng = np.random.default_rng(0)
    seeds = rng.choice(graph.num_nodes, FULL["batch"], replace=False)
    hops = []

    def read(pos):
        hops.append(pos)
        return graph.indices[pos]
    run_sample_hops(graph, seeds, (10, 5), rng, read_words=read)
    return hops


def kernel_frontier_read(torch, timer, np):
    """One batch's two hops through real topology stores over phase 3's
    graph (100k nodes, 1,136,958 edges): hop 1 (5120 x 5 positions) and
    hop 0 (512 x 10) on phase 4's store (degree admission, 0.25 hbm / 0.5
    host); then hop 1 with int64 words (512-word pages), on a store with no
    hot page (all cold) and on one with every page hot.  Exact against the
    plain version (on the card, the host words copied to the card) and
    against graph.indices.  `call_ms` is the host clock around the store's whole
    `frontier_gather` call (H2D, launch, D2H), median of 20.  The bound
    counts device-memory bytes (each position, page-table entry and
    distinct hot word read once, each word written once) at 3.35 TB/s and
    the distinct 32-byte sectors of the host words read over PCIe at the
    link's peak (PCIE_H2D_BYTES_PER_S), and takes the larger; the run's
    own pinned H2D copy rate is printed beside it.  Also shows that the
    C entry point refuses pageable host memory (cudaErrorInvalidValue, 1)
    and returns the device mapping of pinned memory."""
    import ctypes
    import dataclasses
    from repro_torch.core.topology import TieredTopologyStore
    from repro_torch.graph.synthetic import rmat_graph
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import tiered_gather as ttg
    gbps = pcie_h2d_gbps(torch)
    emit({"phase": "kernel", "name": "pcie_h2d", "pcie_h2d_gbps": gbps})
    graph = rmat_graph(FULL["nodes"], 12, FULL["dim"], seed=0)
    wide = dataclasses.replace(graph, indices=graph.indices.astype(np.int64))
    hop0, hop1 = _hop_positions(np, graph)
    cases = (("hop1", graph, 0.25, 0.5, hop1), ("hop0", graph, 0.25, 0.5, hop0),
             ("hop1_int64", wide, 0.25, 0.5, hop1),
             ("hop1_all_cold", graph, 0.0, 0.5, hop1),
             ("hop1_all_hot", graph, 1.0, 0.0, hop1))
    rows = []
    for case, g, gpu, host, pos_np in cases:
        store = TieredTopologyStore.from_graph(
            g, gpu_fraction=gpu, host_fraction=host, device="cuda")
        table, hot, words = store.page_table, store.hot_pages(), \
            store.host_words()
        check(words.is_pinned(),
              f"frontier_read {case}: host words not pinned")
        pos = torch.from_numpy(pos_np.reshape(-1)).cuda()
        want_np = g.indices[pos_np.reshape(-1)]
        words_dev = words.cuda()
        out = ops.frontier_read(pos, table, hot, words)
        want = ref.frontier_read_ref(pos, table, hot, words_dev)
        torch.cuda.synchronize()
        check(out.dtype == want.dtype and torch.equal(out, want)
              and np.array_equal(out.cpu().numpy(), want_np),
              f"frontier_read {case}")
        check(np.array_equal(store.frontier_gather(pos_np),
                             g.indices[pos_np]),
              f"frontier_read {case}: the store's call")
        W, w = store.page_words, hot.element_size()
        page = pos // W
        s = table[page].long()
        hot_words = int(torch.unique((s * W + pos % W)[s >= 0]).numel())
        sectors = int(torch.unique(pos[s < 0] * w // 32).numel())
        hbm_bytes = (pos.numel() * 8 + int(torch.unique(page).numel()) * 4
                     + hot_words * w + pos.numel() * w)
        hbm_ms = hbm_bytes / HBM_BYTES_PER_S * 1e3
        pcie_ms = sectors * 32 / PCIE_H2D_BYTES_PER_S * 1e3
        for _ in range(WARMUP):
            store.frontier_gather(pos_np)
        row = {"phase": "kernel", "name": "frontier_read", "case": case,
               "dtype": str(hot.dtype).removeprefix("torch."),
               "shape": [pos.numel(), W, hot.shape[0], words.shape[0]],
               "cold_reads": int((s < 0).sum()), "max_abs_err": 0.0,
               "kernel_ms": timer(lambda: ops.frontier_read(pos, table, hot,
                                                            words)),
               "plain_ms": timer(lambda: ref.frontier_read_ref(
                   pos, table, hot, words_dev)),
               "call_ms": host_ms(lambda: store.frontier_gather(pos_np),
                                  lambda: (), reps=REPS),
               "library_ms": None, "bytes": hbm_bytes,
               "pcie_sectors": sectors, "pcie_h2d_gbps": gbps,
               "hbm_bound_ms": hbm_ms, "pcie_bound_ms": pcie_ms,
               "bound_ms": max(hbm_ms, pcie_ms), "bound_by": "bytes",
               "bound_link": "hbm" if hbm_ms >= pcie_ms else "pcie"}
        emit(row)
        rows.append(row)
        del store, words_dev
    # the device mapping: pinned memory has one, pageable memory none
    fn = _build.function("frontier_gather", "frontier_mapped_pointer",
                         (_build.P, ctypes.POINTER(ctypes.c_void_p)))
    pageable = np.zeros(1 << 16, np.int32)
    err = fn(pageable.ctypes.data, ctypes.byref(ctypes.c_void_p()))
    pinned = torch.zeros(1 << 16, dtype=torch.int32, pin_memory=True)
    check(err == 1 and ttg.mapped_pointer(pinned) != 0,
          f"frontier_mapped_pointer returned {err} for pageable memory")
    emit({"phase": "kernel", "name": "frontier_read", "case": "mapping",
          "pageable_refused_with": err})
    main = summary(rows[:2])                 # the two hops of one batch
    main.update({"call_ms": rows[0]["call_ms"] + rows[1]["call_ms"],
                 "pcie_h2d_gbps": gbps})
    return main


def kernel_store_fill(torch, timer, gen):
    """The row-store fill of one step: about 30% of 16384 lines refilled
    from an (8192, 1024) f32 staged buffer, in place, exact.  The library
    yardstick is `index_copy_` of the filled lines' rows, their source
    gathered by `index_select` in the same timed call (no one call does
    both; the filled lines and their fillers are found outside it)."""
    from repro_torch.kernels import ops, ref
    L, B, D = 16384, 8192, 1024
    rows = torch.randn((L, D), generator=gen, device="cuda")
    staged = torch.randn((B, D), generator=gen, device="cuda")
    filler = torch.randint(0, B, (L,), generator=gen, device="cuda",
                           dtype=torch.int32)
    keep = torch.rand((L,), generator=gen, device="cuda") >= 0.3
    last_filler = filler.masked_fill(keep, -1)
    got, want = rows.clone(), rows.clone()
    ops.store_fill(got, last_filler, staged)
    ref.store_fill_ref(want, last_filler, staged)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "store_fill")
    n_filled = int((last_filler >= 0).sum())
    lines = (last_filler >= 0).nonzero()[:, 0]
    src = last_filler[lines].long()
    lib = rows.clone().index_copy_(0, lines, staged.index_select(0, src))
    check(torch.equal(lib, want), "store_fill: index_copy_ yardstick")
    nbytes = 2 * n_filled * D * 4 + L * 4
    row = {"phase": "kernel", "name": "store_fill", "dtype": "float32",
           "shape": [L, B, D], "filled": n_filled, "max_abs_err": 0.0,
           "kernel_ms": timer(lambda r: ops.store_fill(r, last_filler, staged),
                              setup=lambda: (rows.clone(),)),
           "plain_ms": timer(lambda r: ref.store_fill_ref(r, last_filler,
                                                          staged),
                             setup=lambda: (rows.clone(),)),
           "library_ms": timer(lambda r: r.index_copy_(
               0, lines, staged.index_select(0, src)),
               setup=lambda: (rows.clone(),)),
           **bound(nbytes)}
    emit(row)
    # as the device tier fills: fillers are requests read from the
    # compacted staged buffer, found through the map
    L, B, D = MAP_FILL_CASE
    slots = _served_slots(torch, gen, B, L)
    staged, staged_map = _compacted(torch, gen, slots, D, torch.float32)
    needed = (slots < 0).nonzero()[:, 0].to(torch.int32)
    pick = torch.randint(0, len(needed), (L,), generator=gen, device="cuda")
    keep = torch.rand((L,), generator=gen, device="cuda") >= 0.3
    last_filler = needed[pick].masked_fill(keep, -1)
    got = torch.randn((L, D), generator=gen, device="cuda")
    want = got.clone()
    ops.store_fill(got, last_filler, staged, staged_map)
    ref.store_fill_ref(want, last_filler, staged, staged_map)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "store_fill with a staged map")
    n_filled = int((last_filler >= 0).sum())
    emit({"phase": "kernel", "name": "store_fill", "dtype": "float32",
          "staged_map": True, "shape": [L, B, D],
          "staged_rows": staged.shape[0], "filled": n_filled,
          "max_abs_err": 0.0,
          "kernel_ms": timer(lambda r: ops.store_fill(r, last_filler, staged,
                                                      staged_map),
                             setup=lambda: (want.clone(),)),
          "plain_ms": timer(lambda r: ref.store_fill_ref(
              r, last_filler, staged, staged_map),
              setup=lambda: (want.clone(),)),
          "library_ms": None,
          **bound(2 * n_filled * D * 4 + L * 4 + n_filled * 4)})
    return summary([row])


def _clone_state(state, device):
    return type(state)(*(t.clone().to(device) for t in state))


def _hot_ids(torch, num_sets, hot_sets, n):
    """The first n ids that hash into sets 0 .. hot_sets - 1 (hashed on
    the card)."""
    from repro_torch.core import cache_device as cd
    cand = torch.arange(1 << 25, device="cuda")
    ids = cand[cd._set_of(cand, num_sets) < hot_sets][:n]
    check(ids.numel() == n, f"only {ids.numel()} ids hash into {hot_sets} sets")
    return ids.to(torch.int32).cpu().numpy()


#: cache_access's phase-2 rows: B 8192 (one batch of the first path),
#: B 28000 (one merged window's unique ids on the second) and 4 hot sets
CACHE_ROWS = (("uniform_8192", {}),
              ("merged_window_28000", {"B": 28_000, "id_range": 100_000}),
              ("hot_4_sets", {"hot_sets": 4}))


def enqueue_us(torch, fn, setup=None, reps=20) -> float:
    """Median host µs to enqueue one call of `fn` (no sync inside), with
    the card idle before each call and `setup()` untimed."""
    times = []
    for _ in range(reps):
        args = setup() if setup else ()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def kernel_cache_access(torch, timer, np, B=8192, id_range=40_000,
                        hot_sets=None):
    """B requests into 2048 sets x 8 ways over three rounds that repeat ids
    under window pinning (duplicates and -1 pads in the last), exact
    against access_ref on CPU tensors.  B = 8192 is one batch of the first
    path, B = 28000 one merged window's unique ids on the second.  With
    `hot_sets`, every id hashes into that many sets (drawn from 4 x B ids
    that do, with duplicates and 2 % -1 pads in every round): the serial
    walk of a hot set.  The bucketing pass (`cache_bucket`) is also held
    and timed on its own against `bucket_by_set_ref` on the card; its time
    is part of cache_access's.  Returns both kernels' summaries, the
    access's with the host µs to enqueue one call."""
    from repro_torch.core import cache_device as cd
    lines, ways = 16384, 8
    num_sets = lines // ways
    rng = np.random.default_rng(7)
    gpu = cd.init_cache(lines, ways, device="cuda")
    cpu = cd.init_cache(lines, ways, device="cpu")
    pool = (_hot_ids(torch, num_sets, hot_sets, 4 * B) if hot_sets
            else np.arange(id_range, dtype=np.int32))
    prev = rng.choice(pool, B, replace=False)
    for rnd in range(3):
        fresh = rng.choice(pool, B, replace=False)
        ids = np.where(rng.random(B) < 0.5, prev, fresh).astype(np.int32)
        if rnd == 2 or hot_sets:
            ids[rng.random(B) < 0.02] = -1
            ids[:64] = ids[64:128]
        fc = rng.integers(0, 3, B).astype(np.int32)
        window = np.unique(rng.choice(ids, B // 2)).astype(np.int32)
        for st in (gpu, cpu):
            cd.push_window(st, torch.from_numpy(window).to(st.tags.device))
        ids_t, fc_t = torch.from_numpy(ids), torch.from_numpy(fc)
        snap_gpu = _clone_state(gpu, "cuda")
        snap_cpu = _clone_state(cpu, "cpu")
        got = cd.access(gpu, ids_t.cuda(), fc_t.cuda())
        want = cd.access(cpu, ids_t, fc_t)
        torch.cuda.synchronize()
        for field, a, b in zip(got._fields, got, want):
            check(torch.equal(a.cpu(), b), f"cache_access round {rnd} {field}")
        for field, a, b in zip(gpu._fields, gpu, cpu):
            check(torch.equal(a.cpu(), b), f"cache_access round {rnd} {field}")
        prev = ids
    check(int(cpu.hits) > 0, "cache_access: the rounds never hit")
    ids_d, fc_d = ids_t.cuda(), fc_t.cuda()
    nbytes = B * 8 + lines * 4 * 4 + lines * 4 + B * 9 + lines * 4 + 24
    fresh_state = lambda: (_clone_state(snap_gpu, "cuda"),)  # noqa: E731
    row = {"phase": "kernel", "name": "cache_access", "dtype": "int32",
           "shape": [B, num_sets, ways], "hot_sets": hot_sets,
           "max_abs_err": 0.0,
           "hits": int(cpu.hits), "misses": int(cpu.misses),
           "bypasses": int(cpu.bypasses),
           "largest_bucket": int(np.bincount(
               cd._set_of(ids_t[ids_t >= 0], num_sets).numpy()).max()),
           "kernel_ms": timer(lambda st: cd.access(st, ids_d, fc_d),
                              setup=fresh_state),
           "enqueue_us": enqueue_us(
               torch, lambda st: cd.access(st, ids_d, fc_d), fresh_state),
           "plain_ms": host_ms(lambda st: cd.access(st, ids_t, fc_t),
                               setup=lambda: (_clone_state(snap_cpu, "cpu"),)),
           "plain_on": "host CPU (access_ref is a Python loop)",
           "library_ms": None, **bound(nbytes)}
    emit(row)
    bucket = _bucket_row(torch, timer, ids_d, num_sets,
                         f"B {B} hot_sets {hot_sets}", hot_sets=hot_sets)
    return ({**summary([row]), "enqueue_us": row["enqueue_us"]},
            summary([bucket]))


def _bucket_row(torch, timer, ids_d, num_sets, what, **extra) -> dict:
    """cache_bucket on `ids_d` exact against bucket_by_set_ref, then timed
    beside the plain version and the library yardstick, the stable
    torch.sort of the keys (the order without the start offsets; the keys
    are computed outside the timer); emits and returns the row."""
    from repro_torch.core import cache_device as cd
    order, start = cd.bucket_by_set(ids_d, num_sets)
    want_order, want_start = cd.bucket_by_set_ref(ids_d, num_sets)
    key = torch.where(ids_d >= 0, cd._set_of(ids_d, num_sets).long(),
                      num_sets)
    torch.cuda.synchronize()
    check(torch.equal(order, want_order) and torch.equal(start, want_start),
          f"cache_bucket {what}")
    B = ids_d.numel()
    row = {"phase": "kernel", "name": "cache_bucket", "dtype": "int32",
           "shape": [B, num_sets], **extra, "max_abs_err": 0.0,
           "kernel_ms": timer(lambda: cd.bucket_by_set(ids_d, num_sets)),
           "plain_ms": timer(lambda: cd.bucket_by_set_ref(ids_d, num_sets)),
           "library_ms": timer(lambda: torch.sort(key, stable=True)),
           **bound(B * 4 + B * 4 + (num_sets + 2) * 4)}
    emit(row)
    return row


#: cache_bucket alone beyond the cache_access rows: (case, B, num_sets)
CACHE_BUCKET_ROWS = (("key_windows", 8192, 20_000),
                     ("b_200000", 200_000, 2048))
#: (B, num_sets) held exact, untimed: no ids, one set, a ragged warp chunk,
#: the last B of 16-bit counters and the first of 32-bit ones, key counts
#: at and past one window's capacity (4448 keys of 16-bit counters, 2312
#: of 32-bit ones), one bucket of all B 65535 requests
CACHE_BUCKET_EDGES = ((0, 7), (1, 1), (33, 3), (65_535, 4447), (65_535, 4448),
                      (65_536, 2311), (65_536, 2312), (100_000, 4448),
                      (65_535, 1))


def kernel_cache_bucket_rows(torch, timer, np) -> float:
    """cache_bucket exact against bucket_by_set_ref on the card at
    CACHE_BUCKET_EDGES, then at CACHE_BUCKET_ROWS: B 8192 over 20,000 sets
    (20,001 keys, five windows of 16-bit counters) and B 200,000 over 2048
    sets (32-bit counters, one window), ids with 2 % -1 pads, each beside
    the stable torch.sort of its keys and its bound.  Returns the launch
    floor: the median time of one empty launch (torch.cuda._sleep(1))
    under the same timer."""
    from repro_torch.core import cache_device as cd
    rng = np.random.default_rng(3)
    for B, num_sets in CACHE_BUCKET_EDGES:
        ids = rng.integers(-1, 1 << 20, B).astype(np.int32)
        ids_d = torch.from_numpy(ids).cuda()
        got = cd.bucket_by_set(ids_d, num_sets)
        want = cd.bucket_by_set_ref(ids_d, num_sets)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"cache_bucket B {B} over {num_sets} sets")
    emit({"phase": "kernel", "name": "cache_bucket", "case": "edges",
          "exact_at": [list(e) for e in CACHE_BUCKET_EDGES]})
    floor = timer(lambda: torch.cuda._sleep(1))
    for case, B, num_sets in CACHE_BUCKET_ROWS:
        rng = np.random.default_rng(B + num_sets)
        ids = rng.integers(0, 1 << 20, B).astype(np.int32)
        ids[rng.random(B) < 0.02] = -1
        _bucket_row(torch, timer, torch.from_numpy(ids).cuda(), num_sets,
                    case, case=case, launch_floor_ms=floor)
    return floor


def cache_bucket_limit(torch) -> None:
    """cache_bucket at the largest set count its wrapper accepts (57087,
    thirteen windows of keys), exact against bucket_by_set_ref; one set
    more, the C entry point refuses with cudaErrorInvalidValue (1) before
    it launches."""
    from repro_torch.core import cache_device as cd
    from repro_torch.kernels import _build
    ids = torch.arange(-64, 4096, dtype=torch.int32, device="cuda")
    order, start = cd.bucket_by_set(ids, cd._MAX_SETS)
    want_order, want_start = cd.bucket_by_set_ref(ids, cd._MAX_SETS)
    torch.cuda.synchronize()
    check(torch.equal(order, want_order) and torch.equal(start, want_start),
          f"cache_bucket at {cd._MAX_SETS} sets")
    over = cd._MAX_SETS + 1
    start = torch.empty(over + 2, dtype=torch.int32, device="cuda")
    P, I = _build.P, _build.I
    fn = _build.function("cache_access", "cache_bucket", (P, I, I, P, P, P))
    err = fn(ids.data_ptr(), ids.numel(), over, order.data_ptr(),
             start.data_ptr(), _build.stream(ids))
    check(err == 1, f"cache_bucket at {over} sets returned {err}, not 1")
    emit({"phase": "kernel", "name": "cache_bucket", "case": "set_limit",
          "accepted_sets": cd._MAX_SETS, "refused_sets": over,
          "refused_with": err})


#: what `--cache-variants` changes in cache_access.cu: the walk launched
#: in plain stream order, after the sort ends (its griddepcontrol.wait then
#: returns at once); 32-bit counters at every B, not 16-bit ones where
#: B <= 65535; __match_any_sync in every group of the placement pass, not
#: only where a key came twice; the sort's cluster of 1, 4 or 16 blocks in
#: place of 8
_PDL = "programmaticStreamSerializationAllowed = 1;"
_REPEATS = "if (__any_sync(0xffffffffu, here && after != mine_before + 1)) {"
_CTAS = "constexpr int kCtas = 8;"
_BITS = "B <= 65535 ? launch_bucket<16>"
CACHE_VARIANTS = {
    "counters_32": ((_BITS, "B < 0 ? launch_bucket<16>"),),
    "plain_walk": ((_PDL, _PDL.replace("1", "0")),),
    "match_every_group": ((_REPEATS, "if (true) {"),),
    "ctas_1": ((_CTAS, _CTAS.replace("8", "1")),),
    "ctas_4": ((_CTAS, _CTAS.replace("8", "4")),),
    "ctas_16": ((_CTAS, _CTAS.replace("8", "16")),),
}


def cache_variants(torch, np) -> int:
    """Times cache_access and its cache_bucket beside copies of
    cache_access.cu built with CACHE_VARIANTS, in turns (plain_walk,
    shipped, the others, shipped, plain_walk) at every CACHE_ROWS row; every
    call of each is held exact against access_ref and bucket_by_set_ref.
    Returns 0."""
    from repro_torch.kernels import _build
    source = (ROOT / SOURCES["cache_access"][0]).read_text()
    texts = {"shipped": source,
             **{name: _edited(name, source, edits)
                for name, edits in CACHE_VARIANTS.items()}}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cache_"))
    try:
        libs = _variant_libs(tmp, "cache_access", texts)
    finally:
        shutil.rmtree(tmp)
    emit({"phase": "cache_variants", "card": card_line()})
    timer = Timer(torch)
    turns = ("plain_walk", "shipped",
             *(name for name in CACHE_VARIANTS if name != "plain_walk"),
             "shipped_again", "plain_walk_again")
    for case, kw in CACHE_ROWS:
        row = {"phase": "cache_variants", "case": case}
        for turn in turns:
            _build._libs["cache_access"] = libs[turn.removesuffix("_again")]
            access, bucket = kernel_cache_access(torch, timer, np, **kw)
            row[turn] = {"cache_access_ms": access["ms"],
                         "cache_bucket_ms": bucket["ms"],
                         "enqueue_us": access["enqueue_us"]}
        emit(row)
    _build._libs.pop("cache_access")
    return 0


def cache_ab(torch, np, tree: Path) -> int:
    """One side of an A/B of two trees (`--cache-ab TREE`): builds TREE's
    kernels, runs phase 2's cache rows and phase 3's path against its
    package, then phase 3 again under torch.profiler for the device
    operations per step and the launches and device ms per step of the
    cache kernels (`bucket*` and `walk_kernel`; the profiled run includes
    the set-up and step 0's parity check, the same on both trees).
    Returns 0."""
    from torch.profiler import ProfilerActivity, profile
    import repro_torch
    check(Path(repro_torch.__file__).resolve().is_relative_to(
        tree.resolve()), f"repro_torch imported from {repro_torch.__file__}")
    card_and_build(torch)
    timer = Timer(torch)
    rows = {case: kernel_cache_access(torch, timer, np, **kw)
            for case, kw in CACHE_ROWS}
    floor = kernel_cache_bucket_rows(torch, timer, np)
    del timer
    main_path(torch, np)
    trace = ROOT / "build" / "cache_ab_trace.json"
    trace.parent.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        main_path(torch, np)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    dev = _device_busy(trace)
    trace.unlink()
    cache = {k: (n / STEPS, dev["kernel_ms_by_name"][k] / STEPS)
             for k, n in dev["kernel_count_by_name"].items()
             if "bucket" in k or "walk_kernel" in k}
    emit({"phase": "cache_ab", "tree": str(tree), "card": card_line(),
          "launch_floor_ms": floor,
          **{case: {"cache_access_ms": a["ms"], "cache_bucket_ms": b["ms"],
                    "enqueue_us": a["enqueue_us"]}
             for case, (a, b) in rows.items()},
          "device_ops_per_step": dev["device_ops"] / STEPS,
          "cache_kernels_per_step": {k: n for k, (n, _) in cache.items()},
          "cache_kernel_ms_per_step": {k: ms for k, (_, ms) in cache.items()}})
    return 0


def tier_ab(torch, np, tree: Path) -> int:
    """One side of an A/B of the device tier (`--tier-ab TREE`): builds
    TREE's kernels and runs phases 3 and 4 against its package; their
    lines carry each probe's split and, where the tree's tier keeps them,
    its counts (rows, hits, staged rows, bytes copied), and their summaries
    the launches and the counts summed.  Returns 0."""
    import repro_torch
    check(Path(repro_torch.__file__).resolve().is_relative_to(
        tree.resolve()), f"repro_torch imported from {repro_torch.__file__}")
    card_and_build(torch)
    main_path(torch, np)
    torch.cuda.empty_cache()
    merged_topology_path(torch, np)
    emit({"phase": "tier_ab", "tree": str(tree), "card": card_line()})
    return 0


def _visible(torch, B, Sq, Sk, causal, window, offsets):
    """(B, Sq, Sk) mask of the (query, key) pairs attention computes, query
    i of sequence b at position offsets[b] + i."""
    q_pos = (torch.arange(Sq, device="cuda")[None, :, None]
             + offsets.long()[:, None, None])
    k_pos = torch.arange(Sk, device="cuda")[None, None, :]
    ok = torch.ones((B, Sq, Sk), dtype=torch.bool, device="cuda")
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return ok


#: (row name, B, H, KV, Sq, Sk, hd, causal, window, dtypes); the sweep of
#: tests/test_kernels.py:124-129, then the serving path's shapes
FLASH_CASES = (
    [(f"sweep_{n}", *c, ("float32", "bfloat16")) for n, c in (
        ("mha", (2, 4, 4, 128, 128, 64, True, None)),
        ("gqa", (2, 8, 2, 128, 128, 64, True, None)),
        ("mqa", (1, 4, 1, 256, 256, 128, True, None)),
        ("window", (2, 4, 2, 128, 128, 64, True, 32)),
        ("padded", (2, 4, 4, 100, 164, 64, False, None)),
        ("long_kv", (1, 2, 2, 64, 512, 64, True, None)))]
    + [("prefill", 1, 12, 2, 1024, 2048, 128, True, None,
        ("bfloat16", "float32")),
       ("decode", 8, 12, 2, 1, 2048, 128, True, None,
        ("bfloat16", "float32")),
       ("window_danube", 1, 32, 8, 8192, 8192, 80, True, 4096,
        ("bfloat16", "float32")),
       # split-KV edges: offsets 0 (one visible row) and Sk - 1, so most
       # splits are empty; one sequence, every split of one kv head busy
       ("decode_edge", 8, 12, 2, 1, 2048, 128, True, None,
        ("bfloat16", "float32")),
       ("decode_b1", 1, 12, 2, 1, 2048, 128, True, None,
        ("bfloat16", "float32")),
       # a 64-row cache: split_plan gives one split, whose block is the
       # last to arrive and merges its own partial
       ("decode_split1", 8, 12, 2, 1, 64, 128, True, None,
        ("bfloat16", "float32")),
       # the tensor-core path at the small head dims and a ragged Sq
       ("prefill_hd16", 2, 4, 2, 1000, 1000, 16, True, None, ("bfloat16",)),
       ("prefill_hd32", 2, 8, 2, 1000, 1100, 32, True, None, ("bfloat16",)),
       ("prefill_ragged", 1, 12, 2, 1000, 2048, 128, True, None,
        ("bfloat16",)),
       # hd 256, recurrentgemma-2b's local attention (H 10, MQA, window
       # 2048): a decode tick of 8 slots at offsets over 64-4000 of a
       # 4096-row cache, and a 3000-token prompt over 4096 keys
       ("decode_rg", 8, 10, 1, 1, 4096, 256, True, 2048,
        ("bfloat16", "float32")),
       ("prefill_rg", 1, 10, 1, 3000, 4096, 256, True, 2048,
        ("bfloat16", "float32"))]
    # the other phase-5b paths' shapes: whisper-small's non-causal encoder
    # (4 x 1500 frames), its decoder's prompt, decode tick and
    # cross-attention decode over the 1500-row memory; internvl2-1b (GQA
    # group 7, hd 64) and llama4 (group 5) and arctic (group 7) at hd 128,
    # a decode tick of 8 slots over a 4096-row cache and a 1000-token
    # prompt over it
    + [(name, *c, ("bfloat16", "float32")) for name, c in (
        ("enc_whisper", (4, 12, 12, 1500, 1500, 64, False, None)),
        ("prefill_whisper", (4, 12, 12, 32, 64, 64, True, None)),
        ("decode_whisper", (4, 12, 12, 1, 64, 64, True, None)),
        ("xdecode_whisper", (4, 12, 12, 1, 1500, 64, False, None)),
        ("decode_internvl2", (8, 14, 2, 1, 4096, 64, True, None)),
        ("prefill_internvl2", (1, 14, 2, 1000, 4096, 64, True, None)),
        ("decode_llama4", (8, 40, 8, 1, 4096, 128, True, None)),
        ("prefill_llama4", (1, 40, 8, 1000, 4096, 128, True, None)),
        ("decode_arctic", (8, 56, 8, 1, 4096, 128, True, None)),
        ("prefill_arctic", (1, 56, 8, 1000, 4096, 128, True, None)))])

#: flash_attention's gate per dtype: allclose's rtol = atol, and the
#: largest error of one output row relative to its reference row
FLASH_TOL = {"float32": 3e-4, "bfloat16": 3e-2}
FLASH_ROW_REL = {"float32": 1e-4, "bfloat16": 1e-2}

def _spread(lo, hi):
    return lambda torch, B, Sk: torch.linspace(lo, hi, B, device="cuda")


#: per-sequence offsets of the decode rows, read through the cache's view
#: (None: the cross-attention memory, read whole, no offset)
DECODE_OFFSETS = {
    "decode": _spread(64, 1900),
    "decode_edge": lambda torch, B, Sk: torch.tensor([0.0, Sk - 1] * (B // 2),
                                                     device="cuda"),
    "decode_b1": lambda torch, B, Sk: torch.full((B,), Sk - 1.0,
                                                 device="cuda"),
    "decode_split1": _spread(0, 63),
    "decode_rg": _spread(64, 4000), "decode_whisper": _spread(32, 62),
    "xdecode_whisper": None, "decode_internvl2": _spread(64, 4000),
    "decode_llama4": _spread(64, 4000), "decode_arctic": _spread(64, 4000)}


def _flash_inputs(torch, gen, case, dtype):
    """q, k, v and the keyword arguments of one FLASH_CASES row; the decode
    rows read K/V through the transposed view of the cache's (B, S, KV, hd)
    layout, at their per-sequence offsets."""
    name, B, H, KV, Sq, Sk, hd, causal, window, _ = case
    offsets = None
    if name in DECODE_OFFSETS:
        cache_k = torch.randn((B, Sk, KV, hd), generator=gen,
                              device="cuda").to(dtype)
        cache_v = torch.randn((B, Sk, KV, hd), generator=gen,
                              device="cuda").to(dtype)
        k, v = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
        q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda"
                        ).to(dtype).transpose(1, 2)
        if DECODE_OFFSETS[name] is not None:
            offsets = DECODE_OFFSETS[name](torch, B, Sk).round().to(
                torch.int32)
    else:
        q = torch.randn((B, H, Sq, hd), generator=gen,
                        device="cuda").to(dtype)
        k = torch.randn((B, KV, Sk, hd), generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn((B, KV, Sk, hd), generator=gen,
                        device="cuda").to(dtype)
    return q, k, v, dict(causal=causal, window=window, q_offset=offsets)


def _flash_errors(torch, out, want) -> dict:
    """The two readings of the flash_attention gate: the largest absolute
    error, held to FLASH_TOL by allclose, and the largest error of one
    output row relative to that row, ||out - want|| / ||want|| over hd,
    held to FLASH_ROW_REL.  The second scales with the output: with
    N(0, 1) inputs a row that sees n keys has elements of about
    sqrt(e / n), 0.026 at a 4096-key window, which a 3e-2 allclose cannot
    tell from 0.  One bf16 rounding of a row is about 2e-3 of it; a key
    dropped or added at a band edge moves a row by about 1e-2 or more.  A
    row whose reference is 0 (nothing visible) must be 0."""
    dtype_name = str(want.dtype).removeprefix("torch.")
    d, w = out.float() - want.float(), want.float()
    row_rel = (d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max().item()
    tol = FLASH_TOL[dtype_name]
    return {"max_abs_err": d.abs().max().item(), "row_rel_err": row_rel,
            "allclose_ok": torch.allclose(out.float(), w, rtol=tol, atol=tol),
            "row_rel_ok": row_rel <= FLASH_ROW_REL[dtype_name]}


def _flash_work(torch, case, q, kw) -> tuple:
    """One FLASH_CASES row's bound, its count of visible (query, key)
    pairs, and the mask and causal flag that scaled_dot_product_attention
    takes for it.  Bytes count q and o once and the K/V rows some query
    sees once; operations count 4 hd per visible (query, key) pair per
    head, at the input type's peak rate."""
    _, B, H, KV, Sq, Sk, hd, causal, window, _ = case
    offsets = kw["q_offset"]
    zero = torch.zeros(B, dtype=torch.int32, device="cuda")
    seen = _visible(torch, B, Sq, Sk, causal, window,
                    offsets if offsets is not None else zero)
    pairs = int(seen.sum())
    kv_rows = int(seen.any(dim=1).sum())
    el = q.element_size()
    nbytes = 2 * q.numel() * el + 2 * kv_rows * KV * hd * el
    rate = (F32_FLOPS_PER_S if q.dtype == torch.float32
            else BF16_FLOPS_PER_S)
    if offsets is None and window is None:
        mask, is_causal = None, causal
    else:
        mask, is_causal = seen[:, None], False
    return bound(nbytes, 4 * pairs * hd * H, rate), pairs, mask, is_causal


def _is_split(case) -> bool:
    """A row that flash_attention runs split-KV: at most SPLIT_ROWS query
    rows per kv head."""
    from repro_torch.kernels import flash_attention as fa
    H, KV, Sq = case[2:5]
    return Sq * (H // KV) <= fa.SPLIT_ROWS


def _fused_merge_gate(torch, q, k, v, kw, out, what: str) -> dict:
    """A split-KV row's gates beyond its tolerances: the fused launch, made
    again through the launcher's private entry that also returns its
    scratch, gives `out`'s bits; `flash_combine` over the partials that
    launch left in its own scratch gives the same bits; and every arrival
    counter is back at 0.  Returns the row's splits and the readings."""
    from repro_torch.kernels import flash_attention as fa
    fused, ml, acc = fa._flash_decode(q, k, v, merge=True, **kw)
    merged = torch.empty_like(fused)
    fa.flash_combine(ml, acc, merged)
    torch.cuda.synchronize()
    res = {"splits": ml.shape[2],
           "fused_repeats_bits": _bits_equal(torch, fused, out),
           "combine_bit_equal": _bits_equal(torch, merged, fused),
           "counters_zero": not bool(fa._arrivals[q.device].any())}
    check(res["fused_repeats_bits"] and res["combine_bit_equal"]
          and res["counters_zero"], f"flash_attention {what}: fused merge "
          f"gate {res}")
    return res


def kernel_flash_attention(torch, timer, gen):
    """Each FLASH_CASES row against attention_ref: allclose 3e-4 in f32 and
    3e-2 in bf16, and every output row within 1e-4 (f32) or 1e-2 (bf16) of
    its reference row in norm (`_flash_errors`); each split-KV row also
    bit-equal to `flash_combine` over its own partials with every arrival
    counter back at 0 after its launches (`_fused_merge_gate`).
    "decode" is one decode tick of the serving path: 8 slots at offsets
    spread over 64-1900 of a 2048-row cache, read through the transposed
    view of its (B, S, KV, hd) layout.  The bound is `_flash_work`'s.  The
    library yardstick is scaled_dot_product_attention with GQA (an explicit
    mask where offsets or a window apply)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    rows = {}
    for case in FLASH_CASES:
        name, B, H, KV, Sq, Sk, hd, causal, window, dtypes = case
        for dtype_name in dtypes:
            dtype = getattr(torch, dtype_name)
            q, k, v, kw = _flash_inputs(torch, gen, case, dtype)
            out = ops.flash_attention(q, k, v, **kw)
            want = ref.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            errs = _flash_errors(torch, out, want)
            err = errs["max_abs_err"]
            check(errs["allclose_ok"] and errs["row_rel_ok"],
                  f"flash_attention {name} {dtype_name} max_abs_err {err} "
                  f"row_rel_err {errs['row_rel_err']}")
            del want
            work, pairs, mask, is_causal = _flash_work(torch, case, q, kw)
            reps = 5 if name in ("window_danube", "prefill_rg") else REPS
            row = {"phase": "kernel", "name": "flash_attention",
                   "case": name, "dtype": dtype_name,
                   "shape": [B, H, KV, Sq, Sk, hd], "causal": causal,
                   "window": window, "max_abs_err": err,
                   "row_rel_err": errs["row_rel_err"], "pairs": pairs,
                   "kernel_ms": timer(lambda: ops.flash_attention(
                       q, k, v, **kw)),
                   "plain_ms": timer(lambda: ref.attention_ref(
                       q, k, v, **kw), reps=reps),
                   "library_ms": timer(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask, is_causal=is_causal,
                       enable_gqa=True), reps=reps),
                   **work}
            if _is_split(case):      # after the timed launches, too
                row.update(_fused_merge_gate(torch, q, k, v, kw, out,
                                             f"{name} {dtype_name}"))
                check(name != "decode_split1" or row["splits"] == 1,
                      f"decode_split1 ran {row['splits']} splits")
            emit(row)
            rows[(name, dtype_name)] = row
            del q, k, v, out, mask
    flash_decode_growing(torch, gen)
    torch.cuda.empty_cache()
    # the serving path's numbers: one decode tick's launch, and beside it
    # one prefill launch at a 1024-token prompt
    main = summary([rows[("decode", "bfloat16")]])
    for prefix, name in (("prefill", "prefill"), ("decode_hd256", "decode_rg"),
                         ("prefill_hd256", "prefill_rg")):
        row = rows[(name, "bfloat16")]
        main.update({f"{prefix}_ms": row["kernel_ms"],
                     f"{prefix}_bound_ms": row["bound_ms"],
                     f"{prefix}_bound_by": row["bound_by"],
                     f"{prefix}_plain_ms": row["plain_ms"],
                     f"{prefix}_library_ms": row["library_ms"]})
    main["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    return main


#: (B, H, KV) of the back-to-back fused calls of `flash_decode_growing`, at
#: the serving decode row's Sk 2048, hd 128, bf16: B x KV pairs 2, 8, 128,
#: 256, then 4 (the counters grow three times, then are reused)
GROWING = ((1, 12, 2), (4, 12, 2), (16, 40, 8), (32, 56, 8), (2, 12, 2))


def flash_decode_growing(torch, gen) -> None:
    """Fused split-KV calls of growing B x KV, back to back on one stream
    with no synchronisation between them, starting from no counters: each
    call that needs more pairs than the counters hold gets a new zeroed
    tensor while the earlier calls may still run.  Then every output is
    held to attention_ref at the decode gates and to flash_combine over its
    own partials bit for bit, and every counter is 0."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    fa._arrivals.clear()
    calls, sizes = [], []
    for B, H, KV in GROWING:
        case = ("decode", B, H, KV, 1, 2048, 128, True, None, ())
        q, k, v, kw = _flash_inputs(torch, gen, case, torch.bfloat16)
        out, ml, acc = fa._flash_decode(q, k, v, merge=True, **kw)
        sizes.append(fa._arrivals[q.device].numel())
        calls.append((q, k, v, kw, out, ml, acc))
    torch.cuda.synchronize()
    worst = {"max_abs_err": 0.0, "row_rel_err": 0.0}
    for (B, H, KV), (q, k, v, kw, out, ml, acc) in zip(GROWING, calls):
        errs = _flash_errors(torch, out, ref.attention_ref(q, k, v, **kw))
        merged = torch.empty_like(out)
        fa.flash_combine(ml, acc, merged)
        torch.cuda.synchronize()
        check(errs["allclose_ok"] and errs["row_rel_ok"]
              and _bits_equal(torch, merged, out),
              f"flash_attention decode_growing B {B} KV {KV}: {errs}, "
              f"combine bit-equal {_bits_equal(torch, merged, out)}")
        for key in worst:
            worst[key] = max(worst[key], errs[key])
    zero = not bool(fa._arrivals[calls[0][0].device].any())
    check(zero and sizes == [2, 8, 128, 256, 256],
          f"flash_attention decode_growing: counters {sizes}, zero {zero}")
    emit({"phase": "kernel", "name": "flash_attention",
          "case": "decode_growing", "dtype": "bfloat16",
          "shapes": [list(s) for s in GROWING], "counter_sizes": sizes,
          "counters_zero": zero, "combine_bit_equal": True, **worst})


#: faults that `--plant-fault` builds into a copy of flash_attention.cu, as
#: (old, new) text in flash_mma_kernel, the bf16 tensor-core path: the
#: partial kv tile at the lower (window) edge of a q-tile's band dropped,
#: and the lower edge of the unmasked-tile shortcut 4 keys too early
FAULTS = {
    "band_edge": ("const int kt_begin = lo / kBK,",
                  "const int kt_begin = (lo + kBK - 1) / kBK,"),
    "full_lo": ("max(0, wq_hi - p.window + 1)",
                "max(0, wq_hi - p.window - 3)"),
}


def _edited(name: str, source: str, edits) -> str:
    """`source` with each (old, new) of `edits` replaced; each old must be
    in it once."""
    for old, new in edits:
        check(source.count(old) == 1, f"{name}: {old!r} not in the source")
        source = source.replace(old, new)
    return source


def _variant_libs(tmp: Path, kernel: str, sources: dict,
                  logs: dict | None = None) -> dict:
    """Build each {name: text} copy of csrc/<kernel>.cu into `tmp`, one nvcc
    each, all started together; returns {name: ctypes.CDLL} and puts each
    build's nvcc output (its -Xptxas -v report) into `logs` if given."""
    import ctypes
    from repro_torch.kernels import _build
    jobs = {}
    for name, text in sources.items():
        (tmp / f"{name}.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp / f"{name}.so"),
             str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, job in jobs.items():
        log = job.communicate()[0]
        check(job.returncode == 0, f"nvcc failed on {kernel} {name}:\n{log}")
        if logs is not None:
            logs[name] = log
    return {name: ctypes.CDLL(str(tmp / f"{name}.so")) for name in jobs}


#: segment_mean.cu's warp-to-work order and batch choice, and what
#: `--segment-mean-variants` puts in their place: the shipped kernel takes
#: 512-byte chunks column stripe by column stripe and batches 8 or 2
#: neighbours by grid size, and on the scalar path (a row width that is not
#: a multiple of 16 bytes) 2 neighbours of 64-column chunks; the variants
#: take the chunks row by row, batch 8 always, batch 2 always, row by row
#: with 8 over 1 KB chunks, or 32 or 128 scalar columns per chunk; `block`
#: is the block-per-destination kernel the shipped one replaced (a whole
#: source, csrc/variants/segment_mean_block.cu)
_CHUNK_MAJOR = ("const int64_t b = w % B;                               "
                "// chunk-major\n  const int g0 = static_cast<int>(w / B) "
                "* 32 * GROUPS + lane;")
_ROW_MAJOR = ("const int64_t b = w / chunks;\n  const int g0 = "
              "static_cast<int>(w % chunks) * 32 * GROUPS + lane;")
_ADAPTIVE = "if (deep) {"
_SCALAR = "return launch_as<T, 1, 2>("
SEGMENT_MEAN_VARIANTS = {
    "row_major": ((_CHUNK_MAJOR, _ROW_MAJOR),),
    "batch_8": ((_ADAPTIVE, "if (true) {"),),
    "batch_2": ((_ADAPTIVE, "if (false) {"),),
    "row_major_batch_8_1kb": (
        (_CHUNK_MAJOR, _ROW_MAJOR), (_ADAPTIVE, "if (true) {"),
        ("return launch_as<T, kVec, 1>(", "return launch_as<T, kVec, 2>(")),
    "scalar_32": ((_SCALAR, "return launch_as<T, 1, 1>("),),
    "scalar_128": ((_SCALAR, "return launch_as<T, 1, 4>("),),
    "block": "src/repro_torch/kernels/csrc/variants/segment_mean_block.cu",
}


def segment_mean_variants(torch) -> int:
    """Times the shipped segment_mean kernel beside SEGMENT_MEAN_VARIANTS,
    built into a temporary directory, in turns on the same inputs at every
    SEGMENT_MEAN_CASES row over an 8192-row table, f32 and bf16, each held
    to the plain version (1e-6 f32, 2e-2 bf16).  Returns 0 if every variant
    agrees with the plain version."""
    import shutil
    import tempfile
    from repro_torch.kernels import _build, ops, ref
    source = (ROOT / SOURCES["segment_mean"][0]).read_text()
    texts = {name: (ROOT / edits).read_text() if isinstance(edits, str)
             else _edited(name, source, edits)
             for name, edits in SEGMENT_MEAN_VARIANTS.items()}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_variants_"))
    ok = True
    try:
        sound = _build.library("segment_mean")
        libs = {"shipped": sound, **_variant_libs(tmp, "segment_mean", texts)}
        timer = Timer(torch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        tables = {D: torch.randn((8192, D), generator=gen, device="cuda")
                  for D in sorted({c[2] for c in SEGMENT_MEAN_CASES})}
        for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
            for B, Fo, D in SEGMENT_MEAN_CASES:
                feats = tables[D].to(dtype)
                idx = torch.randint(0, 8192, (B, Fo), generator=gen,
                                    device="cuda", dtype=torch.int32)
                want = ref.segment_mean_ref(idx, feats)
                row = {"phase": "segment_mean_variants",
                       "dtype": str(dtype).removeprefix("torch."),
                       "shape": [B, Fo, 8192, D]}
                # in turns: shipped, variants, shipped again
                for name in ("shipped", *texts, "shipped_again"):
                    _build._libs["segment_mean"] = libs[
                        name.removesuffix("_again")]
                    out = ops.segment_mean(idx, feats)
                    torch.cuda.synchronize()
                    agrees = torch.allclose(out.float(), want.float(),
                                            rtol=tol, atol=tol)
                    ok &= agrees
                    row[name] = {"ms": timer(
                        lambda: ops.segment_mean(idx, feats)),
                        "agrees": agrees}
                emit(row)
                del feats
        _build._libs["segment_mean"] = sound
    finally:
        shutil.rmtree(tmp)
    return 0 if ok else 1


def plant_fault(torch, fault: str) -> int:
    """Shows that phase 2's flash_attention gate rejects FAULTS[fault]: the
    faulty source is built into a temporary directory beside the sound
    one, and every bf16 FLASH_CASES row runs through both libraries on the
    same inputs against attention_ref.  Prints both readings per row (and
    whether allclose and the row-relative test pass); returns 0 if the
    gate passes the sound kernel on every row and rejects the fault on
    some row, else 1."""
    import shutil
    import tempfile
    from repro_torch.kernels import _build, ops, ref
    old, new = FAULTS[fault]
    source = (ROOT / SOURCES["flash_attention"][0]).read_text()
    check(source.count(old) == 1,
          f"--plant-fault {fault}: {old!r} is not in the source once")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fault_"))
    try:
        libs = {"sound": _build.library("flash_attention"),
                **_variant_libs(tmp, "flash_attention",
                                {fault: source.replace(old, new)})}
        gen = torch.Generator(device="cuda").manual_seed(0)
        sound_ok, caught = True, []
        for case in FLASH_CASES:
            if "bfloat16" not in case[-1]:
                continue
            q, k, v, kw = _flash_inputs(torch, gen, case, torch.bfloat16)
            want = ref.attention_ref(q, k, v, **kw)
            row = {"phase": "plant_fault", "case": case[0]}
            for lib_name, lib in libs.items():
                _build._libs["flash_attention"] = lib
                row[lib_name] = _flash_errors(
                    torch, ops.flash_attention(q, k, v, **kw), want)
            emit(row)
            sound_ok &= row["sound"]["allclose_ok"] and \
                row["sound"]["row_rel_ok"]
            if not (row[fault]["allclose_ok"] and row[fault]["row_rel_ok"]):
                caught.append(case[0])
            del q, k, v, want
        _build._libs["flash_attention"] = libs["sound"]
    finally:
        shutil.rmtree(tmp)
    emit({"phase": "plant_fault", "fault": fault, "sound_passes": sound_ok,
          "rejected_in": caught})
    return 0 if sound_ok and caught else 1


#: spill bytes (stores, and loads) that each split-KV instance may show in
#: nvcc -Xptxas -v, by its mangled template arguments: the f32 hd-256
#: instances' counts before the merge moved into them (RW 4: 84, RW 2:
#: 296); every other function of flash_attention.cu spills nothing
SPLIT_SPILL_LIMIT = {"IfLi256ELi4E": 84, "IfLi256ELi2E": 296}


def _spill_limit(fn: str) -> int:
    return next((n for key, n in SPLIT_SPILL_LIMIT.items()
                 if "flash_split_kernel" + key in fn), 0)


def flash_decode_variants(torch) -> int:
    """Times the fused split-KV decode (one launch, the merge done by the
    last block of each (b, kv head) to arrive) beside the two-launch path
    it replaced (the split kernel with its merge compiled out, then
    flash_combine), in turns (two-launch, fused, fused, two-launch) on the
    same inputs at every split-KV row of FLASH_CASES in both types, with
    each row's bound, scaled_dot_product_attention's time, the split
    kernel's time alone (its merge compiled out, no flash_combine) and
    each path's host time to enqueue one call.  Both outputs are held to
    attention_ref at phase 2's gates, and the fused one to flash_combine
    over its own partials bit for bit with every arrival counter back at
    0.  Builds flash_attention.cu into a temporary directory for its
    -Xptxas -v report, prints the lines of every split-KV instance, and
    fails if a function spills more than SPLIT_SPILL_LIMIT allows.
    Returns 0 if every gate holds."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_decode_"))
    logs, ok = {}, True
    try:
        source = (ROOT / SOURCES["flash_attention"][0]).read_text()
        lib = _variant_libs(tmp, "flash_attention", {"shipped": source},
                            logs)["shipped"]
    finally:
        shutil.rmtree(tmp)
    _build._libs["flash_attention"] = lib
    spills = ptxas_spills(logs["shipped"])
    lines, fn = {}, None
    for line in logs["shipped"].splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif fn and "flash_split_kernel" in fn and "registers" in line:
            lines[fn] = line.strip()
            fn = None
    over = {}
    for f, line in spills.items():        # "N bytes stack frame, N bytes
        counts = [int(w) for w in line.replace(",", " ").split()
                  if w.isdigit()]         # spill stores, N bytes spill loads"
        if max(counts[1:]) > _spill_limit(f):
            over[f] = line
    emit({"phase": "flash_decode_variants", "card": card_line(),
          "ptxas_split": lines, "spills": spills, "over_limit": over})
    ok &= not over
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)

    for case in FLASH_CASES:
        if not _is_split(case):
            continue
        for dtype_name in case[-1]:
            q, k, v, kw = _flash_inputs(torch, gen, case,
                                        getattr(torch, dtype_name))
            want = ref.attention_ref(q, k, v, **kw)
            paths = {"two_launch": lambda: fa._flash_decode(
                         q, k, v, merge=False, **kw)[0],
                     "fused": lambda: fa._flash_decode(
                         q, k, v, merge=True, **kw)[0]}
            row = {"phase": "flash_decode_variants", "case": case[0],
                   "dtype": dtype_name, "shape": list(case[1:7])}
            for path, call in paths.items():
                errs = _flash_errors(torch, call(), want)
                row[f"{path}_row_rel_err"] = errs["row_rel_err"]
                ok &= errs["allclose_ok"] and errs["row_rel_ok"]
            gate = _fused_merge_gate(torch, q, k, v, kw, paths["fused"](),
                                     f"{case[0]} {dtype_name}")
            row["splits"] = gate["splits"]
            for path in ("two_launch", "fused", "fused_again",
                         "two_launch_again"):
                row[f"{path}_ms"] = timer(paths[path.removesuffix("_again")])
            # the split kernel alone (merge compiled out, no flash_combine):
            # what each path spends merging is its time less this
            out = torch.empty_like(q)
            row["split_only_ms"] = timer(lambda: fa._split(
                q, k, v, out, kw["causal"], kw["window"], None,
                kw["q_offset"], merge=False))
            for path, call in paths.items():
                row[f"{path}_enqueue_us"] = enqueue_us(torch, call)
            work, _, mask, is_causal = _flash_work(torch, case, q, kw)
            row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=is_causal,
                enable_gqa=True))
            row.update(bound_ms=work["bound_ms"], bound_by=work["bound_by"])
            emit(row)
            del q, k, v, want, mask
    return 0 if ok else 1


def kernel_flash_combine(torch, timer, gen):
    """The split-KV merge at the decode row's shapes (B 8, H 12, KV 2, hd
    128, offsets 64-1900 of 2048, split_plan's splits): partials from
    `ref.flash_split_ref` on the card, then the combine kernel against
    `ref.flash_combine_ref` on the same partials, 1e-5 in f32 and 1e-2 in
    bf16 (one rounding of the output apart).  Bytes count the partials of
    the rows it reads and the output once."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, H, KV, Sk, hd = 8, 12, 2, 2048, 128
    q = torch.randn((B, H, 1, hd), generator=gen, device="cuda")
    k = torch.randn((B, KV, Sk, hd), generator=gen, device="cuda")
    v = torch.randn((B, KV, Sk, hd), generator=gen, device="cuda")
    offsets = torch.linspace(64, 1900, B, device="cuda").round().to(
        torch.int32)
    splits, chunk = fa.split_plan(Sk, B, KV, torch.cuda.get_device_properties(
        0).multi_processor_count)
    ml, acc = ref.flash_split_ref(q, k, v, splits, chunk, q_offset=offsets)
    rows = []
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        out = torch.empty((B, H, 1, hd), dtype=dtype, device="cuda")
        fa.flash_combine(ml, acc, out)
        want = ref.flash_combine_ref(ml, acc, H, 1, dtype)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        check(torch.allclose(out.float(), want.float(), rtol=tol, atol=tol),
              f"flash_combine {dtype} max_abs_err {err}")
        group = H // KV
        nbytes = (B * KV * splits * group * (2 + hd) * 4
                  + out.numel() * out.element_size())
        row = {"phase": "kernel", "name": "flash_combine",
               "dtype": str(dtype).removeprefix("torch."),
               "shape": [B, H, KV, splits, hd], "max_abs_err": err,
               "kernel_ms": timer(lambda: fa.flash_combine(ml, acc, out)),
               "plain_ms": timer(lambda: ref.flash_combine_ref(
                   ml, acc, H, 1, dtype)),
               "library_ms": None,
               **bound(nbytes, 2 * B * H * splits * hd)}
        emit(row)
        rows.append(row)
    return summary(rows[:1])                 # bf16: the serving path's


#: R-GAT's layer 0 at the `rgat3-igbh` cell's widths: one 1024-seed batch
#: of the cell's graph (bench/configs/rgat3-igbh.json, drawn on the card by
#: bench/families/rgat.py) through the relational sampler, hop 2 (fanout 5)
RGAT_BATCH = dict(seeds=1024, seed=2**31 + 7)
#: kernel against the plain formulas in float64, as the norm of the
#: difference over the norm of the float64 result (tests/
#: test_torch_relation_attend.py's CARD_REL)
RELATION_ATTEND_REL = 1e-5
#: profiled runs of each path of R-GAT's layer 0 (`rgat_layer0_paths`)
PROFILED = 3


def relational_batch(torch, np, config: str):
    """One RGAT_BATCH batch of the cell whose configuration is
    bench/configs/`config`.json, on the card's graph through the
    relational sampler: (`RelationalBlocks`, the `HeteroGraph`, the
    configuration)."""
    sys.path.insert(0, str(ROOT))
    from bench.families import rgat as family
    from repro_torch.graph.hetero import HeteroGraph, Relation
    from repro_torch.sampling.relational import relational_sample_blocks
    cfg = json.loads((ROOT / "bench" / "configs" / f"{config}.json")
                     .read_text())
    rels = family.relation_csrs(cfg, torch.device("cuda"))
    graph = HeteroGraph(cfg["nodes"], [
        Relation(r["src"], r["name"], r["dst"], r["indptr"], r["indices"])
        for r in rels], feature_dim=cfg["in_dim"], name=cfg["name"])
    cites = next(r for r in rels if r["name"] == "cites")
    rng = np.random.default_rng(RGAT_BATCH["seed"])
    seeds = rng.choice(np.flatnonzero(np.diff(cites["indptr"])),
                       RGAT_BATCH["seeds"], replace=False)
    blocks = relational_sample_blocks(graph, seeds, cfg["fanouts"], rng)
    return blocks, graph, cfg


def rgat_batch(torch, np):
    """One batch of the `rgat3-igbh` cell on the card in the model's form
    (`RGATBlocks`), and the configuration."""
    from repro_torch.models.rgat import block_tensors
    blocks, _, cfg = relational_batch(torch, np, "rgat3-igbh")
    return block_tensors(blocks, "cuda"), cfg


def rgat_layer0(torch, batch, cfg) -> list:
    """Every relation's block at layer 0 of `batch` as the model's
    `_attend` indexes it: (relation, R, i_src (m, f) int32, mask), R the
    unique rows its slots name."""
    out = []
    for b in batch.hops[len(cfg["fanouts"]) - 1]:
        if not len(b.rows):
            continue
        ref, inv = torch.unique(b.src, return_inverse=True)
        out.append((cfg["relations"][b.relation][1], len(ref),
                    inv.to(torch.int32), b.mask))
    return out


def rgat_model(torch, cfg):
    """R-GAT at the `rgat3-igbh` cell's widths on the card, default
    initialisation."""
    from repro_torch.models.rgat import RGAT, RGATConfig
    return RGAT(RGATConfig(
        in_dim=cfg["in_dim"], hidden_dim=cfg["hidden_dim"],
        num_heads=cfg["num_heads"], num_classes=cfg["num_classes"],
        fanouts=tuple(cfg["fanouts"]),
        relations=tuple(tuple(r) for r in cfg["relations"])), device="cuda")


def rgat_step_launches(torch, batch, cfg) -> dict:
    """One forward and backward of R-GAT at the cell's widths on `batch`
    (random features and labels): `relation_attend` launched forward and
    backward once for every (hop, relation) block with a destination, each
    relation projecting exactly the unique rows its slots name
    (`RGAT.last_rows`), the step's peak memory above the features, and
    then its device time (`rgat_step_profile`)."""
    from repro_torch.kernels import _build
    gen = torch.Generator(device="cuda").manual_seed(13)
    model = rgat_model(torch, cfg)
    feats = torch.randn((batch.level_sizes[-1], cfg["in_dim"]),
                        generator=gen, device="cuda")
    y = torch.randint(0, cfg["num_classes"], (len(batch.seeds),),
                      generator=gen, device="cuda")
    blocks = sum(1 for hop in batch.hops for b in hop if len(b.rows))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _build.reset_launches()
    model.loss(feats, batch, y).backward()
    torch.cuda.synchronize()
    got = {k: _build.LAUNCHES[k] for k in ("relation_attend_fwd",
                                           "relation_attend_bwd",
                                           "fold_scores_fwd",
                                           "fold_scores_bwd")}
    L = len(cfg["fanouts"])
    check(got == {k: blocks if "relation" in k else L for k in got},
          f"launches {got}: relation_attend once per block with a "
          f"destination ({blocks}), fold_scores once per layer")
    for l, rows in enumerate(model.last_rows):
        want = {model.names[b.relation]: len(torch.unique(b.src))
                for b in batch.hops[L - 1 - l] if len(b.rows)}
        check(rows["projected"] == want,
              f"layer {l} projected {rows['projected']}, its slots name "
              f"{want}")
    row = {"phase": "kernel", "name": "relation_attend_step",
           "blocks": blocks, "launches": got, "rows": model.last_rows,
           "step_peak_bytes": torch.cuda.max_memory_allocated() - base,
           "profile": rgat_step_profile(torch, lambda: model.loss(
               feats, batch, y).backward())}
    emit(row)
    return row


def rgat_step_profile(torch, step,
                      named=("relation_attend", "fold_scores")) -> dict:
    """Where one forward and backward (R-GAT's by default) spends the
    card's time: torch.profiler over PROFILED calls of `step`, a call's
    busy ms (the union of kernels, copies and memsets), its kernels' ms by
    class (the matrix products, each of the hand-written kernels `named`,
    the rest) and its top kernels."""
    from torch.profiler import ProfilerActivity, profile
    trace = ROOT / "build" / "rgat_step_trace.json"
    trace.parent.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            step()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    dev = _device_busy(trace)
    trace.unlink()
    by_class, count = {}, {}
    for name, ms in dev["kernel_ms_by_name"].items():
        c = next((k for k in named if k in name), _kernel_class(name))
        by_class[c] = by_class.get(c, 0.0) + ms / PROFILED
        count[c] = (count.get(c, 0)
                    + dev["kernel_count_by_name"][name] / PROFILED)
    top = sorted(dev["kernel_ms_by_name"].items(), key=lambda kv: -kv[1])
    return {"busy_ms": dev["busy_ms"] / PROFILED,
            "kernel_ms_by_class": by_class,
            "kernel_count_by_class": count,
            "top_kernels_ms": [[n[:90], ms / PROFILED] for n, ms in top[:10]]}


def _einsum_attend(torch, z, a_src, s_dst, i_src, mask):
    """`RGAT._attend` after the projection as it was before the kernels:
    the score gathers, masked softmax and einsum over z[i_src]."""
    import torch.nn.functional as F
    i_src = i_src.long()
    score_src = (z * a_src).sum(-1)
    e = F.leaky_relu(score_src[i_src] + s_dst[:, None], 0.2)
    e = e.masked_fill(~mask[..., None], float("-inf"))
    alpha = torch.softmax(e, dim=1)
    return torch.einsum("mfh,mfhc->mhc", alpha, z[i_src]).reshape(
        len(s_dst), -1)


def rgat_layer0_paths(torch, timer, batch, cfg) -> dict:
    """R-GAT's layer 0 on `batch`, forward and the backward into its
    parameters, two ways on the same features and weights: the model's
    (`RGAT._dst_scores` once over level 2's rows, then per relation its
    slots' unique rows projected and `relation_attend`), and the path
    before the fold (per relation the unique rows of its slots and its
    destinations projected, each destination scored from its projected
    row, a_dst . z[i_dst], then the same kernel).  Both are held to the
    path before the fold in float64 (the einsum attention, no kernel): the
    output within RELATION_ATTEND_REL by norm, and every leaf's gradient
    within the cell's `grad_gap_worst` limit.  A slot whose score lies
    within rounding of the LeakyReLU's kink may be taken on the other side
    than in float64, and one such slot moves a leaf by up to ~1e-3
    (`PERF.md` §2): `kink_flips` counts, per path, the unmasked slots whose
    side differs from float64's.  Per path: `ms` (CUDA
    events, the median of REPS runs from a cold L2, the host's syncs in
    `torch.unique` included), and over PROFILED runs under torch.profiler
    the card's busy ms, the matrix products' ms (`_kernel_class`
    "matmul") and the top kernels, a run each; the rows projected; for the
    model's path the destination scores alone (`score`: `_dst_scores` and
    its backward into the layer's W_r and a_dst,r, as the fold runs in the
    step)."""
    import copy
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.relation_attend import relation_attend
    from repro_torch.models import rgat as rgat_module
    k = len(cfg["fanouts"]) - 1
    H = cfg["num_heads"]
    model = rgat_model(torch, cfg)
    gen = torch.Generator(device="cuda").manual_seed(17)
    feats = torch.randn((batch.level_sizes[-1], cfg["in_dim"]),
                        generator=gen, device="cuda")
    g = torch.randn((batch.level_sizes[k], cfg["hidden_dim"]), generator=gen,
                    device="cuda")
    blocks = [b for b in batch.hops[k] if len(b.rows)]
    pos = batch.level_pos[k]

    def folded(mdl, x, attend=None):
        s_dst = mdl._dst_scores(0, x, pos)
        out = x.new_zeros((len(pos), cfg["hidden_dim"]))
        rows = 0
        for b in blocks:
            p = mdl.layer[0][mdl.names[b.relation]]
            msg, n = mdl._attend(p, x, b, s_dst[b.rows, b.relation])
            out.index_add_(0, b.rows, msg)
            rows += n
        return out, rows

    def before(mdl, x, attend=relation_attend):
        out = x.new_zeros((len(pos), cfg["hidden_dim"]))
        rows = 0
        for b in blocks:
            p = mdl.layer[0][mdl.names[b.relation]]
            m, f = b.src.shape
            ref, inv = torch.unique(torch.cat([b.src.reshape(-1), b.nxt]),
                                    return_inverse=True)
            z = (x[ref] @ p["w"]).reshape(len(ref), H, -1)
            s_dst = (z[inv[m * f:]] * p["attn_dst"]).sum(-1)
            i_src = inv[:m * f].reshape(m, f).to(torch.int32)
            out.index_add_(0, b.rows, attend(z, p["attn_src"], s_dst, i_src,
                                             b.mask))
            rows += len(ref)
        return out, rows

    def run(path, mdl=model, x=feats, dy=g):
        out, _ = path(mdl, x)
        leaves = [p for name in mdl.names for p in mdl.layer[0][name].values()]
        return [out.detach(), *torch.autograd.grad(out, leaves, dy,
                                                   allow_unused=True)]

    def kink_sides(path, mdl, x):
        """The LeakyReLU side of every unmasked slot's score as `path`
        hands the kernel its inputs (the model's `relation_attend` swapped
        for a recorder while it runs)."""
        sides = []

        def record(z, a_src, s_dst, i_src, mask):
            e = (z * a_src).sum(-1)[i_src.long()] + s_dst[:, None]
            sides.append((e > 0)[mask])
            return z.new_zeros((len(s_dst), z.shape[1] * z.shape[2]))
        kept, rgat_module.relation_attend = rgat_module.relation_attend, record
        try:
            with torch.no_grad():
                path(mdl, x, record)
        finally:
            rgat_module.relation_attend = kept
        return torch.cat(sides)

    wide = copy.deepcopy(model).double()
    want = run(lambda mdl, x: before(
        mdl, x, lambda *t: _einsum_attend(torch, *t)), wide, feats.double(),
        g.double())
    want_sides = kink_sides(before, wide, feats.double())
    del wide
    paths = (("folded", folded), ("before", before))
    rel = {name: [float((a.double() - b).norm() / b.norm())
                  for a, b in zip(run(path), want) if b is not None]
           for name, path in paths}
    flips = {name: int((kink_sides(path, model, feats) != want_sides).sum())
             for name, path in paths}
    del want
    worst = cfg["limits"]["grad_gap_worst"]
    check(all(r[0] < RELATION_ATTEND_REL and max(r) < worst
              for r in rel.values()),
          f"layer 0 against float64: {rel}, kink flips {flips}")
    fold_leaves = [model.layer[0][name][k_] for name in model.names
                   for k_ in ("w", "attn_dst")]
    g_s = torch.randn((len(pos), len(model.names), H), generator=gen,
                      device="cuda")
    row = {"phase": "kernel", "name": "relation_attend_layer0_paths",
           "card": card_line(), "blocks": len(blocks),
           "scored_rows": len(pos), "kink_flips": flips}
    trace = ROOT / "build" / "rgat_layer0_trace.json"
    trace.parent.mkdir(exist_ok=True)
    timed = {"folded": lambda: run(folded), "before": lambda: run(before),
             "score": lambda: torch.autograd.grad(
                 model._dst_scores(0, feats, pos), fold_leaves, g_s)}
    for name, fn in timed.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        dev = _device_busy(trace)
        trace.unlink()
        by_name = dev["kernel_ms_by_name"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])

        def ms_of(keep):
            return sum(ms for n, ms in by_name.items() if keep(n)) / PROFILED
        row[name] = {
            "ms": timer(fn), "busy_ms": dev["busy_ms"] / PROFILED,
            "matmul_ms": ms_of(lambda n: _kernel_class(n) == "matmul"),
            "relation_attend_ms": ms_of(lambda n: "relation_attend" in n),
            "fold_scores_ms": ms_of(lambda n: "fold_scores" in n),
            "top_kernels_ms": [[n[:90], ms / PROFILED] for n, ms in top[:8]]}
    for name, path in paths:
        row[name].update(rows=path(model, feats)[1], rel_err_f64=rel[name])
    emit(row)
    return row


def kernel_fold_scores(torch, timer, batch, cfg) -> dict:
    """`fold_scores` (R-GAT's destination scores through every relation's
    W_r folded into its a_dst) at layer 0's and layer 1's shapes of
    `batch`: forward and backward (grad_ut, and grad_h at layer 1, where h
    takes a gradient) within RELATION_ATTEND_REL of the plain formulas in
    float64, the backward bit-equal over two runs, each timed beside the
    plain version (the rows gathered, then the products).  `bound_ms`:
    h's n rows read forward and backward, the scores written and their
    gradient read, ut and grad_ut, grad_h's n rows written at layer 1."""
    from repro_torch.kernels import relation_attend as ra
    L = len(cfg["fanouts"])
    J = len(cfg["relations"]) * cfg["num_heads"]
    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = []
    for layer in (0, 1):
        k = L - 1 - layer
        d = cfg["in_dim"] if layer == 0 else cfg["hidden_dim"]
        pos = batch.level_pos[k]
        n, needs_h = len(pos), layer > 0
        h = torch.randn((batch.level_sizes[k + 1], d), generator=gen,
                        device="cuda")
        ut = torch.randn((J, d), generator=gen, device="cuda") / d ** 0.5
        g = torch.randn((n, J), generator=gen, device="cuda")
        got = [ra.fold_scores(h, pos, ut),
               *ra._scores_backward(g, h, pos, ut, needs_h)]
        again = ra._scores_backward(g, h, pos, ut, needs_h)
        wide = [h.double(), pos, ut.double()]
        want = [ra.fold_scores_ref(*wide),
                *ra.fold_scores_backward_ref(g.double(), *wide, needs_h)]
        torch.cuda.synchronize()
        rel = {name: float((a.double() - b).norm() / b.norm())
               for name, a, b in zip(("scores", "grad_h", "grad_ut"), got,
                                     want) if b is not None}
        check(max(rel.values()) < RELATION_ATTEND_REL,
              f"fold_scores layer {layer} {rel}")
        check(all(a is b or torch.equal(a, b)
                  for a, b in zip(got[1:], again)),
              f"fold_scores layer {layer}: two backward runs differ")
        nbytes = 2 * n * d * 4 + 2 * n * 8 + 2 * n * J * 4 + 2 * J * d * 4
        flops = 4 * n * d * J
        if needs_h:
            nbytes, flops = nbytes + n * d * 4, flops + 2 * n * d * J
        fwd_ms = timer(lambda: ra.fold_scores(h, pos, ut))
        bwd_ms = timer(lambda: ra._scores_backward(g, h, pos, ut, needs_h))
        row = {"phase": "kernel", "name": "fold_scores", "layer": layer,
               "shape": [n, d, J, len(h)], "rel_err": rel,
               "kernel_ms": fwd_ms + bwd_ms, "fwd_ms": fwd_ms,
               "bwd_ms": bwd_ms,
               "plain_ms": (timer(lambda: ra.fold_scores_ref(h, pos, ut))
                            + timer(lambda: ra.fold_scores_backward_ref(
                                g, h, pos, ut, needs_h))),
               **bound(nbytes, flops)}
        emit(row)
        rows.append(row)
        del h, got, again, wide, want
    return {"fold_scores_ms": sum(r["kernel_ms"] for r in rows),
            "fold_scores_plain_ms": sum(r["plain_ms"] for r in rows),
            "fold_scores_bound_ms": sum(r["bound_ms"] for r in rows)}


def kernel_relation_attend(torch, timer, np):
    """`relation_attend` forward and backward at layer 0 of one batch of
    the `rgat3-igbh` cell (every relation's block, H 4, C 128, f 5), each
    held within RELATION_ATTEND_REL of the plain formulas in float64 and
    its backward bit-equal over two runs; then one R-GAT step on the same
    batch (`rgat_step_launches`) and its layer 0 both ways
    (`rgat_layer0_paths`).  Per relation: the forward and the backward
    (the stable sort of the keys and both passes) timed apart, the plain
    version's forward + backward, and the einsum path it replaced
    (`einsum_ms`, forward + backward by autograd).  Bytes: `bound_ms`
    counts every input read once and every output written once (z, the
    indices and mask, s_dst, out and lse; then z, s_dst, g, out, lse again,
    grad_z and grad_s_dst); `slot_bound_ms` counts a 512 B row a slot and
    head instead of z once, read once forward and twice backward (z_u,
    then g_v by source)."""
    from repro_torch.kernels import relation_attend as ra
    batch, cfg = rgat_batch(torch, np)
    blocks = rgat_layer0(torch, batch, cfg)
    H = cfg["num_heads"]
    C = cfg["hidden_dim"] // H
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for name, R, i_src, mask in blocks:
        m, f = i_src.shape
        z = torch.randn((R, H, C), generator=gen, device="cuda")
        a_src = 0.1 * torch.randn((H, C), generator=gen, device="cuda")
        s_dst = torch.randn((m, H), generator=gen, device="cuda")
        g = torch.randn((m, H * C), generator=gen, device="cuda")
        idx = (i_src, mask)

        def forward(fn):
            leaves = [t.clone().requires_grad_() for t in (z, a_src, s_dst)]
            return fn(*leaves, *idx), leaves

        def grads(out, leaves):
            return torch.autograd.grad(out, leaves, g)

        out, leaves = forward(ra.relation_attend)
        got = (out.detach(), *grads(out, leaves))
        again = grads(*forward(ra.relation_attend))
        wide = [t.double() for t in (z, a_src, s_dst)]
        w_out, lse = ra.attend_ref(*wide, *idx)
        want = (w_out, *ra.attend_backward_ref(g.double(), *wide, *idx,
                                                w_out, lse))
        torch.cuda.synchronize()
        rel = {k: float((a.double() - b).norm() / b.norm())
               for k, a, b in zip(("out", "grad_z", "grad_a_src",
                                   "grad_s_dst"), got, want)}
        check(max(rel.values()) < RELATION_ATTEND_REL,
              f"relation_attend {name} {rel}")
        check(all(torch.equal(a, b) for a, b in zip(got[1:], again)),
              f"relation_attend {name}: two backward runs differ")
        err = max(float((a.double() - b).abs().max())
                  for a, b in zip(got, want))
        unmasked = int(mask.sum())
        row4, idx_bytes, score4 = H * C * 4, m * f * 5, m * H * 4
        fwd_bytes = R * row4 + idx_bytes + score4 + m * row4 + score4
        bwd_bytes = (R * row4 + idx_bytes + score4 + 2 * m * row4 + score4
                     + R * row4 + score4)
        slot_bytes = (3 * unmasked * row4 + idx_bytes + 3 * m * row4
                      + 5 * score4 + R * row4)
        fwd_ms = timer(lambda: ra.relation_attend(z, a_src, s_dst, *idx))
        bwd_ms = timer(grads, lambda: forward(ra.relation_attend))
        p_out, p_lse = ra.attend_ref(z, a_src, s_dst, *idx)
        plain_ms = (timer(lambda: ra.attend_ref(z, a_src, s_dst, *idx))
                    + timer(lambda: ra.attend_backward_ref(
                        g, z, a_src, s_dst, *idx, p_out, p_lse)))
        row = {"phase": "kernel", "name": "relation_attend", "relation": name,
               "shape": [m, f, R, H, C], "unmasked": unmasked,
               "max_abs_err": err, "rel_err": rel,
               "kernel_ms": fwd_ms + bwd_ms, "fwd_ms": fwd_ms,
               "bwd_ms": bwd_ms, "plain_ms": plain_ms,
               "einsum_ms": (timer(lambda: _einsum_attend(
                   torch, z, a_src, s_dst, *idx))
                   + timer(grads, lambda: forward(
                       lambda *t: _einsum_attend(torch, *t)))),
               "library_ms": None,
               "fwd_bound_ms": bound(fwd_bytes)["bound_ms"],
               "slot_bound_ms": bound(slot_bytes)["bound_ms"],
               **bound(fwd_bytes + bwd_bytes)}
        emit(row)
        rows.append(row)
        del z, g, out, leaves, got, again, want, wide, p_out, p_lse
    step = summary(rows)
    step.update({k: sum(r[k] for r in rows)
                 for k in ("fwd_ms", "bwd_ms", "einsum_ms", "fwd_bound_ms",
                           "slot_bound_ms")})
    emit({"phase": "kernel", "name": "relation_attend_layer0", **step})
    del blocks
    step.update(kernel_fold_scores(torch, timer, batch, cfg))
    torch.cuda.empty_cache()
    step["step_launches"] = rgat_step_launches(torch, batch, cfg)["launches"]
    torch.cuda.empty_cache()
    paths = rgat_layer0_paths(torch, timer, batch, cfg)
    step.update({f"layer0_{k}": paths[k] for k in ("folded", "before")})
    return step

#: `hgt_attend` against the plain formulas in float64, by norm (tests/
#: test_torch_hgt_attend.py's CARD_REL)
HGT_ATTEND_REL = 1e-5


def kernel_hgt_attend(torch, timer, np) -> dict:
    """`hgt_attend` (HGT's softmax across every relation into a
    destination) forward and backward at each layer of one RGAT_BATCH
    batch of the `hgt3-igbh` cell, as `HGT` hands it the batch
    (`hgt_blocks`' CSR over level k and the relations' stacked k'/v' rows;
    random q, k', v' and out's gradient g at 8 heads of 32): out, dq, dk'
    and dv' each within HGT_ATTEND_REL of the plain formulas in float64,
    the backward bit-equal over two runs; then one whole HGT step on the
    batch (`hgt_step_launches`).  Per layer: the forward and the backward
    (the stable sort of `idx` and both passes; the sort alone beside it)
    timed, and the plain version's forward + backward on the card.
    `bound_ms` is the `hgt` family's compulsory bytes
    (`hgt_attend_bytes`, the bytes `hgt_attend_roofline` counts: q, each
    k'/v' row once, the CSR, out and the log-sum-exp forward; those, g,
    dq, dk' and dv' backward); `slot_bound_ms` reads a 1 KB row of two
    tensors for every slot in each pass instead (k' and v' forward and in
    the destination pass, q and g in the row pass)."""
    sys.path.insert(0, str(ROOT))
    from bench.families import hgt as family
    from repro_torch.kernels import hgt_attend as ha
    from repro_torch.models.hgt import hgt_blocks
    blocks, graph, cfg = relational_batch(torch, np, "hgt3-igbh")
    batch = hgt_blocks(blocks, graph, "cuda")
    H, D = ha.HEADS, ha.HEAD_DIM
    L = len(cfg["fanouts"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for layer in range(L):
        hop = batch.hops[L - 1 - layer]
        indptr, idx = hop.indptr, hop.idx
        n, S = len(indptr) - 1, len(idx)
        R = sum(len(r) for _, _, r in hop.rows)
        q = 0.3 * torch.randn((n, H, D), generator=gen, device="cuda")
        k = 0.3 * torch.randn((R, H, D), generator=gen, device="cuda")
        v = torch.randn((R, H, D), generator=gen, device="cuda")
        g = torch.randn((n, H * D), generator=gen, device="cuda")

        def run():
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = ha.hgt_attend(*leaves, indptr, idx)
            return (out.detach(), *torch.autograd.grad(out, leaves, g))

        got, again = run(), run()
        wide = [t.double() for t in (q, k, v)]
        w_out, w_lse = ha.attend_ref(*wide, indptr, idx)
        want = (w_out, *ha.attend_backward_ref(g.double(), *wide, indptr,
                                               idx, w_out, w_lse))
        torch.cuda.synchronize()
        rel = {name: float((a.double() - b).norm() / b.norm())
               for name, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
        check(max(rel.values()) < HGT_ATTEND_REL,
              f"hgt_attend layer {layer} {rel}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"hgt_attend layer {layer}: two runs differ")
        err = max(float((a.double() - b).abs().max())
                  for a, b in zip(got, want))
        del got, again, wide, want, w_out, w_lse
        fwd_bytes, bwd_bytes = family.hgt_attend_bytes(n, S, R, H * D, H)
        row4, csr = H * D * 4, (n + 1 + S) * 4
        slot_fwd = 2 * S * row4 + 2 * n * row4 + csr + n * H * 4
        slot_bwd = (4 * S * row4 + 4 * n * row4 + csr + n * H * 4
                    + 2 * R * row4)
        out, lse = ha._forward(q, k, v, indptr, idx)
        fwd_ms = timer(lambda: ha._forward(q, k, v, indptr, idx))
        bwd_ms = timer(lambda: ha._backward(g, q, k, v, indptr, idx, out,
                                            lse))
        p_out, p_lse = ha.attend_ref(q, k, v, indptr, idx)
        plain_ms = (timer(lambda: ha.attend_ref(q, k, v, indptr, idx))
                    + timer(lambda: ha.attend_backward_ref(
                        g, q, k, v, indptr, idx, p_out, p_lse)))
        row = {"phase": "kernel", "name": "hgt_attend", "layer": layer,
               "shape": [n, S, R, H, D], "max_abs_err": err, "rel_err": rel,
               "kernel_ms": fwd_ms + bwd_ms, "fwd_ms": fwd_ms,
               "bwd_ms": bwd_ms,
               "sort_ms": timer(lambda: torch.sort(idx, stable=True)),
               "plain_ms": plain_ms, "library_ms": None,
               "fwd_bound_ms": bound(fwd_bytes)["bound_ms"],
               "bwd_bound_ms": bound(bwd_bytes)["bound_ms"],
               "slot_bound_ms": bound(slot_fwd + slot_bwd)["bound_ms"],
               **bound(fwd_bytes + bwd_bytes)}
        emit(row)
        rows.append(row)
        del q, k, v, g, out, lse, p_out, p_lse
    step = summary(rows)
    step.update({key: sum(r[key] for r in rows)
                 for key in ("fwd_ms", "bwd_ms", "sort_ms", "fwd_bound_ms",
                             "bwd_bound_ms", "slot_bound_ms")})
    emit({"phase": "kernel", "name": "hgt_attend_layers", **step})
    torch.cuda.empty_cache()
    row = hgt_step_launches(torch, np, batch, blocks, cfg)
    step.update({f"step_{key}": row[key] for key in (
        "launches", "kernels", "hgt_attend_roofline_pct")})
    return step


def hgt_step_launches(torch, np, batch, blocks, cfg) -> dict:
    """One whole HGT `sgd_step` at the cell's widths on `batch` (default
    initialisation, random features and labels): `hgt_attend` launched
    forward and backward once for each layer with a destination, each
    layer counting (`HGT.last_rows`) its level's rows, its unmasked slots
    and, per relation, the distinct sources of that relation's block in
    the sampler's own blocks; the step's peak memory above the features;
    then its device time (`rgat_step_profile`), where the traced
    `hgt_attend` kernels have to be the launches and bytes the `hgt`
    family counts for the step (`attend_counts`, what
    `hgt_attend_roofline` reads), and their roofline share."""
    from bench.families import hgt as family
    from repro_torch.kernels import _build
    from repro_torch.models.hgt import HGT, HGTConfig, sgd_step
    L = len(cfg["fanouts"])
    model = HGT(HGTConfig(
        in_dim=cfg["in_dim"], hidden_dim=cfg["hidden_dim"],
        num_heads=cfg["num_heads"], num_classes=cfg["num_classes"],
        fanouts=tuple(cfg["fanouts"]),
        relations=tuple(tuple(r) for r in cfg["relations"]),
        node_types=tuple(cfg["nodes"])), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    feats = torch.randn((batch.bounds[L][-1], cfg["in_dim"]), generator=gen,
                        device="cuda")
    y = torch.randint(0, cfg["num_classes"], (len(batch.seeds),),
                      generator=gen, device="cuda")
    layers = sum(1 for hop in batch.hops if len(hop.indptr) > 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _build.reset_launches()
    sgd_step(model, feats, batch, y, cfg["lr"])
    torch.cuda.synchronize()
    got = {key: _build.LAUNCHES[key]
           for key in ("hgt_attend_fwd", "hgt_attend_bwd")}
    check(got == {key: layers for key in got},
          f"launches {got}: hgt_attend once per layer with a destination "
          f"({layers})")
    for layer, counted in enumerate(model.last_rows):
        k = L - 1 - layer
        want = {"dst": len(blocks.levels[k]),
                "slots": int(sum(b.mask.sum() for b in blocks.hops[k])),
                "kv_rows": {model.names[b.relation]:
                            len(np.unique(b.src[b.mask]))
                            for b in blocks.hops[k] if b.mask.any()}}
        check(counted == want, f"layer {layer} counted {counted}, its "
              f"blocks hold {want}")
    shape = [(r["dst"], r["slots"], sum(r["kv_rows"].values()))
             for r in model.last_rows]
    nbytes, launches = family.attend_counts(cfg, shape)
    profile = rgat_step_profile(torch, lambda: model.loss(
        feats, batch, y).backward(), named=("hgt_attend",))
    traced = profile["kernel_count_by_class"].get("hgt_attend", 0)
    check(traced == launches, f"{traced} hgt_attend kernels traced a step, "
          f"the hgt family counts {launches}")
    attend_ms = profile["kernel_ms_by_class"]["hgt_attend"]
    row = {"phase": "kernel", "name": "hgt_attend_step", "card": card_line(),
           "launches": got, "kernels": launches, "shape": shape,
           "rows": model.last_rows,
           "step_peak_bytes": torch.cuda.max_memory_allocated() - base,
           "hgt_attend_bytes": nbytes,
           "hgt_attend_roofline_pct": 100.0 * nbytes / HBM_BYTES_PER_S
           / (attend_ms / 1e3),
           "profile": profile}
    emit(row)
    return row


#: `gat_attend` against the plain formulas in float64, by norm (tests/
#: test_torch_gat_attend.py's CARD_REL)
GAT_ATTEND_REL = 1e-5
#: the `gat3-igbs` batch of the gat_attend rows: its seeds' draw
GAT_BATCH = dict(seeds=1024, seed=2**31 + 11)


def gat_batch(torch, np):
    """One GAT_BATCH batch of the `gat3-igbs` cell: its graph drawn on the
    card by bench/rmat.py, its seeds from the b1024 mix's pool, its hops
    sampled by `host_sample_blocks` as the loader samples them, random
    features for its rows and random labels.  Returns (feats (U, D) and
    hop_idx on the card, labels, the configuration)."""
    sys.path.insert(0, str(ROOT))
    from bench import inputs, rmat
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.models.gnn import hop_indices
    from repro_torch.sampling.neighbor import host_sample_blocks
    cfg = json.loads((ROOT / "bench" / "configs" / "gat3-igbs.json")
                     .read_text())
    mix = json.loads((ROOT / "bench" / "traffic" / "b1024.json").read_text())
    g, dev = cfg["graph"], torch.device("cuda")
    indptr, indices = rmat.rmat_csr(
        cfg["nodes"], cfg["edges"], a=g["a"], b=g["b"], c=g["c"],
        generator=inputs.generator(dev, g["seed"]), device=dev)
    graph = CSRGraph(indptr=indptr, indices=indices,
                     num_nodes=len(indptr) - 1, feature_dim=cfg["in_dim"],
                     name=cfg["name"])
    rng = np.random.default_rng(GAT_BATCH["seed"])
    seeds = rng.choice(inputs.seed_pool(indptr, mix["seed_pool"], g["seed"]),
                       GAT_BATCH["seeds"], replace=False)
    blocks = host_sample_blocks(graph, seeds, cfg["fanouts"], rng)
    hop_idx = [torch.from_numpy(i).to(dev) for i in hop_indices(blocks)]
    gen = torch.Generator(device="cuda").manual_seed(17)
    feats = torch.randn((len(blocks.all_nodes), cfg["in_dim"]),
                        generator=gen, device="cuda")
    y = torch.randint(0, cfg["num_classes"], (len(seeds),), generator=gen,
                      device="cuda")
    return feats, hop_idx, y, cfg


def gat_attend_bytes(n: int, f: int, H: int, C: int) -> tuple[int, int]:
    """The least bytes `gat_attend` moves for n destinations of f slots,
    forward and backward: zd and zn read once, out and the softmax's max
    and sum written; zd, zn, out's gradient and those statistics read,
    dzd and dzn written (the attention vectors and their gradients
    besides; the backward's per-block partials, scratch, not counted)."""
    row, stats, attn = 4 * H * C, 4 * 2 * H, 4 * 2 * H * C
    fwd = n * (1 + f) * row + n * row + n * stats + attn
    bwd = n * (2 + f) * row + n * stats + n * (1 + f) * row + 2 * attn
    return fwd, bwd


def kernel_gat_attend(torch, timer, np) -> dict:
    """`gat_attend` (GAT's attention over the fanout) at each of the 6
    layer-levels of one GAT_BATCH batch of the `gat3-igbs` cell, on the
    zd and zn that `GNN._layer` hands it (default initialisation) and a
    random gradient of its output: out, dzd, dzn and both attention
    vectors' gradients each within GAT_ATTEND_REL of the float64 plain
    formulas by norm and equal to the float32 plain version (the eager
    chain under autograd) on the card to the bit, bit-equal over two runs.  Per level the
    forward and the backward (its two launches) timed beside
    `gat_attend_bytes`' bound and the eager chain's forward + backward.
    Then one whole GAT `sgd_step` on the batch (`gat_step_launches`)."""
    from repro_torch.kernels import gat_attend as ga
    from repro_torch.models import gnn
    feats, hop_idx, y, cfg = gat_batch(torch, np)
    model = gnn.GNN(gnn.GNNConfig(
        model="gat", in_dim=cfg["in_dim"], hidden_dim=cfg["hidden_dim"],
        num_classes=cfg["num_classes"], fanouts=tuple(cfg["fanouts"]),
        num_heads=cfg["num_heads"]), device="cuda")
    calls, real = [], gnn.gat_attend

    def recorded(*inputs):
        calls.append(tuple(t.detach() for t in inputs))
        return real(*inputs)
    with mock.patch.object(gnn, "gat_attend", recorded), torch.no_grad():
        model(feats, hop_idx)
    L = len(cfg["fanouts"])
    levels = [(t, lvl) for t in range(L) for lvl in range(L - t)]
    check(len(calls) == len(levels), f"{len(calls)} gat_attend calls a "
          f"forward, {len(levels)} layer-levels")
    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = []
    for (layer, level), inputs in zip(levels, calls):
        n, f, H, C = inputs[1].shape
        g = torch.randn((n, H * C), generator=gen, device="cuda")

        def run(attend=ga.gat_attend):
            leaves = [t.clone().requires_grad_() for t in inputs]
            out = attend(*leaves)
            return (out.detach(), *torch.autograd.grad(out, leaves, g))

        got, again = run(), run()
        plain = run(ga.attend_ref)
        wide = [t.double() for t in inputs]
        want = (ga.attend_ref(*wide),
                *ga.attend_backward_ref(g.double(), *wide))
        torch.cuda.synchronize()
        names = ("out", "dzd", "dzn", "d_attn_src", "d_attn_dst")
        rel = {k: float((a.double() - b).norm() / b.norm())
               for k, a, b in zip(names, got, want)}
        plain_diff = {k: int((a != b).sum())
                      for k, a, b in zip(names, got, plain)}
        where = f"gat_attend layer {layer} level {level}"
        check(max(rel.values()) < GAT_ATTEND_REL, f"{where} {rel}")
        check(not any(plain_diff.values()),
              f"{where}: elements unlike the eager chain's {plain_diff}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{where}: two runs differ")
        err = max(float((a.double() - b).abs().max())
                  for a, b in zip(got, want))
        del got, again, plain, wide, want
        out, stats = ga._forward(*inputs)
        fwd_ms = timer(lambda: ga._forward(*inputs))
        bwd_ms = timer(lambda: ga._backward(g, *inputs, stats))
        leaves = [t.detach().requires_grad_() for t in inputs]
        plain_ms = timer(lambda: torch.autograd.grad(
            ga.attend_ref(*leaves), leaves, g))
        fwd_bytes, bwd_bytes = gat_attend_bytes(n, f, H, C)
        row = {"phase": "kernel", "name": "gat_attend", "layer": layer,
               "level": level, "shape": [n, f, H, C], "max_abs_err": err,
               "rel_err": rel, "plain_diff": plain_diff,
               "kernel_ms": fwd_ms + bwd_ms, "fwd_ms": fwd_ms,
               "bwd_ms": bwd_ms, "plain_ms": plain_ms, "library_ms": None,
               "fwd_bound_ms": bound(fwd_bytes)["bound_ms"],
               "bwd_bound_ms": bound(bwd_bytes)["bound_ms"],
               **bound(fwd_bytes + bwd_bytes)}
        emit(row)
        rows.append(row)
        del out, stats, leaves, g
    del calls
    step = summary(rows)
    step.update({key: sum(r[key] for r in rows)
                 for key in ("fwd_ms", "bwd_ms", "fwd_bound_ms",
                             "bwd_bound_ms")})
    emit({"phase": "kernel", "name": "gat_attend_levels", **step})
    torch.cuda.empty_cache()
    row = gat_step_launches(torch, model, feats, hop_idx, y, cfg)
    step.update({f"step_{key}": row[key] for key in (
        "launches", "kernels", "gat_attend_ms", "busy_ms",
        "eager_busy_ms")})
    return step


def gat_step_launches(torch, model, feats, hop_idx, y, cfg) -> dict:
    """One whole GAT `sgd_step` on the batch: `gat_attend` launched forward
    and backward once for each of the step's layer-levels; then the
    device time of its forward and backward (`rgat_step_profile`), where
    the traced `gat_attend` kernels have to be those launches, beside the
    same step with the eager chain (`attend_ref`) in the kernels' place;
    the two steps' parameters have to be equal to the bit."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.gat_attend import attend_ref
    from repro_torch.models import gnn
    L = len(cfg["fanouts"])
    levels = L * (L + 1) // 2
    _build.reset_launches()
    gnn.sgd_step(model, feats, hop_idx, y, cfg["lr"])
    torch.cuda.synchronize()
    got = {key: _build.LAUNCHES[key]
           for key in ("gat_attend_fwd", "gat_attend_bwd")}
    check(got == {key: levels for key in got},
          f"launches {got}: gat_attend once per layer-level ({levels})")
    kernels = 2 * levels
    profile = rgat_step_profile(torch, lambda: model.loss(
        feats, hop_idx, y).backward(), named=("gat_attend",))
    traced = profile["kernel_count_by_class"].get("gat_attend", 0)
    check(traced == kernels, f"{traced} gat_attend kernels traced a step, "
          f"{kernels} launched")
    eager_model = gnn.GNN(model.cfg, device="cuda")
    eager_model.load_reference_params(model.param_tree())
    with mock.patch.object(gnn, "gat_attend", attend_ref):
        eager = rgat_step_profile(torch, lambda: eager_model.loss(
            feats, hop_idx, y).backward(), named=("gat_attend",))
        gnn.sgd_step(eager_model, feats, hop_idx, y, cfg["lr"])
    gnn.sgd_step(model, feats, hop_idx, y, cfg["lr"])
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 eager_model.parameters())),
          "a GAT step through gat_attend differs from the eager chain's")
    row = {"phase": "kernel", "name": "gat_attend_step", "card": card_line(),
           "launches": got, "kernels": kernels,
           "gat_attend_ms": profile["kernel_ms_by_class"]["gat_attend"],
           "busy_ms": profile["busy_ms"], "eager_busy_ms": eager["busy_ms"],
           "profile": profile, "eager_profile": eager}
    emit(row)
    return row


# -- phase 3 -------------------------------------------------------------------

def workload(torch, np):
    """The full-width graph, labels, features and model of
    examples/train_gnn_igb_torch.py, from seed 0."""
    from repro_torch.graph.synthetic import rmat_graph
    from repro_torch.models.gnn import GNN, GNNConfig
    rng = np.random.default_rng(0)
    dim = FULL["dim"]
    graph = rmat_graph(FULL["nodes"], 12, dim, seed=0, name="igb-synthetic")
    n_classes = 47
    labels_all = rng.integers(0, n_classes, graph.num_nodes)
    feats = (np.eye(n_classes, dim)[labels_all] * 2.0
             + 0.5 * rng.standard_normal((graph.num_nodes, dim))
             ).astype(np.float32)
    cfg = GNNConfig(model="sage", in_dim=dim, hidden_dim=FULL["hidden"],
                    num_classes=n_classes, fanouts=(10, 5))
    gnn = GNN(cfg, generator=torch.Generator().manual_seed(0), device=DEVICE)
    return graph, labels_all, feats, cfg, gnn


#: the row kernels of the device tier's path, each held against its plain
#: version on the path's own inputs at PARITY steps
ROW_KERNELS = ("tiered_gather", "tiered_gather_unique", "store_fill")


@contextlib.contextmanager
def _checked_on_path(torch, what: str):
    """Every call of ROW_KERNELS inside the block runs beside its plain
    version (`kernels.ref`) on the same inputs, the staged map included
    where the path passes one, and must equal it bit for bit.  Yields the
    list of calls: kernel, requests, requests served from the row store,
    staged rows, whether a map came, the lines filled, and the plain
    gathers' outputs (`plain`, for a loss parity)."""
    from repro_torch.kernels import ops, ref
    calls, real = [], {n: getattr(ops, n) for n in ROW_KERNELS}

    def record(name, slots, staged, with_map, **extra):
        calls.append({"kernel": name, "staged_rows": int(staged.shape[0]),
                      "map": with_map, **extra})
        if with_map and slots is not None:
            # a map holds only the rows the card reads: no hit is staged
            check(calls[-1]["staged_rows"]
                  == calls[-1]["requests"] - calls[-1]["from_store"],
                  f"{what}: {name} got {calls[-1]['staged_rows']} staged "
                  f"rows for {calls[-1]['requests']} requests of which "
                  f"{calls[-1]['from_store']} are served from the store")

    def gather(name, n_args):
        def run(slots, cache, staged, *rest):
            out = real[name](slots, cache, staged, *rest)
            want = getattr(ref, name + "_ref")(slots, cache, staged, *rest)
            check(torch.equal(out, want), f"{what}: {name} call "
                  f"{len(calls)} differs from its plain version")
            record(name, slots, staged, len(rest) == n_args,
                   requests=int(slots.numel()),
                   from_store=int((slots >= 0).sum()), out_rows=len(want),
                   plain=want)
            return out
        return run

    def fill(rows, last_filler, staged, *rest):
        want = rows.clone()
        real["store_fill"](rows, last_filler, staged, *rest)
        ref.store_fill_ref(want, last_filler, staged, *rest)
        check(torch.equal(rows, want), f"{what}: store_fill call "
              f"{len(calls)} differs from its plain version")
        record("store_fill", None, staged, len(rest) == 1,
               filled=int((last_filler >= 0).sum()))

    with mock.patch.multiple(
            ops, tiered_gather=gather("tiered_gather", 1),
            tiered_gather_unique=gather("tiered_gather_unique", 2),
            store_fill=fill):
        yield calls


def _tier_totals(counts) -> dict:
    """The device tier's `last_counts`, summed over probes (empty where
    the tier keeps none)."""
    out: dict = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def _parity_line(calls) -> list:
    return [{k: v for k, v in c.items() if k != "plain"} for c in calls]


def main_path(torch, np):
    from repro_torch.core import INTEL_OPTANE, GIDSDataLoader, LoaderConfig
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models.gnn import hop_indices, sgd_step

    t0 = time.perf_counter()
    graph, labels_all, feats, cfg, gnn = workload(torch, np)
    loader = GIDSDataLoader(
        graph, feats,
        LoaderConfig(batch_size=FULL["batch"], fanouts=cfg.fanouts,
                     data_plane="gids-device",
                     cache_lines=FULL["cache_lines"],
                     window_depth=8, cbuf_fraction=0.1),
        ssd=INTEL_OPTANE, device="cuda")
    tier = loader.store.tiers[0]
    host_feats = torch.from_numpy(feats).cuda()
    labels_dev = torch.from_numpy(labels_all).cuda()
    emit({"phase": "setup", "seconds": round(time.perf_counter() - t0, 3),
          "params": sum(p.numel() for p in gnn.parameters()),
          "edges": graph.num_edges})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    steps = []
    for step in range(STEPS):
        t_start = time.perf_counter()
        plan = loader.plan_next()
        t_planned = time.perf_counter()
        with (_checked_on_path(torch, f"step {step}") if step in PARITY
              else contextlib.nullcontext([])) as calls:
            batch = loader.execute(plan)      # ends synchronised
        t_executed = time.perf_counter()
        split = dict(tier.last_split_ms)
        nodes = torch.from_numpy(batch.blocks.all_nodes).cuda()
        hi = [torch.from_numpy(i).cuda() for i in hop_indices(batch.blocks)]
        y = labels_dev[torch.from_numpy(batch.blocks.seeds).cuda()]
        if step in PARITY:
            # step 0 runs cold (every row staged), the last step warm (hits
            # served from the row store, only the misses staged); launches
            # made to compare with the plain versions do not count
            saved = dict(_build.LAUNCHES)
            with torch.no_grad():
                loss_kernel = gnn.loss(batch.features, hi, y).item()
                with mock.patch.object(ops, "segment_mean",
                                       ref.segment_mean_ref):
                    loss_plain = gnn.loss(batch.features, hi, y).item()
            _build.LAUNCHES.update(saved)
            rel = abs(loss_kernel - loss_plain) / abs(loss_plain)
            emit({"phase": "step_parity", "step": step,
                  "loss_kernel": loss_kernel, "loss_plain": loss_plain,
                  "rel_err": rel, "calls": _parity_line(calls)})
            check(rel <= 1e-5, f"step-{step} loss {loss_kernel} vs plain "
                               f"{loss_plain}")
            kinds = {c["kernel"] for c in calls}
            check({"tiered_gather", "store_fill"} <= kinds,
                  f"step {step}: the row kernels ran {sorted(kinds)}")
            check(step == 0 or any(c.get("from_store", 0) for c in calls),
                  f"step {step}: no request served from the row store")
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        loss = sgd_step(gnn, batch.features, hi, y, 0.05)
        ev1.record()
        loss_v = loss.item()
        t_end = time.perf_counter()
        check(isinstance(batch.features, torch.Tensor)
              and batch.features.is_cuda, "features left the device")
        check(torch.equal(batch.features, host_feats[nodes]),
              f"step {step}: features differ from host_features[all_nodes]")
        check(np.isfinite(loss_v), f"step {step}: loss {loss_v}")
        cache = tier.store.cache
        hits, misses = int(cache.hits), int(cache.misses)
        steps.append({"phase": "step", "step": step, "loss": loss_v,
              "unique_rows": int(len(batch.blocks.all_nodes)),
              "tier_counts": list(batch.report.tier_counts),
              "device_tier": dict(getattr(tier, "last_counts", {})),
              "wall_ms": (t_end - t_start) * 1e3,
              "sample_ms": (t_planned - t_start) * 1e3,
              "execute_ms": (t_executed - t_planned) * 1e3,
              **{f"{k}_ms": v for k, v in split.items()},
              "train_ms": ev0.elapsed_time(ev1),
              "prep_time_s": batch.prep_time_s,
              "hit_ratio": hits / max(hits + misses, 1)})
        emit(steps[-1])
    check(hits > 0, "the device cache never hit")
    launches = dict(_build.LAUNCHES)
    # step 0 pays the first cuBLAS call, and the PARITY steps the checks
    timed = [s for s in steps if s["step"] not in PARITY]
    median = {k: statistics.median(s[k] for s in timed)
              for k, v in timed[0].items()
              if k.endswith(("_ms", "_s")) and isinstance(v, float)}
    emit({"phase": "main_path", "plane": "gids-device", "steps": STEPS,
          "launches": launches, "hit_ratio": hits / max(hits + misses, 1),
          "device_tier": _tier_totals(s["device_tier"] for s in steps),
          "median_of_unchecked_steps": median,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    for name in PATH_KERNELS["gids-device"]:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the gids-device path")
    return launches


MERGED_PLANE = "gids-device+merge_execute+topology"


def merged_topology_path(torch, np):
    """Phase 4: MERGED_STEPS training steps on the merged-window, topology
    plane over the device store, through `loader.next_batch()`."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models.gnn import hop_indices, sgd_step

    t0 = time.perf_counter()
    graph, labels_all, feats, cfg, gnn = workload(torch, np)
    loader = _host_loader(torch, graph, feats, cfg, _plane_spec(MERGED_PLANE))
    topo, tier = loader.topo, loader.store.tiers[0]
    host_feats = torch.from_numpy(feats).to(DEVICE)
    labels_dev = torch.from_numpy(labels_all).to(DEVICE)
    emit({"phase": "setup", "plane": MERGED_PLANE,
          "seconds": round(time.perf_counter() - t0, 3),
          "edges": graph.num_edges, "edge_pages": topo.n_pages,
          "pages_by_tier": list(topo.tier_pages()),
          "hot_pages_bytes": topo.hot_pages().numel()
          * topo.hot_pages().element_size()})

    # every hop's word reads as the sampler makes them, each held against
    # graph.indices; hop_report sees the same hops' real edge reads
    hops = {"gathers": 0, "reports": 0, "reads": 0, "words": 0,
            "gather_ms": 0.0}
    call_ms = []                     # host clock of each frontier_gather
    frontier_gather, hop_report = topo.frontier_gather, topo.hop_report

    def checked_frontier_gather(pos):
        t = time.perf_counter()
        out = frontier_gather(pos)
        call_ms.append((time.perf_counter() - t) * 1e3)
        hops["gather_ms"] += call_ms[-1]
        check(np.array_equal(out, graph.indices[pos]),
              f"frontier_gather differs from graph.indices on hop "
              f"{hops['gathers']}")
        hops["gathers"] += 1
        hops["words"] += int(np.size(pos))
        return out

    def counted_hop_report(read_pos, **kw):
        hops["reports"] += 1
        hops["reads"] += len(read_pos)
        return hop_report(read_pos, **kw)

    # host clock around each window's two stages
    windows = []
    plan_window, execute_window = loader.plan_window, loader.execute_window

    def timed_plan_window():
        t, g, n = time.perf_counter(), hops["gather_ms"], len(call_ms)
        plans = plan_window()
        windows.append({"sample_ms": (time.perf_counter() - t) * 1e3,
                        "sample_frontier_gather_ms": hops["gather_ms"] - g,
                        "frontier_calls": len(call_ms) - n,
                        "frontier_call_ms": statistics.median(call_ms[n:])})
        return plans

    def timed_execute_window(plans):
        t = time.perf_counter()
        batches = execute_window(plans)
        windows[-1]["execute_ms"] = (time.perf_counter() - t) * 1e3
        return batches

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with mock.patch.object(topo, "frontier_gather", checked_frontier_gather), \
            mock.patch.object(topo, "hop_report", counted_hop_report), \
            mock.patch.object(loader, "plan_window", timed_plan_window), \
            mock.patch.object(loader, "execute_window",
                              timed_execute_window):
        _build.reset_launches()
        for step in range(MERGED_STEPS):
            n_windows = len(windows)
            t_start = time.perf_counter()
            # each window's first step runs its probe: the first window's
            # cold, the second's warm; there every expansion and the fill
            # are held against their plain versions on the path's inputs
            with (_checked_on_path(torch, f"merged step {step}")
                  if step in MERGED_PARITY else contextlib.nullcontext([])) \
                    as calls:
                batch = loader.next_batch()
            t_batch = time.perf_counter()
            if len(windows) > n_windows:
                plan = loader.store.last_plan
                w = windows[-1]
                w.update({f"{k}_ms": v for k, v in tier.last_split_ms.items()})
                w["device_tier"] = dict(getattr(tier, "last_counts", {}))
                report = batch.report
                w.update({"phase": "window", "window": len(windows) - 1,
                          "batches": report.window_batches,
                          "requests": report.window_requests,
                          "unique_rows": report.n_unique,
                          "duplicates": report.n_duplicate,
                          "storage_unique": report.n_storage_unique,
                          "storage_lines": report.n_storage_lines,
                          "unique_tier_counts": [
                              int(c) for c in plan.counts()]})
            nodes = torch.from_numpy(batch.blocks.all_nodes).to(DEVICE)
            hi = [torch.from_numpy(i).to(DEVICE) for i in hop_indices(batch.blocks)]
            y = labels_dev[torch.from_numpy(batch.blocks.seeds).to(DEVICE)]
            if step in MERGED_PARITY:
                saved = dict(_build.LAUNCHES)
                expansions = [c for c in calls
                              if c["kernel"] == "tiered_gather_unique"]
                check(len(expansions) == batch.report.window_batches
                      and any(c["kernel"] == "store_fill" for c in calls),
                      f"merged step {step}: the row kernels ran "
                      f"{[c['kernel'] for c in calls]}")
                check(step == 0 or any(c["from_store"] for c in expansions),
                      f"merged step {step}: no row served from the store")
                plain = expansions[0]["plain"]
                check(torch.equal(plain, batch.features),
                      f"merged step {step}: the batch is not its window's "
                      "first expansion")
                with torch.no_grad():
                    loss_kernel = gnn.loss(batch.features, hi, y).item()
                    with mock.patch.object(ops, "segment_mean",
                                           ref.segment_mean_ref):
                        loss_plain = gnn.loss(plain, hi, y).item()
                _build.LAUNCHES.update(saved)
                rel = abs(loss_kernel - loss_plain) / abs(loss_plain)
                emit({"phase": "step_parity", "plane": MERGED_PLANE,
                      "step": step, "loss_kernel": loss_kernel,
                      "loss_plain": loss_plain, "rel_err": rel,
                      "calls": _parity_line(calls)})
                del calls[:], plain
                check(rel <= 1e-5, f"merged step-{step} loss {loss_kernel} "
                                   f"vs plain {loss_plain}")
            torch.cuda.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            loss = sgd_step(gnn, batch.features, hi, y, 0.05)
            ev1.record()
            loss_v = loss.item()
            t_end = time.perf_counter()
            check(isinstance(batch.features, torch.Tensor)
                  and batch.features.device.type == DEVICE,
                  "features left the device")
            check(torch.equal(batch.features, host_feats[nodes]),
                  f"merged step {step}: features differ from "
                  f"host_features[all_nodes]")
            check(np.isfinite(loss_v), f"merged step {step}: loss {loss_v}")
            check(batch.sample_time_s > 0,
                  f"merged step {step}: no priced sampling time")
            steps.append({"phase": "step", "plane": MERGED_PLANE,
                          "step": step, "loss": loss_v,
                          "unique_rows": int(len(batch.blocks.all_nodes)),
                          "tier_counts": list(batch.report.tier_counts),
                          "batch_ms": (t_batch - t_start) * 1e3,
                          "train_ms": ev0.elapsed_time(ev1),
                          "wall_ms": (t_end - t_start) * 1e3,
                          "prep_time_s": batch.prep_time_s,
                          "sample_time_s": batch.sample_time_s,
                          "hop_reports": [
                              {"pages_by_tier": list(r.pages_by_tier),
                               "reads": r.n_edge_reads, "time_s": r.time_s}
                              for r in batch.blocks.hop_reports]})
            emit(steps[-1])
        launches = dict(_build.LAUNCHES)
    for w in windows:
        emit(w)
    check(len(windows) == 2, f"expected 2 merged windows, ran {len(windows)}")
    check(hops["gathers"] == hops["reports"] > 0,
          f"{hops['gathers']} frontier gathers for {hops['reports']} hops")
    hops["frontier_call_ms"] = statistics.median(call_ms)
    cache = tier.store.cache
    hits, misses = int(cache.hits), int(cache.misses)
    check(hits > 0, "the device cache never hit on the merged path")
    median = {k: statistics.median(s[k] for s in steps
                                   if s["step"] not in MERGED_PARITY)
              for k in ("train_ms", "wall_ms", "prep_time_s",
                        "sample_time_s")}
    emit({"phase": "main_path", "plane": MERGED_PLANE,
          "steps": MERGED_STEPS, "launches": launches, "hops": hops,
          "hit_ratio": hits / max(hits + misses, 1),
          "device_tier": _tier_totals(w["device_tier"] for w in windows),
          "median_of_unchecked_steps": median,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    for name in PATH_KERNELS[MERGED_PLANE]:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the merged path")
    check(launches["frontier_read"] == hops["gathers"],
          f"{launches['frontier_read']} frontier_read launches for "
          f"{hops['gathers']} hops (one per hop expected)")
    return launches


#: phase 4b: the two host planes trained on, and the planes driven for
#: their features only
HOST_PLANES = ("gids-async", "gids-merged-async")
FEATURE_PLANES = ("bam", "mmap", "pinned-host")
HOST_STEPS, FEATURE_BATCHES = 16, 4


def _check_row_store(torch, tier, host_feats, what: str) -> None:
    """Every resident line of a numpy cache's row store (the window
    cache's, or the tenant cache's partitions' lines in order) holds its
    tag's feature row, bit for bit."""
    tags = torch.from_numpy(tier._flat_tags()).to(DEVICE)
    resident = tags >= 0
    check(tier.rows.shape[0] == tags.numel()
          and torch.equal(tier.rows[resident], host_feats[tags[resident]]),
          f"{what}: a resident line of the row store differs from its "
          "tag's feature row")


def _host_loader(torch, graph, feats, cfg, plane, tracer=None):
    from repro_torch.core import INTEL_OPTANE, GIDSDataLoader, LoaderConfig
    return GIDSDataLoader(
        graph, feats,
        LoaderConfig(batch_size=FULL["batch"], fanouts=cfg.fanouts,
                     data_plane=plane, cache_lines=FULL["cache_lines"],
                     window_depth=8, cbuf_fraction=0.1),
        ssd=INTEL_OPTANE, device=DEVICE, tracer=tracer)


def host_plane_path(torch, np, plane, work, host_feats) -> dict:
    """HOST_STEPS training steps on one host plane through
    `next_batch(compute_s=last_step_s)`: the numpy window cache on the
    host, its row store on the card serving the hits."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models.gnn import hop_indices, sgd_step
    graph, labels_all, feats, cfg, gnn = work
    loader = _host_loader(torch, graph, feats, cfg, plane)
    tier = loader.store.tiers[0]
    merged = loader.plane.merge_execute
    gather_name = "tiered_gather_unique" if merged else "tiered_gather"
    labels_dev = torch.from_numpy(labels_all).to(DEVICE)

    # every probe: its split and counts, and the row-store invariant
    probes = []
    probe_rows = tier._probe_rows

    def recorded_probe(*args):
        hits = probe_rows(*args)
        _check_row_store(torch, tier, host_feats, f"{plane} probe "
                                                  f"{len(probes)}")
        probes.append({"split": dict(tier.last_split_ms),
                       "counts": dict(tier.last_counts)})
        return hits

    # the first gather's plain version on the same inputs (not a launch),
    # for the step-0 parity
    plain0 = []
    gather = getattr(ops, gather_name)
    plain = getattr(ref, gather_name + "_ref")

    def gather_and_plain(*args):
        out = gather(*args)
        if not plain0:
            plain0.append(plain(*args))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, last_step_s, warm = [], 0.0, 1
    with mock.patch.object(tier, "_probe_rows", recorded_probe):
        _build.reset_launches()
        for step in range(HOST_STEPS):
            n_probes, given = len(probes), last_step_s
            t_start = time.perf_counter()
            if step == 0:
                with mock.patch.object(ops, gather_name, gather_and_plain):
                    batch = loader.next_batch(compute_s=last_step_s)
            else:
                batch = loader.next_batch(compute_s=last_step_s)
            t_batch = time.perf_counter()
            nodes = torch.from_numpy(batch.blocks.all_nodes).to(DEVICE)
            hi = [torch.from_numpy(i).to(DEVICE)
                  for i in hop_indices(batch.blocks)]
            y = labels_dev[torch.from_numpy(batch.blocks.seeds).to(DEVICE)]
            if step == 0:
                warm = batch.report.window_batches if merged else 1
                saved = dict(_build.LAUNCHES)
                check(len(plain0) == 1
                      and torch.equal(plain0[0], batch.features),
                      f"{plane} step 0: {gather_name} differs from its "
                      "plain version on the path")
                with torch.no_grad():
                    loss_kernel = gnn.loss(batch.features, hi, y).item()
                    with mock.patch.object(ops, "segment_mean",
                                           ref.segment_mean_ref):
                        loss_plain = gnn.loss(plain0[0], hi, y).item()
                _build.LAUNCHES.update(saved)
                plain0.clear()
                rel = abs(loss_kernel - loss_plain) / abs(loss_plain)
                emit({"phase": "step0_parity", "plane": plane,
                      "loss_kernel": loss_kernel, "loss_plain": loss_plain,
                      "rel_err": rel})
                check(rel <= 1e-5, f"{plane} step-0 loss {loss_kernel} vs "
                                   f"plain {loss_plain}")
            torch.cuda.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ts = time.perf_counter()
            ev0.record()
            loss = sgd_step(gnn, batch.features, hi, y, 0.05)
            ev1.record()
            loss_v = loss.item()                  # synchronises the step
            t_end = time.perf_counter()
            if step > 0:               # step 0 pays the first cuBLAS calls
                last_step_s = t_end - ts
            # consumed after later batches were staged and their fills landed
            check(batch.features.device.type == DEVICE
                  and torch.equal(batch.features, host_feats[nodes]),
                  f"{plane} step {step}: features differ from "
                  "host_features[all_nodes]")
            _check_row_store(torch, tier, host_feats, f"{plane} step {step}")
            check(np.isfinite(loss_v), f"{plane} step {step}: loss {loss_v}")
            check(batch.exposed_prep_s <= batch.prep_time_s,
                  f"{plane} step {step}: exposed prep {batch.exposed_prep_s}"
                  f" above prep {batch.prep_time_s}")
            check(step < warm or batch.report.n_hbm_hits > 0,
                  f"{plane} step {step}: no cache hit after warm-up")
            made = probes[n_probes:]
            split = {f"{k}_ms": sum(p["split"].get(k, 0.0) for p in made)
                     for k in ("probe", "stage_host", "h2d", "gather",
                               "fill")}
            counts = {k: sum(p["counts"][k] for p in made)
                      for k in ("rows", "hits", "staged_rows", "h2d_bytes",
                                "needed_bytes")}
            steps.append({"phase": "step", "plane": plane, "step": step,
                          "loss": loss_v,
                          "batch_rows": int(batch.report.n_requests),
                          "batch_hbm_hits": int(batch.report.n_hbm_hits),
                          "next_batch_ms": (t_batch - t_start) * 1e3,
                          "probes": len(made), **split,
                          "probed": counts,
                          "train_ms": ev0.elapsed_time(ev1),
                          "wall_ms": (t_end - t_start) * 1e3,
                          "compute_s_given": given,
                          "prep_time_s": batch.prep_time_s,
                          "exposed_prep_s": batch.exposed_prep_s})
            emit(steps[-1])
        launches = dict(_build.LAUNCHES)
    staged = loader.prefetch.stats.staged_batches
    stats = loader.store.cache.stats
    check(stats.hits > 0, f"the window cache never hit on {plane}")
    # medians of the steps that probed once, after the first
    probing = [s for s in steps[1:] if s["probes"] == 1]
    median = {k: statistics.median(s[k] for s in probing)
              for k in ("next_batch_ms", "probe_ms", "stage_host_ms",
                        "h2d_ms", "gather_ms", "fill_ms")} if probing else {}
    median.update({k: statistics.median(s[k] for s in steps[1:])
                   for k in ("train_ms", "wall_ms", "prep_time_s",
                             "exposed_prep_s")})
    emit({"phase": "main_path", "plane": plane, "steps": HOST_STEPS,
          "staged_batches": staged, "probes": len(probes),
          "launches": launches, "hit_ratio": stats.hit_ratio,
          "prefetch_hidden_fraction": loader.prefetch.stats.hidden_fraction,
          "median_of_steps_1_on": median,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    for name in PATH_KERNELS[plane]:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {plane} path")
    check(launches[gather_name] == staged,
          f"{launches[gather_name]} {gather_name} launches for {staged} "
          "staged batches (one a batch expected)")
    check(launches["segment_mean"] == 2 * HOST_STEPS,
          f"{launches['segment_mean']} segment_mean launches for "
          f"{HOST_STEPS} steps (two a step expected)")
    return launches


def feature_planes(torch, np, work, host_feats) -> None:
    """FEATURE_BATCHES batches of each FEATURE_PLANES plane, features only:
    each batch's rows equal the host features bit for bit (and on `bam` the
    row store stays coherent)."""
    graph, _, feats, cfg, _ = work
    for plane in FEATURE_PLANES:
        loader = _host_loader(torch, graph, feats, cfg, plane)
        top = loader.store.tiers[0]
        times = []
        for i in range(FEATURE_BATCHES):
            t = time.perf_counter()
            batch = loader.next_batch()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            nodes = torch.from_numpy(batch.blocks.all_nodes).to(DEVICE)
            check(batch.features.device.type == DEVICE
                  and torch.equal(batch.features, host_feats[nodes]),
                  f"{plane} batch {i}: features differ from "
                  "host_features[all_nodes]")
            if hasattr(top, "cache"):
                _check_row_store(torch, top, host_feats, f"{plane} batch {i}")
        emit({"phase": "features_only", "plane": plane,
              "batches": FEATURE_BATCHES, "next_batch_ms": times,
              "tier_counts": list(batch.report.tier_counts),
              "prep_time_s": batch.prep_time_s})


def host_planes(torch, np) -> dict:
    """Phase 4b: HOST_PLANES trained on, then FEATURE_PLANES."""
    t0 = time.perf_counter()
    work = workload(torch, np)
    host_feats = torch.from_numpy(work[2]).to(DEVICE)
    emit({"phase": "setup", "plane": "host planes",
          "seconds": round(time.perf_counter() - t0, 3)})
    by_path = {plane: host_plane_path(torch, np, plane, work, host_feats)
               for plane in HOST_PLANES}
    feature_planes(torch, np, work, host_feats)
    return by_path


#: phase 4c: resumable training on the host plane gids-async and on the
#: merged topology plane, LADIES features on two planes, and the device
#: sampler against the host one on fig7's graphs
RESUME_ASYNC = "resume gids-async"
RESUME_MERGED = "resume " + MERGED_PLANE
RESUME = {RESUME_ASYNC: dict(plane="gids-async", steps=12, at=5),
          RESUME_MERGED: dict(plane=MERGED_PLANE, steps=16, at=3)}
LADIES = dict(batch=256, layer_sizes=(2048, 2048), batches=6,
              planes=("gids", "gids-device"))
SAMPLER = dict(datasets=("IGB_TINY", "IGB_SMALL", "IGB_MEDIUM"), batch=512,
               fanouts=(10, 5), device_calls=20, host_calls=5)
#: a device-side sleep long enough to cover the host's enqueue of one
#: device_sample_blocks call (about 1 ms), so that CUDA events around the
#: call time the card's own work
ENQUEUE_SLEEP_CYCLES = 8_000_000


def _bits_equal(torch, a, b) -> bool:
    """Equal bit for bit (so -0.0 differs from 0.0, and NaN equals
    itself), f32 or bf16 tensors of one shape and type."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    as_int = torch.int32 if a.element_size() == 4 else torch.int16
    return torch.equal(a.view(as_int), b.view(as_int))


def _plane_spec(plane):
    from repro_torch.core.dataplane import DataPlaneSpec
    if plane == MERGED_PLANE:
        return DataPlaneSpec.preset("gids-device", merge_execute=True,
                                    topology=True)
    return plane


def _checked_words(np, loader, graph, hops: dict) -> None:
    """Every hop's adjacency words, as the sampler reads them through the
    topology store, held against graph.indices; counts the hops and the
    host time of the check (`gate_s`, which step times leave out)."""
    read = loader.topo.frontier_gather

    def checked(pos):
        out = read(pos)
        t = time.perf_counter()
        check(np.array_equal(out, graph.indices[pos]),
              f"frontier_gather differs from graph.indices on hop "
              f"{hops['n']}")
        hops["gate_s"] += time.perf_counter() - t
        hops["n"] += 1
        return out
    loader.topo.frontier_gather = checked


def _train(torch, np, loader, gnn, labels_dev, host_feats, steps: int,
           what: str, hops: dict | None = None) -> list[dict]:
    """`steps` SGD steps through `loader.next_batch(compute_s=last
    measured step)`, each inside a StepWatchdog (stragglers printed, not
    gated).  Returns each step's seeds, nodes, features and loss, and its
    times without the gates: the step's own checks come after `wall_ms`
    is read, and the hop checks of `_checked_words` (`hops`) are taken
    out of `next_batch_ms` and `wall_ms`."""
    from repro_torch.models.gnn import hop_indices, sgd_step
    from repro_torch.train.fault_tolerance import StepWatchdog, WatchdogConfig
    watchdog = StepWatchdog(WatchdogConfig(min_history=4))
    out, last_step_s = [], 0.0
    for step in range(steps):
        watchdog.start_step(step)
        gate_s = hops["gate_s"] if hops else 0.0
        t_start = time.perf_counter()
        batch = loader.next_batch(compute_s=last_step_s)
        t_batch = time.perf_counter()
        gate_s = (hops["gate_s"] if hops else 0.0) - gate_s
        nodes = torch.from_numpy(batch.blocks.all_nodes).to(DEVICE)
        hi = [torch.from_numpy(i).to(DEVICE)
              for i in hop_indices(batch.blocks)]
        y = labels_dev[torch.from_numpy(batch.blocks.seeds).to(DEVICE)]
        ts = time.perf_counter()
        loss = sgd_step(gnn, batch.features, hi, y, 0.05).item()
        t_end = time.perf_counter()
        if step > 0:               # step 0 pays the first cuBLAS calls
            last_step_s = t_end - ts
        if watchdog.end_step():
            print(f"{what} step {step} STRAGGLER: step took "
                  f"{watchdog.flagged[-1][1]*1e3:.1f} ms (median "
                  f"{watchdog.median_step_s*1e3:.1f} ms)", flush=True)
        check(batch.features.device.type == DEVICE
              and torch.equal(batch.features, host_feats[nodes]),
              f"{what} step {step}: features differ from "
              "host_features[all_nodes]")
        check(np.isfinite(loss), f"{what} step {step}: loss {loss}")
        out.append({"seeds": batch.blocks.seeds,
                    "all_nodes": batch.blocks.all_nodes,
                    "features": batch.features, "loss": loss,
                    "next_batch_ms": (t_batch - t_start - gate_s) * 1e3,
                    "wall_ms": (t_end - t_start - gate_s) * 1e3})
    return out


def _median_ms(run: list[dict]) -> dict:
    """Medians of a run's steps after the first (which pays first calls)."""
    return {k: statistics.median(r[k] for r in run[1:])
            for k in ("next_batch_ms", "wall_ms")} if len(run) > 1 else {}


def resume_path(torch, np, work, host_feats, path: str) -> dict:
    """Train RESUME[path]["steps"] steps straight; then, in the same
    process, a fresh model and loader train `at` steps, save the
    parameters and the loader's state through `train.checkpoint`, and a
    third model (from another seed) and loader restore them and train the
    remaining steps.  The resumed batches and losses must equal the
    straight run's bit for bit."""
    import tempfile

    from repro_torch.kernels import _build
    from repro_torch.models.gnn import GNN
    from repro_torch.train import checkpoint as ckpt
    graph, labels_all, feats, cfg, _ = work
    plane, steps, at = (RESUME[path][k] for k in ("plane", "steps", "at"))
    merged = plane == MERGED_PLANE
    labels_dev = torch.from_numpy(labels_all).to(DEVICE)

    def fresh(seed):
        gnn = GNN(cfg, generator=torch.Generator().manual_seed(seed),
                  device=DEVICE)
        loader = _host_loader(torch, graph, feats, cfg, _plane_spec(plane))
        if merged:
            _checked_words(np, loader, graph, hops)
        return gnn, loader

    hops = {"n": 0, "gate_s": 0.0}
    _build.reset_launches()
    gnn, loader = fresh(0)
    gates = hops if merged else None
    straight = _train(torch, np, loader, gnn, labels_dev, host_feats, steps,
                      f"{path} straight", gates)
    del gnn, loader
    gnn, loader = fresh(0)
    before_ckpt = _train(torch, np, loader, gnn, labels_dev, host_feats, at,
                         f"{path} before the checkpoint", gates)
    if merged:
        check(len(loader._merged_ready) > 0,
              f"{path}: the checkpoint is not inside a merged window")
    else:
        check(loader.prefetch.oldest_snapshot() is not None,
              f"{path}: no prefetched batch staged at the checkpoint")
    saved = {g: {k: v.clone() for k, v in ps.items()}
             for g, ps in gnn.param_tree().items()}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = ckpt.save(tmp, at, gnn.param_tree(),
                            {"loader": loader.state_dict()})
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = sum(f.stat().st_size for f in written.iterdir())
        del gnn, loader
        gnn, loader = fresh(1)
        check(not all(_bits_equal(torch, p, saved[g][k])
                      for g, ps in gnn.param_tree().items()
                      for k, p in ps.items()),
              f"{path}: the third model starts from the saved parameters")
        t0 = time.perf_counter()
        tree, extra = ckpt.restore(tmp, at, gnn.param_tree())
        gnn.load_reference_params(tree)
        loader.load_state_dict(extra["loader"])
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
    for g, ps in gnn.param_tree().items():
        for k, p in ps.items():
            check(_bits_equal(torch, p, saved[g][k]),
                  f"{path}: restored {g}.{k} differs from the saved one")
    before = dict(_build.LAUNCHES)
    hops_before = hops["n"]
    resumed = _train(torch, np, loader, gnn, labels_dev, host_feats,
                     steps - at, f"{path} resumed", gates)
    launches = dict(_build.LAUNCHES)
    resumed_launches = {k: launches[k] - before[k] for k in launches}
    for i, got in enumerate(resumed):
        want = straight[at + i]
        step = at + i
        check(np.array_equal(got["seeds"], want["seeds"])
              and np.array_equal(got["all_nodes"], want["all_nodes"]),
              f"{path} step {step}: resumed blocks differ from the "
              "straight run's")
        check(_bits_equal(torch, got["features"], want["features"]),
              f"{path} step {step}: resumed features differ from the "
              "straight run's")
        check(got["loss"] == want["loss"],
              f"{path} step {step}: resumed loss {got['loss']!r} differs "
              f"from the straight run's {want['loss']!r}")
    emit({"phase": "resume", "path": path, "steps": steps,
          "checkpoint_after_step": at, "save_ms": save_ms,
          "restore_ms": restore_ms, "bytes_written": nbytes,
          "params": sum(p.numel() for ps in saved.values()
                        for p in ps.values()),
          "median_ms": {"straight": _median_ms(straight),
                        "before_checkpoint": _median_ms(before_ckpt),
                        "resumed": _median_ms(resumed)},
          "losses_straight": [r["loss"] for r in straight],
          "losses_resumed": [r["loss"] for r in resumed],
          "launches": launches, "resumed_launches": resumed_launches,
          **({"hops": hops["n"], "resumed_hops": hops["n"] - hops_before}
             if merged else {})})
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {path} path")
    if merged:
        check(launches["frontier_read"] == hops["n"] > 0,
              f"{launches['frontier_read']} frontier_read launches for "
              f"{hops['n']} hops (one per hop expected)")
        for name in ("cache_access", "tiered_gather_unique", "store_fill"):
            check(resumed_launches[name] > 0,
                  f"{path}: {name} was not launched after the restore")
    return launches


def ladies_path(torch, np, work, host_feats, plane) -> dict:
    """LADIES["batches"] feature batches of the LADIES sampler at fig15's
    shape (batch 256, layer sizes 2048, 2048) on one plane: features bit
    for bit, the request count, and cache hits after the first batch."""
    from repro_torch.core import INTEL_OPTANE, GIDSDataLoader, LoaderConfig
    from repro_torch.kernels import _build
    graph, _, feats, _, _ = work
    loader = GIDSDataLoader(
        graph, feats,
        LoaderConfig(batch_size=LADIES["batch"], sampler="ladies",
                     ladies_layer_sizes=LADIES["layer_sizes"],
                     data_plane=plane, cache_lines=FULL["cache_lines"],
                     window_depth=8, cbuf_fraction=0.1),
        ssd=INTEL_OPTANE, device=DEVICE)
    sample_ms = []
    sample_one = loader._sample_one

    def timed_sample_one():
        t = time.perf_counter()
        blocks = sample_one()
        sample_ms.append((time.perf_counter() - t) * 1e3)
        return blocks
    loader._sample_one = timed_sample_one
    requests = LADIES["batch"] + sum(LADIES["layer_sizes"])
    next_ms, hits = [], []
    _build.reset_launches()
    for i in range(LADIES["batches"]):
        t = time.perf_counter()
        batch = loader.next_batch()
        torch.cuda.synchronize()
        next_ms.append((time.perf_counter() - t) * 1e3)
        nodes = torch.from_numpy(batch.blocks.all_nodes).to(DEVICE)
        check(batch.features.device.type == DEVICE
              and torch.equal(batch.features, host_feats[nodes]),
              f"ladies {plane} batch {i}: features differ from "
              "host_features[all_nodes]")
        check(batch.blocks.num_requests == requests,
              f"ladies {plane} batch {i}: {batch.blocks.num_requests} "
              f"requests, {requests} expected")
        hits.append(int(batch.report.n_hbm_hits))
        check(i == 0 or hits[-1] > 0,
              f"ladies {plane} batch {i}: no cache hit after the first")
    launches = dict(_build.LAUNCHES)
    path = f"ladies {plane}"
    emit({"phase": "ladies", "plane": plane, "batch": LADIES["batch"],
          "layer_sizes": list(LADIES["layer_sizes"]),
          "batches": LADIES["batches"], "sampled": len(sample_ms),
          "sample_ms": sample_ms, "next_batch_ms": next_ms,
          "hbm_hits": hits, "launches": launches})
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {path} path")
    return launches


def _edge_keys(np, graph):
    src = np.repeat(np.arange(graph.num_nodes, dtype=np.int64),
                    graph.degrees())
    return np.sort(src * graph.num_nodes + graph.indices.astype(np.int64))


def _check_sampled(np, graph, keys, seeds, hops, what: str) -> None:
    """Every sampled id is an out-neighbour of its destination, or the
    destination itself where its degree is 0 (on the host, against the
    CSR's (src, dst) key set)."""
    deg = graph.degrees()
    frontier = np.asarray(seeds, np.int64)
    for h, (f, hop) in enumerate(zip(SAMPLER["fanouts"], hops)):
        nbr = hop.cpu().numpy().astype(np.int64)
        dst = np.repeat(frontier, f)
        key = dst * graph.num_nodes + nbr
        pos = np.minimum(np.searchsorted(keys, key), len(keys) - 1)
        ok = np.where(deg[dst] > 0, keys[pos] == key, nbr == dst)
        check(bool(ok.all()), f"{what} hop {h}: {int((~ok).sum())} sampled "
                              "ids are neither an out-neighbour of their "
                              "destination nor its self-loop")
        frontier = nbr


def _reference_hops(np, graph, seeds, draws) -> list:
    """The reference device sampler's arithmetic (repro's
    sampling/neighbor.py `device_sample_blocks`) in numpy on the host,
    given each hop's uniform draws."""
    frontier = np.asarray(seeds, np.int64)
    hops = []
    for r in draws:
        start = graph.indptr[frontier]
        deg = graph.indptr[frontier + 1] - start
        offs = np.floor(r * np.maximum(deg, 1).astype(np.float32)[:, None])
        idx = np.minimum(start[:, None] + offs.astype(np.int64),
                         graph.num_edges - 1)
        nbr = np.where(deg[:, None] > 0, graph.indices[idx],
                       frontier[:, None]).reshape(-1)
        hops.append(nbr)
        frontier = nbr
    return hops


def device_sampler(torch, np) -> None:
    """The device sampler against the host sampler on fig7's measured
    graphs (IGB tiny, small and medium as materialised here), batch 512,
    fanouts (10, 5): every device batch held to its properties, and each
    sampler's median time per batch.  Each device batch is also held, id
    for id, against the reference's arithmetic on the host fed the same
    draws (replayed from the generator's state before the call)."""
    from repro_torch.graph import datasets
    from repro_torch.graph.csr import device_index_dtype
    from repro_torch.sampling.neighbor import (device_sample_blocks,
                                               host_sample_blocks,
                                               subgraph_sizes)
    batch, fanouts = SAMPLER["batch"], SAMPLER["fanouts"]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for name in SAMPLER["datasets"]:
        t0 = time.perf_counter()
        graph = getattr(datasets, name).materialize()
        keys = _edge_keys(np, graph)
        rng = np.random.default_rng(0)
        seeds = rng.integers(0, graph.num_nodes, batch)
        csr = graph.to_device(device=DEVICE)
        setup_s = time.perf_counter() - t0
        dt = device_index_dtype(graph.num_nodes, graph.num_edges)
        dseeds = torch.from_numpy(seeds).to(DEVICE)
        dev_ms = []
        for call in range(SAMPLER["device_calls"]):
            gen_state = gen.get_state()
            torch.cuda.synchronize()
            t = time.perf_counter()
            hops, flat = device_sample_blocks(csr, dseeds, fanouts, gen)
            torch.cuda.synchronize()
            dev_ms.append((time.perf_counter() - t) * 1e3)
            what = f"device sampler {name} call {call}"
            n = batch
            for f, hop in zip(fanouts, hops):
                n *= f
                check(tuple(hop.shape) == (n,) and hop.dtype == dt,
                      f"{what}: a hop of shape {tuple(hop.shape)} {hop.dtype}")
            check(tuple(flat.shape) == (subgraph_sizes(batch, fanouts),)
                  and flat.dtype == dt and flat.is_cuda,
                  f"{what}: flat ids of shape {tuple(flat.shape)} "
                  f"{flat.dtype} on {flat.device}")
            check(np.array_equal(flat[:batch].cpu().numpy(), seeds),
                  f"{what}: the flat ids do not start with the seeds")
            _check_sampled(np, graph, keys, seeds, hops, what)
            replay = torch.Generator(device=DEVICE)
            replay.set_state(gen_state)
            n, draws = batch, []
            for f in fanouts:
                draws.append(torch.rand((n, f), generator=replay,
                                        device=DEVICE).cpu().numpy())
                n *= f
            want = _reference_hops(np, graph, seeds, draws)
            for h, (hop, w) in enumerate(zip(hops, want, strict=True)):
                got = hop.cpu().numpy().astype(np.int64)
                check(np.array_equal(got, w),
                      f"{what} hop {h}: {int((got != w).sum())} ids differ "
                      "from the reference's arithmetic on the same draws")
        # the card's busy time for one call, apart from the host's
        # dispatch: the launches queue up behind a device-side sleep
        sleep_ms, busy_ms, enqueue_ms = [], [], []
        for _ in range(SAMPLER["device_calls"]):
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            torch.cuda._sleep(ENQUEUE_SLEEP_CYCLES)
            ev[1].record()
            t = time.perf_counter()
            device_sample_blocks(csr, dseeds, fanouts, gen)
            enqueue_ms.append((time.perf_counter() - t) * 1e3)
            ev[2].record()
            ev[2].synchronize()
            sleep_ms.append(ev[0].elapsed_time(ev[1]))
            busy_ms.append(ev[1].elapsed_time(ev[2]))
        host_ms = []
        for _ in range(SAMPLER["host_calls"]):
            t = time.perf_counter()
            host_sample_blocks(graph, seeds, fanouts, rng)
            host_ms.append((time.perf_counter() - t) * 1e3)
        dev, host = statistics.median(dev_ms), statistics.median(host_ms)
        emit({"phase": "device_sampler", "dataset": name,
              "nodes": graph.num_nodes, "edges": graph.num_edges,
              "index_dtype": str(dt), "setup_s": setup_s,
              "device_ms": dev, "host_ms": host,
              "host_over_device": host / dev,
              "device_busy_ms": statistics.median(busy_ms),
              "device_enqueue_ms": statistics.median(enqueue_ms),
              "sleep_ms": statistics.median(sleep_ms),
              "device_ms_all": dev_ms, "host_ms_all": host_ms})


def resume_and_samplers(torch, np) -> dict:
    """Phase 4c: the two resume paths, LADIES on two planes, and the
    device sampler."""
    t0 = time.perf_counter()
    work = workload(torch, np)
    host_feats = torch.from_numpy(work[2]).to(DEVICE)
    emit({"phase": "setup", "plane": "resume and samplers",
          "seconds": round(time.perf_counter() - t0, 3)})
    by_path = {}
    for path in RESUME:
        by_path[path] = resume_path(torch, np, work, host_feats, path)
        torch.cuda.empty_cache()
    for plane in LADIES["planes"]:
        by_path[f"ladies {plane}"] = ladies_path(torch, np, work,
                                                 host_feats, plane)
    del work, host_feats
    torch.cuda.empty_cache()
    device_sampler(torch, np)
    return by_path


#: phase 4d: the fault-and-adaptive plane (4 shards, adaptive placement,
#: 2-way replication, a fault schedule) and the cluster plane (4 hosts,
#: metis-lite co-partitioned, adaptive topology admission)
FAULT_PLANE = "gids-sharded+faults+adaptive"
CLUSTER_PLANE = "gids-hosts-merged+topology"
#: A: FAULT["steps"] steps in epochs of FAULT["epoch"] batches; epoch e's
#: batches (counted in the order they are sampled) draw their seeds from
#: shard e % 4 of the static degree table, fig_adaptive.rotation's drift.
#: The loader's state is saved after FAULT["resume_at"] steps.
FAULT = dict(steps=24, epoch=6, resume_at=14, n_shards=4, replication=2,
             rebalance_interval=4)
#: B: CLUSTER["steps"] steps, two merged windows of 8; the refresher
#: considers a re-admission after every window
CLUSTER = dict(steps=16, n_hosts=4, rebalance_interval=1)
#: the metis-lite table, built once and registered under this name for
#: the card's loader and its twin
METIS_BUILT = "metis-lite-built"


def fault_schedule():
    """A's schedule, in the style of benchmarks/fig_faults.py: shard 2
    browns out 10x for bursts 2-13, shard 0 is dead for bursts 6-8, shard
    1's reads fail with probability 0.2 for bursts 3-19, and the straggler
    is hedged to a replica."""
    from repro_torch.core import (BrownoutEvent, FaultSchedule,
                                  FlakyReadsEvent, HedgePolicy, OutageEvent)
    return FaultSchedule(
        events=(BrownoutEvent(shard=2, start=2, end=14, multiplier=10.0),
                OutageEvent(shard=0, start=6, end=9),
                FlakyReadsEvent(shard=1, start=3, end=20, fail_prob=0.2)),
        hedge=HedgePolicy(), seed=3)


def _cluster_config(path: str, cfg):
    from repro_torch.core import LoaderConfig
    from repro_torch.core.dataplane import DataPlaneSpec
    common = dict(batch_size=FULL["batch"], fanouts=cfg.fanouts,
                  cache_lines=FULL["cache_lines"], window_depth=8,
                  cbuf_fraction=0.1)
    if path == FAULT_PLANE:
        return LoaderConfig(
            data_plane="gids-sharded", n_shards=FAULT["n_shards"],
            placement="adaptive", replication_factor=FAULT["replication"],
            fault_schedule=fault_schedule(),
            rebalance_interval=FAULT["rebalance_interval"], **common)
    return LoaderConfig(
        data_plane=DataPlaneSpec.preset("gids-hosts-merged", topology=True),
        n_hosts=CLUSTER["n_hosts"], placement=METIS_BUILT,
        co_partition=True, topo_admission="adaptive",
        rebalance_interval=CLUSTER["rebalance_interval"], **common)


def _cluster_loader(graph, feats, cfg, device, hot=None, first=0,
                    tracer=None):
    """A loader of `cfg` on `device`; with `hot`, the sampled-order drift:
    the batch sampled k-th (counting from `first`) draws its seeds from
    hot[(k // FAULT["epoch"]) % len(hot)]."""
    from repro_torch.core import INTEL_OPTANE, GIDSDataLoader
    loader = GIDSDataLoader(graph, feats, cfg, ssd=INTEL_OPTANE,
                            device=device, tracer=tracer)
    if hot is not None:
        sample, count = loader._sample_one, [first]

        def drifted():
            loader.train_ids = hot[(count[0] // FAULT["epoch"]) % len(hot)]
            count[0] += 1
            return sample()
        loader._sample_one = drifted
    return loader


def _priced(batch) -> tuple:
    """What a twin must reproduce of one batch, float for float."""
    r = batch.report
    return (batch.prep_time_s, batch.sample_time_s, batch.exposed_prep_s,
            r.shard_rows, getattr(r, "shard_lines", ()), r.remote_rows,
            getattr(r, "remote_lines", ()))


def _twin_run(np, graph, feats, cfg, steps, hot=None, state=None,
              first=0) -> list:
    """The priced sequence of a features-only twin of the card's loader on
    the CPU: the same configuration and inputs, plain versions for every
    kernel.  With `state`, the twin is restored from it first."""
    loader = _cluster_loader(graph, feats, cfg, "cpu", hot, first)
    if state is not None:
        loader.load_state_dict(state)
    return [_priced(loader.next_batch()) for _ in range(steps)]


def cluster_plane_path(torch, np, work, host_feats, path, hot=None) -> dict:
    """Train one phase-4d plane on the card through `next_batch()`,
    printing each step's split, each burst's telemetry and each controller
    action, then hold its priced sequence against a CPU twin's."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models.gnn import hop_indices, sgd_step
    graph, labels_all, feats, cfg, gnn = work
    merged = path == CLUSTER_PLANE
    steps_n = CLUSTER["steps"] if merged else FAULT["steps"]
    loader_cfg = _cluster_config(path, cfg)
    t0 = time.perf_counter()
    loader = _cluster_loader(graph, feats, loader_cfg, DEVICE, hot)
    build_s = time.perf_counter() - t0
    tier, backstop = loader.store.tiers[0], loader.store.tiers[-1]
    gather_name = "tiered_gather_unique" if merged else "tiered_gather"
    labels_dev = torch.from_numpy(labels_all).to(DEVICE)
    emit({"phase": "setup", "plane": path, "seconds": round(build_s, 3),
          "shards": backstop.n_shards,
          "placement": getattr(backstop.placement, "name", None),
          **({"cut_edge_fraction": backstop.cut_edge_fraction(),
              "placement_remote_fraction": backstop.remote_fraction(),
              "edge_pages": loader.topo.n_pages,
              "pages_by_tier": list(loader.topo.tier_pages())}
             if merged else {})})

    # every probe's split, the host time of pricing and feedback, and (on
    # B) every hop's words held against graph.indices
    probes, pricing = [], []
    probe_rows = tier._probe_rows

    def recorded_probe(*args):
        hits = probe_rows(*args)
        probes.append({"split": dict(tier.last_split_ms),
                       "counts": dict(tier.last_counts)})
        return hits

    def timed(fn):
        def wrapped(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            pricing.append(time.perf_counter() - t)
            return out
        return wrapped

    patches = [mock.patch.object(tier, "_probe_rows", recorded_probe),
               mock.patch.object(loader, "_feedback_step",
                                 timed(loader._feedback_step))]
    if merged:
        patches.append(mock.patch.object(
            loader.timeline, "price_merged_burst",
            timed(loader.timeline.price_merged_burst)))
    else:
        patches.append(mock.patch.object(loader.plane, "price",
                                         timed(loader.plane.price)))
    hops = {"n": 0, "gate_s": 0.0, "after_refresh": 0}
    if merged:
        _checked_words(np, loader, graph, hops)
        read = loader.topo.frontier_gather

        def counted(pos):
            hops["after_refresh"] += loader.topo_refresher.n_refreshes > 0
            return read(pos)
        loader.topo.frontier_gather = counted

    plain0 = []
    gather = getattr(ops, gather_name)
    plain = getattr(ref, gather_name + "_ref")

    def gather_and_plain(*args):
        out = gather(*args)
        if not plain0:
            plain0.append(plain(*args))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, priced, state, straight_nodes = [], [], None, []
    n_migrations = n_refreshes = 0
    for p in patches:
        p.start()
    try:
        _build.reset_launches()
        for step in range(steps_n):
            n_probes, n_priced = len(probes), len(pricing)
            gate_s = hops["gate_s"]
            t_start = time.perf_counter()
            if step == 0:
                with mock.patch.object(ops, gather_name, gather_and_plain):
                    batch = loader.next_batch()
            else:
                batch = loader.next_batch()
            t_batch = time.perf_counter()
            gate_s = hops["gate_s"] - gate_s
            nodes = torch.from_numpy(batch.blocks.all_nodes).to(DEVICE)
            hi = [torch.from_numpy(i).to(DEVICE)
                  for i in hop_indices(batch.blocks)]
            y = labels_dev[torch.from_numpy(batch.blocks.seeds).to(DEVICE)]
            if step == 0:
                saved = dict(_build.LAUNCHES)
                check(len(plain0) == 1
                      and torch.equal(plain0[0], batch.features),
                      f"{path} step 0: {gather_name} differs from its plain "
                      "version on the path")
                with torch.no_grad():
                    loss_kernel = gnn.loss(batch.features, hi, y).item()
                    with mock.patch.object(ops, "segment_mean",
                                           ref.segment_mean_ref):
                        loss_plain = gnn.loss(plain0[0], hi, y).item()
                _build.LAUNCHES.update(saved)
                plain0.clear()
                rel = abs(loss_kernel - loss_plain) / abs(loss_plain)
                emit({"phase": "step0_parity", "plane": path,
                      "loss_kernel": loss_kernel, "loss_plain": loss_plain,
                      "rel_err": rel})
                check(rel <= 1e-5, f"{path} step-0 loss {loss_kernel} vs "
                                   f"plain {loss_plain}")
            torch.cuda.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            loss = sgd_step(gnn, batch.features, hi, y, 0.05)
            ev1.record()
            loss_v = loss.item()                  # synchronises the step
            t_end = time.perf_counter()
            check(batch.features.device.type == DEVICE
                  and torch.equal(batch.features, host_feats[nodes]),
                  f"{path} step {step}: features differ from "
                  "host_features[all_nodes]")
            check(np.isfinite(loss_v), f"{path} step {step}: loss {loss_v}")
            check(batch.exposed_prep_s <= batch.prep_time_s,
                  f"{path} step {step}: exposed prep {batch.exposed_prep_s}"
                  f" above prep {batch.prep_time_s}")
            priced.append(_priced(batch))
            straight_nodes.append(batch.blocks.all_nodes)
            made = probes[n_probes:]
            split = {f"{k}_ms": sum(p["split"].get(k, 0.0) for p in made)
                     for k in ("probe", "stage_host", "h2d", "gather",
                               "fill")}
            steps.append({"phase": "step", "plane": path, "step": step,
                          "loss": loss_v,
                          "batch_rows": int(batch.report.n_requests),
                          "next_batch_ms": (t_batch - t_start - gate_s) * 1e3,
                          "probes": len(made), **split,
                          "pricing_ms": sum(pricing[n_priced:]) * 1e3,
                          "train_ms": ev0.elapsed_time(ev1),
                          "wall_ms": (t_end - t_start - gate_s) * 1e3,
                          "prep_time_s": batch.prep_time_s,
                          "sample_time_s": batch.sample_time_s,
                          "exposed_prep_s": batch.exposed_prep_s})
            emit(steps[-1])
            if len(made):                   # a burst was priced this step
                burst = loader.timeline.shard_burst
                emit({"phase": "burst", "plane": path, "step": step,
                      "prep_time_s": batch.prep_time_s,
                      "exposed_prep_s": batch.exposed_prep_s,
                      "straggler": burst.straggler,
                      "imbalance": burst.imbalance,
                      "per_shard_s": list(burst.per_shard_s),
                      "shard_rows": list(burst.per_shard_rows),
                      **({"remote_fraction": burst.remote_fraction}
                         if merged else
                         {"faulted": getattr(burst, "burst_index", -1) >= 0,
                          "hedged_shard": getattr(burst, "hedged_shard",
                                                  -1)})})
            reb, refr = loader.rebalancer, loader.topo_refresher
            for e in (reb.events[n_migrations:] if reb else ()):
                emit({"phase": "migration", "plane": path, "step": step,
                      **dataclasses.asdict(e)})
            for e in (refr.events[n_refreshes:] if refr else ()):
                emit({"phase": "topo_refresh", "plane": path, "step": step,
                      **dataclasses.asdict(e)})
                topo = loader.topo
                check(torch.equal(topo.page_table.cpu(),
                                  torch.from_numpy(topo.page_slot)),
                      f"{path}: the device page table misses the refresh")
                hbm = np.nonzero(topo.assignment == 0)[0]
                check(torch.equal(topo.hot_pages().cpu(), torch.from_numpy(
                    topo._page_rows(hbm))),
                      f"{path}: the hot pages miss the refresh")
            n_migrations = reb.n_migrations if reb else 0
            n_refreshes = refr.n_refreshes if refr else 0
            if not merged and step + 1 == FAULT["resume_at"]:
                state = loader.state_dict()
        launches = dict(_build.LAUNCHES)
    finally:
        for p in reversed(patches):
            p.stop()
    probe_steps = [s for s in steps[1:] if s["probes"]]
    median = {k: statistics.median(s[k] for s in probe_steps)
              for k in ("next_batch_ms", "probe_ms", "stage_host_ms",
                        "h2d_ms", "gather_ms", "fill_ms", "pricing_ms")}
    median.update({k: statistics.median(s[k] for s in steps[1:])
                   for k in ("train_ms", "wall_ms", "prep_time_s",
                             "exposed_prep_s")})
    summary = {"phase": "main_path", "plane": path, "steps": steps_n,
               "launches": launches, "probes": len(probes),
               "median_of_steps_1_on": median,
               "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    inj = loader.fault_injector
    if merged:
        summary.update(hops=hops["n"], hops_after_refresh=hops[
            "after_refresh"], refreshes=n_refreshes,
            refresh_cost_s=sum(e.cost_s for e in loader.topo_refresher.events))
    else:
        summary.update(
            migrations=n_migrations,
            migration_cost_s=loader.rebalancer.total_migration_cost_s,
            **_fault_counters(loader))
    emit(summary)
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {path} path")
    check(launches[gather_name] == steps_n
          and len(probes) == (2 if merged else steps_n),
          f"{launches[gather_name]} {gather_name} launches and "
          f"{len(probes)} probes for {steps_n} steps (one launch a batch, "
          "one probe a batch or a window expected)")
    check(launches["segment_mean"] == 2 * steps_n,
          f"{launches['segment_mean']} segment_mean launches for "
          f"{steps_n} steps (two a step expected)")
    if merged:
        check(launches["frontier_read"] == hops["n"] > 0,
              f"{launches['frontier_read']} frontier_read launches for "
              f"{hops['n']} hops (one per hop expected)")
        check(n_refreshes >= 1, f"{path}: no topology refresh committed")
        check(hops["after_refresh"] > 0,
              f"{path}: no hop read the refreshed placement")
    else:
        check(n_migrations >= 1, f"{path}: no migration committed")
        check(inj.n_faulted_bursts >= 1, f"{path}: no faulted burst")
        check(backstop.router.n_rerouted >= 1, f"{path}: no rerouted read")

    # the CPU twin's priced sequence, float for float
    t0 = time.perf_counter()
    twin = _twin_run(np, graph, feats, loader_cfg, steps_n, hot)
    twin_s = time.perf_counter() - t0
    for step, (got, want) in enumerate(zip(priced, twin, strict=True)):
        check(got == want, f"{path} step {step}: priced {got} differs from "
                           f"the CPU twin's {want}")
    emit({"phase": "twin", "plane": path, "steps": steps_n,
          "seconds": twin_s, "priced_equal": True})
    del loader
    torch.cuda.empty_cache()
    if state is not None:
        resume_cluster(torch, np, work, host_feats, path, loader_cfg, hot,
                       state, straight_nodes, priced, summary)
    return launches


def _fault_counters(loader) -> dict:
    """The fault plane's counters: the injector's and the router's."""
    inj, router = loader.fault_injector, loader.store.tiers[-1].router
    return dict(faulted_bursts=inj.n_faulted_bursts,
                hedged_bursts=inj.n_hedged_bursts,
                hedged_lines=inj.n_hedged_lines,
                hedge_saving_s=inj.hedge_saving_s,
                retried_lines=inj.n_retried_lines,
                failed_over_lines=inj.n_failed_over_lines,
                rerouted_reads=router.n_rerouted,
                first_reroute_burst=router.first_reroute_burst)


def _same_state(np, a, b) -> bool:
    """Two loader states equal, numpy values by type, dtype and value."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_state(np, a[k], b[k])
                                            for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same_state(np, x, y)
                                        for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def resume_cluster(torch, np, work, host_feats, path, loader_cfg, hot,
                   state, straight_nodes, priced, straight) -> None:
    """The state saved after FAULT["resume_at"] steps goes through
    `train.checkpoint` and back; a fresh card loader and a fresh CPU twin
    restored from it deliver the remaining batches: nodes and features
    equal to the straight run's, each batch through `tiered_gather` and
    `store_fill` again, and priced prep equal to each other's.  (A restore
    rebuilds the caches cold and resets the accumulator's telemetry, as
    the reference does, so resumed prices are those of any loader restored
    from the state, not the straight run's.)"""
    import tempfile

    from repro_torch.kernels import _build
    from repro_torch.train import checkpoint as ckpt
    graph, _, feats, _, _ = work
    at = FAULT["resume_at"]
    check("tier_state" in state and "fault_state" in state,
          f"{path}: the saved state lacks tier_state or fault_state "
          f"({sorted(state)})")
    check(set(state["fault_state"]) == {"injector", "monitor"},
          f"{path}: fault_state holds {sorted(state['fault_state'])}")
    marker = {"w": torch.zeros(1)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ckpt.save(tmp, at, marker, {"loader": state})
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _, extra = ckpt.restore(tmp, at, marker)
        loader = _cluster_loader(graph, feats, loader_cfg, DEVICE, hot, at)
        loader.load_state_dict(extra["loader"])
        restore_ms = (time.perf_counter() - t0) * 1e3
    check(_same_state(np, extra["loader"], state),
          f"{path}: the state restored from the checkpoint differs from "
          "the saved one")
    resumed = []
    _build.reset_launches()
    for step in range(at, FAULT["steps"]):
        batch = loader.next_batch()
        nodes = batch.blocks.all_nodes
        check(np.array_equal(nodes, straight_nodes[step]),
              f"{path} resumed step {step}: nodes differ from the straight "
              "run's")
        check(torch.equal(batch.features, host_feats[torch.from_numpy(
            nodes).to(DEVICE)]),
              f"{path} resumed step {step}: features differ from the "
              "straight run's")
        resumed.append(_priced(batch))
    launches = dict(_build.LAUNCHES)
    n = FAULT["steps"] - at
    check(launches["tiered_gather"] == launches["store_fill"] == n,
          f"{path} resumed: {launches['tiered_gather']} tiered_gather and "
          f"{launches['store_fill']} store_fill launches for {n} batches "
          "(one each a batch expected)")
    twin = _twin_run(np, graph, feats, loader_cfg, n, hot, extra["loader"],
                     at)
    for i, (got, want) in enumerate(zip(resumed, twin, strict=True)):
        check(got == want, f"{path} resumed step {at + i}: priced {got} "
                           f"differs from the restored twin's {want}")
    emit({"phase": "resume", "plane": path, "saved_after_step": at,
          "save_ms": save_ms, "restore_ms": restore_ms,
          "state_keys": sorted(state), "fault_state": sorted(
              state["fault_state"]),
          "launches": launches,
          "resumed_prep_s": [r[0] for r in resumed],
          "straight_prep_s": [r[0] for r in priced[at:]],
          "resumed_fault_counters": _fault_counters(loader),
          "straight_fault_counters": {k: straight[k] for k in
                                      _fault_counters(loader)}})


def cluster_planes(torch, np) -> dict:
    """Phase 4d: the fault-and-adaptive plane, then the cluster plane."""
    import copy

    from repro_torch.core import make_placement, register_placement
    t0 = time.perf_counter()
    work = workload(torch, np)
    graph = work[0]
    host_feats = torch.from_numpy(work[2]).to(DEVICE)
    t1 = time.perf_counter()
    metis = make_placement("metis-lite", CLUSTER["n_hosts"], graph=graph,
                           num_nodes=graph.num_nodes)
    metis_s = time.perf_counter() - t1

    @register_placement(METIS_BUILT)
    def _metis_built(n_shards, **_ctx):
        check(n_shards == metis.n_shards,
              f"{METIS_BUILT}: built for {metis.n_shards} hosts, asked for "
              f"{n_shards}")
        return copy.deepcopy(metis)

    from repro_torch.core import cut_edge_fraction
    emit({"phase": "setup", "plane": "cluster planes",
          "seconds": round(time.perf_counter() - t0, 3),
          "metis_lite_build_s": metis_s,
          "metis_lite_cut_edge_fraction": cut_edge_fraction(
              graph.indptr, graph.indices, metis.table),
          "metis_lite_part_sizes": np.bincount(
              metis.table, minlength=CLUSTER["n_hosts"]).tolist()})
    table = make_placement("degree", FAULT["n_shards"],
                           degrees=graph.degrees()).table
    hot = [np.nonzero(table == s)[0] for s in range(FAULT["n_shards"])]
    by_path = {FAULT_PLANE: cluster_plane_path(torch, np, work, host_feats,
                                               FAULT_PLANE, hot)}
    torch.cuda.empty_cache()
    by_path[CLUSTER_PLANE] = cluster_plane_path(torch, np, work, host_feats,
                                                CLUSTER_PLANE)
    emit({"phase": "cluster planes", "seconds": time.perf_counter() - t0})
    return by_path

# -- phase 4e ------------------------------------------------------------------

TRACED_MERGED = "traced " + MERGED_PLANE
TRACED_FAULT = "traced " + FAULT_PLANE
#: the traced twins' depth, in batches through each plane's loader
TRACED = {TRACED_MERGED: 16, TRACED_FAULT: 8}
SERVE_S1, SERVE_S2 = "serve-gnn merged", "serve-gnn per-request"
SERVE_S3, SERVE_S4 = "serve-gnn brownout", "serve-gnn-shared merged"
#: the serving runs, after benchmarks/fig_serve_load.py (the stream, its
#: deadline and tenant mixes) and fig_faults.py (the brownout scenario)
GNN_SERVE = dict(requests=400, qps=8000, stream_seed=11, deadline_s=3e-3,
                 cache_lines=1 << 14, quotas=(3.0, 1.0), per_request=100,
                 shared=100, logits=16, fault_requests=300, fault_qps=500,
                 fault_stream_seed=3, fault_cache_lines=256)
RECONCILE_EPS = 1e-9


def _sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _series_medians(snapshot: dict) -> dict:
    """The median modelled, measured and gap seconds of every
    `modelled_vs_measured.<stage>` series of a metrics snapshot."""
    out = {}
    for name, s in snapshot.items():
        if name.startswith("modelled_vs_measured.") and s["points"]:
            out[name.split(".", 1)[1]] = {
                k: statistics.median(p[k] for p in s["points"])
                for k in ("modelled_s", "measured_s", "gap_s")} \
                | {"n": s["n"]}
    return out


def _written_trace(tracer) -> dict:
    """Write the trace with `Tracer.write` into a temporary directory,
    read it back and validate it; its size, events and problems."""
    import tempfile
    from repro_torch.obs import validate_trace
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        events = tracer.write(str(path))
        doc = json.loads(path.read_text())
        size = path.stat().st_size
    problems = validate_trace(doc) + validate_trace(tracer)
    return {"events": len(events), "bytes": size, "problems": problems[:5],
            "n_problems": len(problems)}


def _traced_loader(work, path, tracer, hot):
    graph, _, feats, cfg, _ = work
    if path == TRACED_MERGED:
        return _host_loader(None, graph, feats, cfg,
                            _plane_spec(MERGED_PLANE), tracer=tracer)
    return _cluster_loader(graph, feats, _cluster_config(FAULT_PLANE, cfg),
                           DEVICE, hot, tracer=tracer)


def traced_twin(torch, np, work, host_feats, path, hot) -> dict:
    """An earlier path's loader run twice on the card from the same seed,
    untraced and with a Tracer: prep floats, blocks and features bit-equal,
    every batch span its prep time within RECONCILE_EPS, the written trace
    valid; on plane A the fault-recovery spans and controller counters."""
    from repro_torch.kernels import _build
    from repro_torch.obs import Tracer
    n = TRACED[path]
    plain = _traced_loader(work, path, None, hot)
    untraced = [plain.next_batch() for _ in range(n)]
    del plain
    tracer = Tracer()
    loader = _traced_loader(work, path, tracer, hot)
    _sync(torch)
    _build.reset_launches()
    t0 = time.perf_counter()
    traced = [loader.next_batch() for _ in range(n)]
    _sync(torch)
    wall_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for i, (a, b) in enumerate(zip(untraced, traced)):
        check(_priced(a) == _priced(b),
              f"{path} batch {i}: priced floats differ from the untraced "
              "run's")
        check(np.array_equal(a.blocks.all_nodes, b.blocks.all_nodes),
              f"{path} batch {i}: blocks differ from the untraced run's")
        nodes = torch.from_numpy(b.blocks.all_nodes).to(DEVICE)
        check(torch.equal(a.features, b.features)
              and torch.equal(b.features, host_feats[nodes]),
              f"{path} batch {i}: features differ")
    roots = [r for r in tracer.roots() if r.name == "batch"][:n]
    check(len(roots) == n, f"{path}: {len(roots)} batch spans for {n}")
    err = max(max(abs(r.dur - b.prep_time_s) for r, b in zip(roots, traced)),
              tracer.max_reconcile_error())
    check(err <= RECONCILE_EPS, f"{path}: a batch span is {err} s off its "
                                "prep time")
    written = _written_trace(tracer)
    check(written["n_problems"] == 0,
          f"{path}: the written trace is invalid: {written['problems']}")
    snap = tracer.metrics.snapshot()
    fault_spans = sum(sp.name.startswith("fault/")
                      for r in tracer.roots() for sp in r.walk())
    controller = {k: v["value"] for k, v in snap.items()
                  if k.startswith("controller.")}
    if path == TRACED_FAULT:
        check(fault_spans > 0, f"{path}: no fault-recovery span")
        check(controller, f"{path}: no controller.* counter")
    hops = snap.get("topo.hops", {}).get("value", 0)
    if path == TRACED_MERGED:
        check(launches["frontier_read"] == hops > 0,
              f"{path}: {launches['frontier_read']} frontier_read launches "
              f"for {hops} hops (one per hop expected)")
    emit({"phase": "traced", "plane": path, "batches": n,
          "wall_ms_per_batch": wall_s / n * 1e3, "launches": launches,
          "max_reconcile_error": err, "trace_events": written["events"],
          "trace_bytes": written["bytes"], "fault_spans": fault_spans,
          "controller": controller, "hops": hops,
          "instants": [i.name for i in tracer.instants()],
          "modelled_vs_measured": _series_medians(snap)})
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0, f"kernel {name} was not launched on {path}")
    return launches


def _sweep_tenants():
    """benchmarks/fig_serve_load.py's two tenant mixes: steady Poisson and
    bursty MMPP."""
    from repro_torch.serve import TenantSpec
    d = GNN_SERVE["deadline_s"]
    return (TenantSpec("steady", rate_share=1.0, hot_fraction=0.03,
                       hot_prob=0.9, mean_seeds=4, deadline_s=d,
                       arrival="poisson"),
            TenantSpec("bursty", rate_share=1.0, hot_fraction=0.5,
                       hot_prob=0.2, mean_seeds=8, deadline_s=d,
                       arrival="mmpp", burst_factor=8.0, burst_fraction=0.1,
                       burst_cycle_s=0.02))


def _clone_stream(requests):
    return [type(r)(r.rid, r.tenant, r.arrival_s, r.seeds.copy(),
                    r.deadline_s) for r in requests]


def _serve_record(rec) -> tuple:
    """What a CPU twin must reproduce of one record, float for float."""
    return (rec.rid, rec.rejected, rec.shed_reason, rec.start_s,
            rec.completion_s, rec.sample_s, rec.gather_s, rec.forward_s,
            rec.stale, rec.degraded_level)


def _serve_summary(res) -> tuple:
    return (res.p50_s(), res.p99_s(), res.goodput_qps(), res.attainment(),
            res.tenant_hit_ratios, res.quota_trace)


def _serve_configs():
    from repro_torch.core import BrownoutEvent, FaultSchedule
    tenant = dict(data_plane="serve-gnn", tenants=2,
                  tenant_quotas=GNN_SERVE["quotas"], adaptive_quotas=True,
                  cache_lines=GNN_SERVE["cache_lines"], seed=3)
    return {
        SERVE_S1: dict(merged=True, **tenant),
        SERVE_S2: dict(merged=False, **tenant),
        SERVE_S3: dict(seed=5, cache_lines=GNN_SERVE["fault_cache_lines"],
                       brownout=True, fault_schedule=FaultSchedule(events=(
                           BrownoutEvent(shard=0, start=3, end=10_000,
                                         multiplier=10.0),))),
        SERVE_S4: dict(merged=True, data_plane="serve-gnn-shared",
                       tenants=2, cache_lines=GNN_SERVE["cache_lines"],
                       seed=3),
    }


def _serve_engine(work, device, over, **kw):
    from repro_torch.core import INTEL_OPTANE
    from repro_torch.serve import GNNServeConfig, GNNServeEngine
    graph, _, feats, cfg, _ = work
    return GNNServeEngine(graph, feats,
                          GNNServeConfig(fanouts=tuple(cfg.fanouts), **over),
                          ssd=INTEL_OPTANE, device=device, **kw)


SPLIT_KEYS = ("sample", "probe", "stage_host", "h2d", "gather", "fill",
              "forward")


def serve_run(torch, np, work, host_feats, path, stream, traced=False,
              per_window=False, model=True):
    """Serve `stream` on the card with the port's GNN, after its CPU twin:
    every record's priced floats, the result's percentiles, goodput,
    attainment, hit ratios and quota trace equal the twin's; every kept
    row is its node's feature row, and with `model` every request's logits
    (the port's GraphSAGE on the card) are finite; the row store is coherent after the run
    (and right after each repartition); frontier_read is launched once a
    sampled hop."""
    from repro_torch.kernels import _build
    from repro_torch.obs import Tracer
    over = _serve_configs()[path]
    t0 = time.perf_counter()
    want = _serve_engine(work, "cpu", over).run(_clone_stream(stream))
    twin_s = time.perf_counter() - t0
    tracer = Tracer() if traced else None
    engine = _serve_engine(work, DEVICE, dict(over, keep_features=True),
                           model=work[4] if model else None,
                           tracer=tracer)
    tier = engine.store.tiers[0]

    # host time per stage, summed between window ends; every sampled hop
    acc = dict.fromkeys(SPLIT_KEYS, 0.0)
    windows, hops, state = [], [0], {"repartitions": 0, "recheck": False}
    sample, run_model, execute = (engine._sample, engine._run_model,
                                  engine._execute)
    probe_rows, hop_report = tier._probe_rows, engine.topo.hop_report

    def timed_sample(req):
        t = time.perf_counter()
        out = sample(req)
        acc["sample"] += (time.perf_counter() - t) * 1e3
        return out

    def counted_hop_report(read_pos, **kw):
        hops[0] += 1
        return hop_report(read_pos, **kw)

    def split_probe(*a, **k):
        out = probe_rows(*a, **k)
        for key, ms in tier.last_split_ms.items():
            acc[key] += ms
        if state["recheck"]:
            _check_row_store(torch, tier, host_feats,
                             f"{path}: the probe after a repartition")
            state["recheck"] = False
        return out

    def timed_model(blocks, rows):
        _sync(torch)
        t = time.perf_counter()
        out = run_model(blocks, rows)
        _sync(torch)
        acc["forward"] += (time.perf_counter() - t) * 1e3
        return out

    def timed_execute(decision, records, wins):
        t = time.perf_counter()
        busy = execute(decision, records, wins)
        w = wins[-1]
        windows.append({"window": len(wins) - 1, "requests": w.n_requests,
                        "wall_ms": (time.perf_counter() - t) * 1e3,
                        **{f"{k}_ms": acc[k] for k in SPLIT_KEYS}})
        for k in SPLIT_KEYS:
            acc[k] = 0.0
        return busy

    engine._sample, engine._run_model = timed_sample, timed_model
    engine._execute = timed_execute
    engine.topo.hop_report = counted_hop_report
    tier._probe_rows = split_probe
    if hasattr(tier, "repartition"):
        repartition = tier.repartition

        def checked_repartition(quotas):
            repartition(quotas)
            state["repartitions"] += 1
            check(tier.rows.shape[0] == tier.total_lines
                  and not bool(tier.rows.any()),
                  f"{path}: the row store was not laid out and zeroed for "
                  "the new budgets")
            state["recheck"] = True
        tier.repartition = checked_repartition
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(torch)
    _build.reset_launches()
    t0 = time.perf_counter()
    got = engine.run(_clone_stream(stream))
    _sync(torch)
    wall_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    check(len(got.records) == len(want.records)
          and all(_serve_record(a) == _serve_record(b)
                  for a, b in zip(want.records, got.records)),
          f"{path}: a record's priced floats differ from the CPU twin's")
    check(_serve_summary(got) == _serve_summary(want),
          f"{path}: p50, p99, goodput, attainment, hit ratios or quota "
          "trace differ from the CPU twin's")
    served = got.served
    check(served, f"{path}: nothing was served")
    for rec in served:
        nodes = torch.from_numpy(rec.all_nodes).to(DEVICE)
        check(rec.features.device.type == DEVICE
              and torch.equal(rec.features, host_feats[nodes]),
              f"{path}: request {rec.rid}'s rows differ from "
              f"features[all_nodes] (stale={rec.stale})")
        check(not model or bool(torch.isfinite(rec.logits).all()),
              f"{path}: request {rec.rid}'s logits are not finite")
    _check_row_store(torch, tier, host_feats, f"{path}: after the run")
    check(launches["frontier_read"] == hops[0] > 0,
          f"{path}: {launches['frontier_read']} frontier_read launches for "
          f"{hops[0]} sampled hops (one per hop expected)")
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0, f"kernel {name} was not launched on {path}")
    if per_window:
        for w in windows:
            emit({"phase": "serve_window", "plane": path, **w})
    out = {"phase": "serve", "plane": path, "requests": len(stream),
           "served": len(served), "shed": got.n_rejected,
           "stale": got.n_stale_served, "degraded": got.n_degraded,
           "windows": len(got.windows), "mean_window": got.mean_window,
           "repartitions": len(got.quota_trace),
           "hit_ratios": got.tenant_hit_ratios,
           "wall_s": wall_s, "twin_wall_s": twin_s,
           "served_per_wall_s": len(served) / wall_s,
           "window_median_ms": {
               k: statistics.median(w[k] for w in windows)
               for k in ("wall_ms", *(f"{s}_ms" for s in SPLIT_KEYS))},
           "hops": hops[0], "launches": launches,
           "model_time_p99_s": got.p99_s(),
           "model_time_p50_s": got.p50_s(),
           "model_time_goodput_qps": got.goodput_qps(),
           "attainment": got.attainment()}
    if DEVICE == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return got, engine, tracer, out, launches


def _logits_gate(torch, engine, res, n: int) -> float:
    """The first `n` served requests' logits against the same forward with
    `segment_mean_ref` in place of the kernel: the largest error relative
    to the reference logits' largest magnitude."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.gnn import hop_indices
    worst = 0.0
    fanouts = tuple(engine.config.fanouts)
    for rec in res.served[:n]:
        blocks = engine._sample_cache[(rec.rid, fanouts)][0]
        hi = [torch.from_numpy(h).to(DEVICE) for h in hop_indices(blocks)]
        with torch.no_grad(), mock.patch.object(ops, "segment_mean",
                                                ref.segment_mean_ref):
            plain = engine.model.forward(rec.features, hi)
        rel = float((rec.logits - plain).abs().max() / plain.abs().max())
        worst = max(worst, rel)
    return worst


def gnn_serve(torch, np, work, host_feats) -> dict:
    """S1-S4: the GNN serve engine at full width on the card, each beside
    its CPU twin."""
    from repro_torch.kernels import _build
    from repro_torch.serve import TenantSpec, generate_stream
    graph = work[0]
    stream = generate_stream(graph.num_nodes, _sweep_tenants(),
                             GNN_SERVE["qps"], GNN_SERVE["requests"],
                             seed=GNN_SERVE["stream_seed"])
    by_path = {}
    # S1, traced, then again untraced
    res, engine, tracer, out, by_path[SERVE_S1] = serve_run(
        torch, np, work, host_feats, SERVE_S1, stream, traced=True,
        per_window=True)
    check(len(res.quota_trace) >= 1, f"{SERVE_S1}: no repartition")
    saved = dict(_build.LAUNCHES)
    out["logits_max_rel_err"] = _logits_gate(torch, engine, res,
                                             GNN_SERVE["logits"])
    _build.LAUNCHES.update(saved)
    check(out["logits_max_rel_err"] <= 1e-5,
          f"{SERVE_S1}: logits {out['logits_max_rel_err']} off the plain "
          "forward's")
    req_spans = {sp.args["rid"]: sp for sp in tracer.roots()
                 if sp.name == "request"}
    check(len(req_spans) == len(res.served),
          f"{SERVE_S1}: {len(req_spans)} request spans")
    err = max(max(abs(req_spans[r.rid].dur - r.latency_s),
                  req_spans[r.rid].reconcile_error()) for r in res.served)
    check(err <= RECONCILE_EPS, f"{SERVE_S1}: a request span is {err} s off "
                                "its latency")
    written = _written_trace(tracer)
    check(written["n_problems"] == 0,
          f"{SERVE_S1}: the written trace is invalid: {written['problems']}")
    out.update(trace_events=written["events"], trace_bytes=written["bytes"],
               max_reconcile_error=err,
               modelled_vs_measured=_series_medians(
                   tracer.metrics.snapshot()))
    emit(out)
    del engine, tracer
    untraced, engine, _, out, _ = serve_run(torch, np, work, host_feats,
                                            SERVE_S1, stream)
    check([_serve_record(r) for r in untraced.records]
          == [_serve_record(r) for r in res.records],
          f"{SERVE_S1}: the untraced run's records differ from the traced "
          "run's")
    emit(out | {"plane": SERVE_S1 + " untraced"})
    del engine, untraced, res
    # S2: per-request over the stream's first requests; S4: the shared cache
    for path, n in ((SERVE_S2, GNN_SERVE["per_request"]),
                    (SERVE_S4, GNN_SERVE["shared"])):
        _, _, _, out, by_path[path] = serve_run(torch, np, work, host_feats,
                                                path, stream[:n])
        emit(out)
    # S3: fig_faults' serve scenario at this graph's size, without the
    # model: the GNN is built for the configured fanouts, and the brownout
    # ladder's first step samples smaller ones
    faults = generate_stream(
        graph.num_nodes, [TenantSpec(name="t0", deadline_s=3e-3,
                                     mean_seeds=8)],
        GNN_SERVE["fault_qps"], GNN_SERVE["fault_requests"],
        seed=GNN_SERVE["fault_stream_seed"])
    res, engine, _, out, by_path[SERVE_S3] = serve_run(
        torch, np, work, host_feats, SERVE_S3, faults, model=False)
    out["ladder"] = engine.brownout.level_trace
    emit(out)
    check(res.n_stale_served > 0 and res.n_shed_brownout > 0,
          f"{SERVE_S3}: {res.n_stale_served} served stale and "
          f"{res.n_shed_brownout} shed (at least one of each expected)")
    return by_path


def observe_and_serve(torch, np) -> dict:
    """Phase 4e: traced twins of phases 4 and 4d, then GNN serving."""
    from repro_torch.core import make_placement
    t0 = time.perf_counter()
    work = workload(torch, np)
    graph = work[0]
    host_feats = torch.from_numpy(work[2]).to(DEVICE)
    table = make_placement("degree", FAULT["n_shards"],
                           degrees=graph.degrees()).table
    hot = [np.nonzero(table == s)[0] for s in range(FAULT["n_shards"])]
    by_path = {}
    for path in (TRACED_MERGED, TRACED_FAULT):
        by_path[path] = traced_twin(torch, np, work, host_feats, path, hot)
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    t1 = time.perf_counter()
    by_path.update(gnn_serve(torch, np, work, host_feats))
    emit({"phase": "observe and serve", "seconds": time.perf_counter() - t0,
          "traced_s": t1 - t0, "serve_s": time.perf_counter() - t1})
    return by_path


LM_PATH = "lm-serve"


def _greedy(torch, model, params, prompt, n, max_seq):
    """n tokens of single-request greedy decoding through `model`."""
    cache = model.init_cache(1, max_seq)
    tokens = torch.from_numpy(prompt[None, :]).to(DEVICE)
    logits, cache = model.prefill(params, {"tokens": tokens}, cache)
    toks = [int(logits[0, -1].argmax())]
    for pos in range(len(prompt), len(prompt) + n - 1):
        logits, cache = model.decode_step(
            params, torch.tensor([[toks[-1]]], dtype=torch.int32,
                                 device=DEVICE), cache,
            torch.tensor([pos], dtype=torch.int32, device=DEVICE))
        toks.append(int(logits[0, -1].argmax()))
    return toks


def _lm_config(torch, arch: str, f32: bool = False, layers=None):
    """`arch`'s full published config on the flash path, `layers` to cut
    the depth (the MoE models).  With `f32`, a gate's: f32 dtypes and, for
    MoE, a capacity factor of E / k, so that the capacity
    C = k N / E * E / k = N holds every token even if all pick one expert:
    routing is lossless, as tests/test_decode_consistency.py:19-21 makes
    it (exact for the power-of-two expert counts), and the engine's
    batches route as single requests do.  Served in bf16, the MoE models
    keep their published capacity factor."""
    import dataclasses
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get(arch), attn_impl="flash")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                                  compute_dtype=torch.float32)
    if f32 and cfg.moe_experts:
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    return cfg


def lm_gate_f32(torch, np, arch="qwen2_1_5b", layers=None, gate=GATE,
                engine_prompts=(7, 11, 5)):
    """Phases 5 and 5b, f32 gates at full width: flash against einsum
    logits, and engine tokens against single-request greedy decoding.
    GATE["tol"] is the reference's own bound for decode against teacher
    forcing (tests/test_decode_consistency.py:47); in f32 the two paths
    differ only in summation order (online softmax, other matmul shapes,
    the recurrences' scans)."""
    import dataclasses
    from repro_torch.models.transformer import LM
    from repro_torch.serve import EngineConfig, Request, ServeEngine
    flash_cfg = _lm_config(torch, arch, f32=True, layers=layers)
    flash = LM(flash_cfg, device=DEVICE)
    einsum = LM(dataclasses.replace(flash_cfg, attn_impl="einsum"),
                device=DEVICE)
    t0 = time.perf_counter()
    params = flash.init(torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    P, E = gate["prompt"], gate["steps"]
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, flash_cfg.vocab_size, (1, P + E))
                            .astype(np.int32)).to(DEVICE)
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = einsum.forward(params, {"tokens": toks})[0]
        fwd_err = (flash.forward(params, {"tokens": toks})[0] - want
                   ).abs().max().item()
        cache = flash.init_cache(1, P + E)
        lg, cache = flash.prefill(params, {"tokens": toks[:, :P]}, cache)
        errs = [(lg[0, -1] - want[P - 1]).abs().max().item()]
        for t in range(E):
            lg, cache = flash.decode_step(
                params, toks[:, P + t:P + t + 1], cache,
                torch.tensor([P + t], dtype=torch.int32, device=DEVICE))
            errs.append((lg[0, 0] - want[P + t]).abs().max().item())
        check(bool(torch.isfinite(want).all()),
              f"{arch} f32 gate: non-finite logits")
        scale = want[:, :flash_cfg.vocab_size].abs().max().item()
        del want, cache
    emit({"phase": "lm_gate_f32", "model": flash_cfg.name,
          "layers": flash_cfg.num_layers, "prompt": P, "decode_steps": E,
          "forward_max_abs_err": fwd_err, "decode_max_abs_err": max(errs),
          "logit_max_abs": scale, "tol": gate["tol"], "init_s": init_s,
          "seconds": time.perf_counter() - t0})
    check(fwd_err <= gate["tol"] and max(errs) <= gate["tol"],
          f"{arch} f32 gate: flash forward {fwd_err}, prefill+decode "
          f"{max(errs)} vs einsum forward (tol {gate['tol']})")

    prompts = [rng.integers(0, flash_cfg.vocab_size, n).astype(np.int32)
               for n in engine_prompts]
    N = 6
    max_seq = max(64, max(engine_prompts) + N + 2)
    with torch.inference_mode():
        engine = ServeEngine(flash, params,
                             EngineConfig(slots=2, max_seq=max_seq),
                             device=DEVICE)
        for i, p in enumerate(prompts):
            engine.submit(Request(rid=i, prompt=p, max_new_tokens=N))
        done = engine.run_until_drained()
        greedy = {i: _greedy(torch, flash, params, p, N, max_seq)
                  for i, p in enumerate(prompts)}
    got = {r.rid: r.generated for r in done}
    emit({"phase": "lm_engine_gate_f32", "model": flash_cfg.name,
          "prompts": list(engine_prompts), "engine": got, "greedy": greedy})
    check(got == greedy and engine.kv_slots.occupancy == 0.0,
          f"{arch} f32 engine gate: engine tokens differ from greedy "
          f"decoding")
    del params, engine
    torch.cuda.empty_cache()


def _init_timed(torch, model):
    """Parameters drawn on the card from seed 0, the seconds it took, and
    the peak bytes allocated while drawing them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _serve_stream(torch, np, model, params, serve, lengths):
    """`lengths` requests of random tokens (default_rng(1)) through a
    ServeEngine of serve["slots"] slots and serve["max_seq"] rows, each
    for serve["new_tokens"] tokens, with every prefill and decode tick
    timed (each ends synchronised: its argmax is read on the host), every
    logit checked finite, and the launch counts of exactly this run.
    Returns the engine, the retired requests and the run's numbers."""
    from repro_torch.kernels import _build
    from repro_torch.serve import EngineConfig, Request, ServeEngine
    cfg = model.cfg
    engine = ServeEngine(model, params,
                         EngineConfig(slots=serve["slots"],
                                      max_seq=serve["max_seq"]),
                         device=DEVICE)
    rng = np.random.default_rng(1)
    for i, n in enumerate(lengths):
        engine.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=serve["new_tokens"]))
    prefills, ticks, finite = [], [], []
    prefill, decode = engine._prefill, engine._decode
    decode_step, model_prefill = model.decode_step, model.prefill

    def timed_prefill(prompt):
        t = time.perf_counter()
        out = prefill(prompt)                 # ends synchronised (argmax)
        prefills.append({"prompt": len(prompt),
                         "ms": (time.perf_counter() - t) * 1e3})
        return out

    def timed_decode():
        t = time.perf_counter()
        out = decode()                        # ends synchronised (.cpu())
        ticks.append({"active": sum(r is not None for r in engine.active),
                      "ms": (time.perf_counter() - t) * 1e3})
        return out

    def checked(fn):
        def call(*args):
            logits, cache = fn(*args)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return call

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(engine, "_prefill", timed_prefill), \
            mock.patch.object(engine, "_decode", timed_decode), \
            mock.patch.object(model, "decode_step", checked(decode_step)), \
            mock.patch.object(model, "prefill", checked(model_prefill)):
        _build.reset_launches()
        t0 = time.perf_counter()
        done = engine.run_until_drained()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    n_tokens = sum(len(r.generated) for r in done)
    decode_ms = [t["ms"] for t in ticks]
    stats = {"requests": len(done), "tokens": n_tokens,
             "prefills": len(prefills), "decode_ticks": len(ticks),
             "launches": launches, "wall_s": wall_s,
             "tokens_per_s": n_tokens / wall_s,
             "prefill_ms_total": sum(p["ms"] for p in prefills),
             "decode_ms_total": sum(decode_ms),
             "decode_ms_median": statistics.median(decode_ms),
             "decode_ms_by_tick": decode_ms,
             "decode_tokens_per_s": sum(t["active"] for t in ticks)
             / (sum(decode_ms) / 1e3),
             "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    what = f"{cfg.name} serve"
    check(len(done) == len(lengths)
          and all(r.done and len(r.generated) == serve["new_tokens"]
                  for r in done),
          f"{what}: not every request retired with its tokens")
    check(engine.kv_slots.occupancy == 0.0, f"{what}: slots still held")
    check(bool(torch.stack(finite).all()), f"{what}: non-finite logits")
    check(len(prefills) == len(lengths), f"{what}: {len(prefills)} prefills")
    _check_attention_launches(model, launches, len(prefills), len(ticks),
                              what)
    return engine, done, prefills, ticks, stats


def _check_attention_launches(model, launches, prefills, ticks, what):
    """flash_attention launched once per self-attention layer per prefill
    and per decode step, plus the encoder's layers a prefill and the
    cross-attention layers a decode step (whose prefill encodes the memory
    on the einsum path), and `flash_combine` never: a decode step's
    split-KV attention merges in its own launch."""
    layers = model.attention_layers()
    enc = model.cfg.encoder_layers
    per_tick = layers + model.cross_attention_layers()
    want = layers * prefills + per_tick * ticks + enc * prefills
    check(launches["flash_attention"] == want,
          f"{what}: {launches['flash_attention']} flash_attention launches, "
          f"expected {layers} x {prefills} prefills + {per_tick} x {ticks} "
          f"decode steps + {enc} encoder layers x {prefills} = {want}")
    check(launches["flash_combine"] == 0,
          f"{what}: {launches['flash_combine']} flash_combine launches, "
          f"expected 0 (the decode kernel merges in its own launch)")


def lm_serve_path(torch, np):
    """Phase 5, the main path: SERVE["requests"] requests at full width in
    bf16 through ServeEngine, every attention layer through
    flash_attention."""
    from repro_torch.models.transformer import LM
    cfg = _lm_config(torch, "qwen2_1_5b")
    model = LM(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = _leaves(params)
    n_params = sum(t.numel() for t in leaves)
    check(n_params == 1_546_270_208, f"qwen2-1.5b has {n_params} params")
    lengths = np.random.default_rng(0).integers(64, 1025, SERVE["requests"])
    emit({"phase": "lm_setup", "model": cfg.name, "params": n_params,
          "param_bytes": sum(t.numel() * t.element_size() for t in leaves),
          "init_s": init_s, "prompt_lengths": [int(n) for n in lengths]})
    engine, done, prefills, ticks, stats = _serve_stream(
        torch, np, model, params, SERVE, lengths)
    for p in prefills:
        emit({"phase": "lm_prefill", **p})
    emit({"phase": "main_path", "plane": LM_PATH, "model": cfg.name,
          "kv_cache_bytes": engine.kv_slots.capacity_bytes, **stats})
    full_ticks = [t["ms"] for t in ticks if t["active"] == SERVE["slots"]]
    lm_profile(torch, np, engine, cfg, statistics.median(full_ticks))
    return stats["launches"]


#: phase 5b: each family's model (`configs.get` name, depth cut or None)
FAMILIES = (("recurrentgemma_2b", None), ("mamba2_1_3b", None),
            ("internvl2_1b", None), ("llama4_maverick_400b_a17b", 2),
            ("arctic_480b", 1))
#: the f32 gates of phase 5b: recurrentgemma-2b over a prompt longer than its
#: 2048-token window (so the window masks in prefill and decode, and one
#: engine prompt passes it too), arctic-480b's MoE at one layer
FAMILY_GATES = (("recurrentgemma_2b", None,
                 dict(prompt=2300, steps=16, tol=1e-3), (7, 2100, 5)),
                ("arctic_480b", 1, GATE, (7, 11, 5)))
#: phase 5b's bf16 stream: phase 5's 16 prompt lengths with the last one
#: 3000 (past recurrentgemma's 2048 window) through 8 slots of 4096 rows
FAMILY_SERVE = dict(slots=8, max_seq=4096, new_tokens=32, long_prompt=3000)
VLM_BATCH = dict(batch=4, prompt=32, new_tokens=16)
WHISPER = dict(batch=4, prompt=32, new_tokens=32)


def family_path_name(name: str) -> str:
    return f"{LM_PATH} {name}"


def _raw_decode(torch, model, params, batch, prompt_rows, new_tokens):
    """A serve_decode_torch-style static batch: prefill, then greedy decode
    steps at one scalar index each, every logit checked finite; returns
    the ms of the prefill and of each step (each synchronised) and the
    launch counts of the run."""
    from repro_torch.kernels import _build
    B = batch["tokens"].shape[0]
    cache = model.init_cache(B, prompt_rows + new_tokens)
    finite, step_ms = [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, cache)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        finite.append(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        for t in range(new_tokens - 1):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, tok, cache,
                                              prompt_rows + t)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            finite.append(torch.isfinite(logits).all())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.LAUNCHES)
    check(bool(torch.stack(finite).all()),
          f"{model.cfg.name} static batch: non-finite logits")
    return prefill_ms, step_ms, launches


def family_serve(torch, np, arch, layers) -> dict:
    """Phase 5b, one family in bf16 at full width: its model built, served
    through ServeEngine with attn_impl="flash" and freed.  internvl2 adds a
    static batch with 256 patches each."""
    from repro_torch.models.transformer import LM
    cfg = _lm_config(torch, arch, layers=layers)
    model = LM(cfg, device=DEVICE)
    params, init_s, init_peak = _init_timed(torch, model)
    n_params = sum(t.numel() for t in _leaves(params))
    lengths = np.random.default_rng(0).integers(64, 1025, 16)
    lengths[-1] = FAMILY_SERVE["long_prompt"]
    emit({"phase": "family_setup", "model": cfg.name, "family": cfg.family,
          "layers": cfg.num_layers, "params": n_params,
          "param_bytes": sum(t.numel() * t.element_size()
                             for t in _leaves(params)),
          "init_s": init_s, "init_peak_mem_bytes": init_peak,
          "moe_capacity_factor": cfg.moe_capacity_factor if cfg.moe_experts
          else None, "prompt_lengths": [int(n) for n in lengths]})
    engine, done, prefills, ticks, stats = _serve_stream(
        torch, np, model, params, FAMILY_SERVE, lengths)
    out = {"phase": "main_path", "plane": family_path_name(cfg.name),
           "model": cfg.name, "family": cfg.family,
           "kv_cache_bytes": engine.kv_slots.capacity_bytes,
           "prefill_ms_by_prompt": [[p["prompt"], p["ms"]] for p in prefills],
           **stats}
    launches = stats["launches"]
    if cfg.frontend == "vision_stub":
        rng = np.random.default_rng(0)
        B, S, T = VLM_BATCH["batch"], VLM_BATCH["prompt"], \
            VLM_BATCH["new_tokens"]
        P = cfg.frontend_tokens
        batch = {"tokens": torch.from_numpy(rng.integers(
                     0, cfg.vocab_size, (B, S)).astype(np.int32)).to(DEVICE),
                 "patches": torch.from_numpy(
                     (rng.standard_normal((B, P, cfg.d_model)) * 0.1
                      ).astype(np.float32)).to(DEVICE)}
        prefill_ms, step_ms, extra = _raw_decode(torch, model, params,
                                                 batch, P + S, T)
        _check_attention_launches(model, extra, 1, T - 1,
                                  f"{cfg.name} patches batch")
        out["patches_batch"] = {"batch": B, "patches": P, "prompt": S,
                                "new_tokens": T, "prefill_ms": prefill_ms,
                                "decode_ms_median": statistics.median(
                                    step_ms)}
        launches = {k: launches[k] + extra[k] for k in launches}
        out["launches"] = launches
    emit(out)
    del engine, params, model
    torch.cuda.empty_cache()
    return launches


def whisper_decode(torch, np) -> dict:
    """Phase 5b, whisper-small at full size through the raw steps: one
    prefill of WHISPER["batch"] x 1500 frames (stub embeddings from
    default_rng(0)) and a WHISPER["prompt"]-token prompt, then greedy
    decode steps.  Its 12 encoder layers (non-causal) and 12 decoder
    self-attention layers run flash_attention a prefill, whose
    cross-attention encodes the memory on the einsum path; a decode step
    runs the 12 self- and the 12 cross-attention layers (non-causal over
    the memory) through flash_attention, as the reference does."""
    from repro_torch.models.transformer import LM
    cfg = _lm_config(torch, "whisper_small")
    model = LM(cfg, device=DEVICE)
    params, init_s, _ = _init_timed(torch, model)
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(0)
    B, S, T = WHISPER["batch"], WHISPER["prompt"], WHISPER["new_tokens"]
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (B, S)).astype(np.int32)).to(DEVICE),
             "frames": torch.from_numpy(
                 (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
                  * 0.1).astype(np.float32)).to(DEVICE)}
    torch.cuda.reset_peak_memory_stats()
    prefill_ms, step_ms, launches = _raw_decode(torch, model, params,
                                                batch, S, T)
    _check_attention_launches(model, launches, 1, T - 1, cfg.name)
    emit({"phase": "main_path", "plane": family_path_name(cfg.name),
          "model": cfg.name, "family": cfg.family, "params": n_params,
          "init_s": init_s, "batch": B, "frames": cfg.encoder_seq,
          "prompt": S, "new_tokens": T, "prefill_ms": prefill_ms,
          "decode_ms_median": statistics.median(step_ms),
          "decode_ms_by_step": step_ms,
          "tokens_per_s": B * T / ((prefill_ms + sum(step_ms)) / 1e3),
          "launches": launches,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    del params, model
    torch.cuda.empty_cache()
    return launches


def lm_families(torch, np) -> dict:
    """Phase 5b: the f32 gates of FAMILY_GATES, then every family of
    FAMILIES served in bf16 and whisper-small decoded, each model freed
    before the next is built."""
    for arch, layers, gate, prompts in FAMILY_GATES:
        lm_gate_f32(torch, np, arch, layers=layers, gate=gate,
                    engine_prompts=prompts)
    from repro_torch import configs
    by_path = {}
    for arch, layers in FAMILIES:
        by_path[family_path_name(configs.get(arch).name)] = family_serve(
            torch, np, arch, layers)
    by_path[family_path_name(configs.get("whisper_small").name)] = \
        whisper_decode(torch, np)
    return by_path


def _device_busy(trace_path: Path) -> dict:
    """Kernel, copy and memset intervals of a Chrome trace: their union in
    ms, their count, and the kernels' summed ms and count by name."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans, by_name, count = [], {}, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((e["ts"], e["ts"] + e["dur"]))
        if e["cat"] == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
            count[e["name"]] = count.get(e["name"], 0) + 1
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return {"busy_ms": busy / 1e3, "device_ops": len(spans),
            "kernel_ms_by_name": by_name, "kernel_count_by_name": count}


def lm_profile(torch, np, engine, cfg, tick_ms: float) -> None:
    """Where phase 5's time goes on the card: `torch.profiler` over one
    1024-token prefill, then over PROFILE_TICKS decode ticks with all 8
    slots active.  Busy time is the union of the traced kernels, copies and
    memsets; the idle share of a tick is 1 - busy / `tick_ms`, the median
    unprofiled tick at 8 active slots from the counted run (the profiler
    slows the host, so its own wall time overstates idleness).  Runs after
    the launch counts were read, so it adds to none of them."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request
    rng = np.random.default_rng(2)
    slots = SERVE["slots"]
    for i in range(slots):
        engine.submit(Request(rid=1000 + i, prompt=rng.integers(
            0, cfg.vocab_size, 512).astype(np.int32),
            max_new_tokens=PROFILE_TICKS + 2))
    engine.step()                      # admits all 8, one decode tick
    check(all(r is not None for r in engine.active),
          "lm profile: slots not all active")
    prompt = rng.integers(0, cfg.vocab_size, 1024).astype(np.int32)
    trace = ROOT / "build" / "lm_profile_trace.json"
    trace.parent.mkdir(exist_ok=True)
    out = {"phase": "lm_profile", "tick_ms_unprofiled": tick_ms}
    for name, run in (("prefill_1024", lambda: engine._prefill(prompt)),
                      ("decode_ticks", lambda: [
                          engine.step() for _ in range(PROFILE_TICKS)])):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(str(trace))
        dev = _device_busy(trace)
        trace.unlink()
        n = PROFILE_TICKS if name == "decode_ticks" else 1
        top = sorted(dev["kernel_ms_by_name"].items(), key=lambda kv: -kv[1])
        flash = sum(ms for k, ms in dev["kernel_ms_by_name"].items()
                    if "flash_" in k)
        out[name] = {"profiled_wall_ms": wall_ms / n,
                     "busy_ms": dev["busy_ms"] / n,
                     "device_ops": dev["device_ops"] / n,
                     "flash_ms": flash / n,
                     "top_kernels_ms": [[k[:90], ms / n] for k, ms in top[:8]]}
    busy = out["decode_ticks"]["busy_ms"]
    out["decode_idle_share"] = (1 - busy / tick_ms) if busy > 0 else None
    emit(out)
    engine.run_until_drained()
    check(engine.kv_slots.occupancy == 0.0, "lm profile: slots still held")


# -- phase 5c --------------------------------------------------------------------

TRAIN_PATH = "lm-train"
#: phase 5c: qwen2-1.5b trained at full width and depth (AdamW, remat, the
#: trainer's cosine schedule with its max(steps // 20, 5) warmup) on the
#: learnable stream of tests/test_system.py:25 through the TokenPipeline
TRAIN = dict(arch="qwen2_1_5b", batch=8, seq=1024, steps=30, lr=6e-4,
             params=1_546_270_208)
#: the resume gate: the same model cut to 2 layers, `steps` straight against
#: `at` + save + restore + the rest, bit for bit
TRAIN_RESUME = dict(layers=2, steps=12, at=6)
#: the f32 gate: one step of the reduced qwen2 against a plain f32
#: re-computation of its loss, loss and grad norm within `tol` relative
TRAIN_GATE = dict(batch=4, seq=64, tol=1e-5)
#: one step each at the reduced config in bf16 (arctic on Adafactor)
TRAIN_FAMILIES = ("recurrentgemma_2b", "mamba2_1_3b", "internvl2_1b",
                  "whisper_small", "arctic_480b")
TRAIN_FAMILY_BATCH = dict(batch=2, seq=64, lr=1e-3)


def _stream(np):
    """tests/test_system.py:25's learnable stream: next = (token + 1) % 50."""
    return (np.cumsum(np.ones(1 << 14)) % 50).astype(np.int32)


def _on_device(torch, batch: dict) -> dict:
    return {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}


def _plain_qwen2_loss(torch, cfg, params, batch):
    """qwen2's mean next-token loss in plain f32 torch, written from the
    architecture and not through the port's layers: RMS norms, GQA with
    QKV bias and rotary halves, a causal softmax, SwiGLU, the tied head
    over the real vocabulary only."""
    import math
    F = torch.nn.functional
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    B, S = tokens.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    half = hd // 2
    inv = cfg.rope_theta ** (-torch.arange(half, dtype=torch.float32,
                                           device=DEVICE) / half)
    ang = torch.arange(S, dtype=torch.float32, device=DEVICE)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]

    def rot(t):
        a, b = t[..., :half], t[..., half:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)

    def rms(t, w):
        return t * torch.rsqrt(t.pow(2).mean(-1, keepdim=True)
                               + cfg.norm_eps) * w

    causal = torch.ones(S, S, dtype=torch.bool, device=DEVICE).tril()
    stack = params["stacks"][0]["b0"]
    x = params["embed"][tokens]
    for g in range(cfg.num_layers):
        a, m = stack["attn"], stack["mlp"]
        h = rms(x, stack["ln1"]["scale"][g])
        q = rot((h @ a["wq"][g] + a["bq"][g]).view(B, S, H, hd))
        k = rot((h @ a["wk"][g] + a["bk"][g]).view(B, S, KV, hd))
        v = (h @ a["wv"][g] + a["bv"][g]).view(B, S, KV, hd)
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        att = att.masked_fill(~causal, float("-inf")).softmax(-1)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, S, H * hd)
        x = x + o @ a["wo"][g]
        h = rms(x, stack["ln2"]["scale"][g])
        x = x + (F.silu(h @ m["w1"][g]) * (h @ m["w3"][g])) @ m["w2"][g]
    x = rms(x, params["final_norm"]["scale"])
    logits = x @ params["embed"][:cfg.vocab_size].T
    return F.cross_entropy(logits.reshape(B * S, -1), labels.reshape(-1))


def lm_train_gate_f32(torch, np) -> dict:
    """The f32 gate (TF32 off): one train step of the reduced qwen2 from
    parameters drawn on the card, its loss and grad norm against the plain
    re-computation's on the same batch."""
    from repro_torch import configs
    from repro_torch.models.transformer import LM
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.steps import TrainConfig, make_train_step
    cfg = dataclasses.replace(configs.get(TRAIN["arch"], reduced=True),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = LM(cfg, device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    rng = np.random.default_rng(0)
    shape = (TRAIN_GATE["batch"], TRAIN_GATE["seq"])
    batch = _on_device(torch, {
        "tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)})
    plain = {k: v.clone().requires_grad_(True) for k, v in
             ckpt._flatten(params).items()}
    loss = _plain_qwen2_loss(torch, cfg, ckpt._unflatten(params, plain),
                             batch)
    grads = torch.autograd.grad(loss, list(plain.values()))
    plain_gn = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    ocfg = OptimizerConfig(name="adamw", lr=1e-3)
    step = make_train_step(model, TrainConfig(optimizer=ocfg))
    _, _, metrics = step(params, opt_lib.init(params, ocfg), batch)
    out = {"phase": "lm_train_gate_f32", "model": cfg.name,
           "layers": cfg.num_layers, "batch": list(shape),
           "loss": float(metrics["loss"]), "plain_loss": float(loss.detach()),
           "grad_norm": float(metrics["grad_norm"]),
           "plain_grad_norm": plain_gn, "tol": TRAIN_GATE["tol"]}
    out["loss_rel_err"] = abs(out["loss"] / out["plain_loss"] - 1)
    out["grad_norm_rel_err"] = abs(out["grad_norm"] / plain_gn - 1)
    emit(out)
    check(out["loss_rel_err"] <= TRAIN_GATE["tol"]
          and out["grad_norm_rel_err"] <= TRAIN_GATE["tol"],
          f"lm train f32 gate: loss {out['loss']} vs {out['plain_loss']}, "
          f"grad norm {out['grad_norm']} vs {plain_gn} (tol "
          f"{TRAIN_GATE['tol']} relative)")
    return out


def _timed_steps(torch, step_fn, params, state, pipe, steps: int,
                 split: bool = False):
    """`steps` train steps, each on the pipeline's next batch and ended
    synchronised (its loss read on the host); with `split`, CUDA events
    around each step's forward+backward and its optimizer update."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps as steps_lib
    rows, events = [], []

    def evented(name, fn):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            events[-1][name] = (start, end)
            return out
        return call

    patches = (mock.patch.object(steps_lib, "_grads",
                                 evented("fwd_bwd", steps_lib._grads)),
               mock.patch.object(opt_lib, "update",
                                 evented("optimizer", opt_lib.update))) \
        if split else ()
    for p in patches:
        p.start()
    try:
        for _ in range(steps):
            events.append({})
            t0 = time.perf_counter()
            batch = _on_device(torch, next(pipe))
            params, state, m = step_fn(params, state, batch)
            loss = float(m["loss"])                      # synchronises
            rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "loss": loss, "grad_norm": float(m["grad_norm"]),
                         "lr": float(m["lr"])})
            for name, (start, end) in events[-1].items():
                rows[-1][f"{name}_ms"] = start.elapsed_time(end)
    finally:
        for p in patches:
            p.stop()
    return params, state, rows


def lm_train_full(torch, np) -> dict:
    """Phase 5c's main path: qwen2-1.5b at full width and depth through
    `repro_torch.launch.train.build`, TRAIN["steps"] steps on the learnable
    stream.  Gates: the published parameter count; the first step (lr 0)
    moves no parameter; every loss and grad norm finite; the mean of the
    last 5 losses below half the mean of the first 5; no kernel of the
    port launched (training runs the einsum attention)."""
    from repro_torch.kernels import _build
    from repro_torch.launch.train import build
    from repro_torch.train import optimizer as opt_lib
    cfg, model, step_fn, pipe, ocfg = build(
        TRAIN["arch"], reduced=False, batch=TRAIN["batch"],
        seq=TRAIN["seq"], lr=TRAIN["lr"], total_steps=TRAIN["steps"],
        schedule="cosine", device=DEVICE)
    pipe.tokens = _stream(np)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    state = opt_lib.init(params, ocfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = opt_lib.leaves(params)
    n_params = sum(t.numel() for t in leaves)
    check(n_params == TRAIN["params"],
          f"{cfg.name} has {n_params} params, not {TRAIN['params']}")
    resident = torch.cuda.memory_allocated()
    before = [t.clone() for t in leaves]
    _build.reset_launches()
    params, state, first = _timed_steps(torch, step_fn, params, state, pipe,
                                        1, split=True)
    moved = [i for i, (a, b) in enumerate(zip(before, opt_lib.leaves(
        params))) if not torch.equal(a, b)]
    del before
    check(first[0]["lr"] == 0.0 and not moved,
          f"{cfg.name} train: the first step (lr {first[0]['lr']}) moved "
          f"{len(moved)} parameter leaves")
    params, state, rest = _timed_steps(torch, step_fn, params, state, pipe,
                                       TRAIN["steps"] - 1, split=True)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    rows = first + rest
    losses = [r["loss"] for r in rows]
    tokens = TRAIN["batch"] * TRAIN["seq"]
    step_ms = statistics.median(r["ms"] for r in rest)
    out = {"phase": "main_path", "plane": TRAIN_PATH, "model": cfg.name,
           "params": n_params, "optimizer": ocfg.name, "remat": cfg.remat,
           "batch": TRAIN["batch"], "seq": TRAIN["seq"], "steps": len(rows),
           "peak_lr": TRAIN["lr"], "init_s": init_s,
           "resident_bytes": resident,
           "step_ms_median": step_ms, "tokens_per_step": tokens,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "mfu": 6 * n_params * tokens / (step_ms / 1e3) / BF16_FLOPS_PER_S,
           "fwd_bwd_ms_median": statistics.median(
               r["fwd_bwd_ms"] for r in rest),
           "optimizer_ms_median": statistics.median(
               r["optimizer_ms"] for r in rest),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "losses": losses, "grad_norms": [r["grad_norm"] for r in rows],
           "lrs": [r["lr"] for r in rows],
           "step_ms": [r["ms"] for r in rows], "launches": launches}
    emit(out)
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              for r in rows), f"{cfg.name} train: a non-finite loss or norm")
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    check(tail < 0.5 * head, f"{cfg.name} train: the last 5 losses average "
          f"{tail}, not below half the first 5's {head}")
    check(not any(launches.values()),
          f"{cfg.name} train: kernels launched on the einsum path: "
          f"{launches}")
    prof = lm_train_profile(torch, step_fn, params, state, pipe, step_ms)
    # phase 6's inputs: the measured step, and one more step's gradients
    from repro_torch.train import steps as steps_lib
    del state
    torch.cuda.empty_cache()
    _, grads = steps_lib._grads(model, params, _on_device(torch, next(pipe)))
    it = iter(grads)
    TRAIN_MEASURED.update(
        step_ms=step_ms, peak_mem_bytes=out["peak_mem_bytes"],
        params=n_params, kernel_ms_by_class=prof["kernel_ms_by_class"],
        device_ops=prof["device_ops"], busy_ms=prof["busy_ms"],
        grads=opt_lib.tree_map(lambda _: next(it), params))
    del params, model, step_fn, grads, it
    torch.cuda.empty_cache()
    return launches


def _kernel_class(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul"
    if "softmax" in low:
        return "softmax"
    if "reduce" in low or "norm" in low:
        return "reduce"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


def lm_train_profile(torch, step_fn, params, state, pipe,
                     step_ms: float) -> None:
    """Where a full-width train step's time goes on the card:
    `torch.profiler` over one more step after the counted run, the card's
    busy ms (the union of kernels, copies and memsets), its idle share
    against the unprofiled median step, the kernels' ms by class (matmul,
    softmax, reduce, elementwise, other) and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    trace = ROOT / "build" / "lm_train_trace.json"
    trace.parent.mkdir(exist_ok=True)
    batch = _on_device(torch, next(pipe))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(trace))
    dev = _device_busy(trace)
    trace.unlink()
    by_class: dict = {}
    for name, ms in dev["kernel_ms_by_name"].items():
        c = _kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + ms
    top = sorted(dev["kernel_ms_by_name"].items(), key=lambda kv: -kv[1])
    out = {"phase": "lm_train_profile", "step_ms_unprofiled": step_ms,
           "profiled_wall_ms": wall_ms, "busy_ms": dev["busy_ms"],
           "device_ops": dev["device_ops"],
           "idle_share": 1 - dev["busy_ms"] / step_ms,
           "kernel_ms_by_class": by_class,
           "top_kernels_ms": [[k[:90], ms] for k, ms in top[:12]]}
    emit(out)
    return out


def lm_train_resume(torch, np) -> dict:
    """The resume gate, deterministic algorithms on: qwen2-1.5b at full
    width cut to TRAIN_RESUME["layers"] layers, TRAIN_RESUME["steps"] steps
    straight, and again with `train.checkpoint` saving the params, the
    AdamW state and the pipeline after TRAIN_RESUME["at"] and restoring
    them into a model drawn from another seed and a fresh pipeline: every
    parameter and state leaf, and every loss after the restore, bit-equal
    to the straight run's.  The checkpoint goes to a temporary directory
    that the phase deletes."""
    from repro_torch import configs
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.models.transformer import LM
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import schedules
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.steps import TrainConfig, make_train_step
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        cfg = dataclasses.replace(configs.get(TRAIN["arch"]),
                                  num_layers=TRAIN_RESUME["layers"])
        model = LM(cfg, device=DEVICE)
        steps, at = TRAIN_RESUME["steps"], TRAIN_RESUME["at"]
        ocfg = OptimizerConfig(name="adamw", lr=TRAIN["lr"])
        step_fn = make_train_step(model, TrainConfig(
            optimizer=ocfg, schedule=schedules.make(
                "cosine", peak_lr=TRAIN["lr"], warmup=max(steps // 20, 5),
                total=steps)))

        def fresh(seed):
            params = model.init(torch.Generator(device=DEVICE)
                                .manual_seed(seed))
            pipe = TokenPipeline(None, TokenPipelineConfig(
                batch_size=TRAIN["batch"], seq_len=TRAIN["seq"],
                vocab_size=cfg.vocab_size))
            pipe.tokens = _stream(np)
            return params, opt_lib.init(params, ocfg), pipe

        params, state, pipe = fresh(0)
        n_params = sum(t.numel() for t in opt_lib.leaves(params))
        params, state, straight = _timed_steps(torch, step_fn, params,
                                               state, pipe, steps)
        want = ckpt._flatten((params, state))
        params, state, pipe = fresh(0)
        params, state, head = _timed_steps(torch, step_fn, params, state,
                                           pipe, at)
        # phase 6d restores this checkpoint onto a mesh and then deletes it
        tmp = Path(tempfile.mkdtemp(prefix="lm_resume_"))
        atexit.register(shutil.rmtree, tmp, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = ckpt.save(tmp, at, (params, state),
                      {"pipeline": pipe.state_dict()})
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = sum(f.stat().st_size for f in d.rglob("*")
                     if f.is_file())
        TRAIN_MEASURED["resume"] = dict(
            dir=tmp, step=at, cfg=cfg, saved=ckpt._unflatten(
                (params, state), {k: v.clone() for k, v in
                                  ckpt._flatten((params, state)).items()}))
        del params, state, pipe
        params, state, pipe = fresh(1)
        t0 = time.perf_counter()
        (params, state), extra = ckpt.restore(tmp, at, (params, state))
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        pipe.load_state_dict(extra["pipeline"])
        params, state, tail = _timed_steps(torch, step_fn, params, state,
                                           pipe, steps - at)
        got = ckpt._flatten((params, state))
        unequal = [k for k in want if not torch.equal(want[k], got[k])]
        losses_equal = [r["loss"] for r in head + tail] == \
            [r["loss"] for r in straight]
        out = {"phase": "lm_train_resume", "model": cfg.name,
               "layers": cfg.num_layers, "params": n_params,
               "steps": steps, "saved_after": at, "save_ms": save_ms,
               "restore_ms": restore_ms, "bytes_written": nbytes,
               "leaves": len(want), "unequal_leaves": unequal[:10],
               "losses_equal": losses_equal,
               "step_ms_median": statistics.median(
                   r["ms"] for r in straight[1:]),
               "losses": [r["loss"] for r in straight]}
        emit(out)
        check(not unequal and losses_equal,
              f"{cfg.name} resume: {len(unequal)} of {len(want)} leaves "
              f"differ from the straight run's (first {unequal[:3]}), "
              f"losses equal: {losses_equal}")
        del params, state, want, got, model, step_fn
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    return out


def lm_train_families(torch, np) -> list:
    """One train step of each family of TRAIN_FAMILIES at its reduced
    config in bf16 through `launch.train.build` (a vlm's patches from its
    `FeatureStore.synthetic` through the TokenPipeline; whisper's frames
    drawn here, which the trainer's pipeline cannot give: ROADMAP.md Queue 3
    item 10), at a constant rate so that the step moves the params: a
    finite loss and grad norm, every parameter leaf a gradient reaches
    changed."""
    from repro_torch.launch.train import build
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.steps import TrainConfig, make_train_step
    fb = TRAIN_FAMILY_BATCH
    rows = []
    for arch in TRAIN_FAMILIES:
        cfg, model, _, pipe, ocfg = build(
            arch, reduced=True, batch=fb["batch"], seq=fb["seq"],
            lr=fb["lr"], total_steps=10, schedule="cosine", device=DEVICE)
        step_fn = make_train_step(model, TrainConfig(
            optimizer=ocfg, schedule=lambda s: fb["lr"]))
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
        batch = _on_device(torch, next(pipe))
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy((np.random.default_rng(0)
                .standard_normal((fb["batch"], cfg.encoder_seq, cfg.d_model))
                * 0.1).astype(np.float32)).to(DEVICE)
        before = [t.clone() for t in opt_lib.leaves(params)]
        t0 = time.perf_counter()
        params, state, m = step_fn(params, opt_lib.init(params, ocfg), batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        ms = (time.perf_counter() - t0) * 1e3
        changed = sum(not torch.equal(a, b) for a, b in
                      zip(before, opt_lib.leaves(params)))
        row = {"model": cfg.name, "family": cfg.family,
               "optimizer": ocfg.name, "dtype": str(cfg.param_dtype),
               "batch": sorted(batch), "loss": loss, "grad_norm": gn,
               "leaves": len(before), "leaves_changed": changed,
               "step_ms": ms}
        rows.append(row)
        check(np.isfinite(loss) and np.isfinite(gn) and changed == len(before),
              f"{cfg.name} train step: loss {loss}, grad norm {gn}, "
              f"{changed} of {len(before)} leaves changed")
        del params, state, model, step_fn, before
    emit({"phase": "lm_train_families", "models": rows})
    return rows


def lm_train_guard(torch, np) -> None:
    """A flash-configured model asked for a gradient on the card raises
    (neither package has a backward for flash_attention) instead of
    training without attention's gradients."""
    from repro_torch import configs
    from repro_torch.models.transformer import LM
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.steps import TrainConfig, make_train_step
    cfg = dataclasses.replace(configs.get(TRAIN["arch"], reduced=True),
                              attn_impl="flash")
    model = LM(cfg, device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    tokens = torch.zeros((1, 8), dtype=torch.int32, device=DEVICE)
    step = make_train_step(model, TrainConfig(optimizer=OptimizerConfig()))
    try:
        step(params, opt_lib.init(params, OptimizerConfig()),
             {"tokens": tokens, "labels": tokens})
    except NotImplementedError as e:
        emit({"phase": "lm_train_guard", "model": cfg.name,
              "raised": str(e)[:120]})
        return
    fail("a flash model took a train step on the card")


def lm_train(torch, np) -> dict:
    """Phase 5c: the f32 gate, the full-width run, the resume gate, one
    step of each family and the flash guard.  Starts phase 6e's CPU twin
    first: the card is busy through 5c, the host mostly idle."""
    quickstart_cpu_start()
    lm_train_gate_f32(torch, np)
    torch.cuda.empty_cache()
    launches = lm_train_full(torch, np)
    lm_train_resume(torch, np)
    lm_train_families(torch, np)
    lm_train_guard(torch, np)
    torch.cuda.empty_cache()
    return {TRAIN_PATH: launches}


# -- phase 6 ---------------------------------------------------------------------

#: phase 5c's measured step and its inputs for phase 6 (filled by phase 5c)
TRAIN_MEASURED: dict = {}
#: 6a: (arch, shape, multi_pod, expected status)
DRYRUN_CELLS = (("qwen2_1_5b", "train_4k", False, "OK"),
                ("qwen2_1_5b", "prefill_32k", False, "OK"),
                ("qwen2_1_5b", "decode_32k", False, "OK"),
                ("qwen2_1_5b", "long_500k", False, "SKIP(full-attention)"),
                ("llama4_maverick_400b_a17b", "train_4k", False, "OK"),
                ("llama4_maverick_400b_a17b", "train_4k", True, "OK"))
#: 6c: error-feedback calls over the full-width gradient tree, and the
#: leaves also compressed on the host CPU and compared bit for bit
COMPRESS = dict(calls=5, cpu_leaves=("stacks/0/b0/attn/wk",
                                     "stacks/0/b0/attn/bq"))
#: 6c's bytes bound per element: g (bf16) and e (f32) read twice (the scale
#: needs the whole leaf's max first), the dequantized and error leaves
#: (f32) written once
COMPRESS_BYTES_PER_ELEMENT = 2 * (2 + 4) + 4 + 4
QUICKSTART = ROOT / "examples" / "quickstart_torch.py"
QUICKSTART_PATH = "quickstart"
#: phase 6e's CPU twin: its process, its directory, its start time
QUICKSTART_CPU: dict = {}


def quickstart_cpu_start() -> None:
    """examples/quickstart_torch.py --device cpu in a background process
    (no card visible to it, two threads), for phase 6e."""
    tmp = tempfile.mkdtemp(prefix="quickstart_cpu_")
    atexit.register(shutil.rmtree, tmp, True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    proc = subprocess.Popen([sys.executable, str(QUICKSTART), "--device",
                             "cpu"], cwd=tmp, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    atexit.register(proc.kill)
    QUICKSTART_CPU.update(proc=proc, dir=tmp, t0=time.perf_counter())


def _priced_lines(text: str) -> list:
    """The quickstart's lines but the wall-clock ones of its last
    section."""
    return [line for line in text.splitlines()
            if not line.rstrip().endswith("spans)")]


def dryrun_sweep(torch, np) -> list:
    """6a: the dry-run on the meta device over DRYRUN_CELLS."""
    from repro_torch.launch import dryrun
    rows = []
    for arch, shape, multi_pod, want in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod)
        row = {"arch": arch, "shape": shape, "mesh": rec["mesh"],
               "status": rec["status"],
               "seconds": time.perf_counter() - t0}
        if rec["status"] == "OK":
            r = rec["roofline"]
            row.update(strategy=rec["strategy"], bottleneck=r["bottleneck"],
                       compute_s=r["compute_term"],
                       memory_s=r["memory_term"],
                       collective_s=r["collective_term"],
                       peak_gib=rec["memory"]["peak_per_device_gib"],
                       useful_ratio=r["useful_ratio"], ops=rec["cost"]["ops"])
            check(all(np.isfinite(row[k]) and row[k] > 0 for k in
                      ("compute_s", "memory_s", "collective_s", "peak_gib",
                       "useful_ratio")),
                  f"dry-run {arch} {shape}: a term is not finite and "
                  f"positive: {row}")
        rows.append(row)
        check(rec["status"] == want,
              f"dry-run {arch} {shape} {rec['mesh']}: {rec['status']}, "
              f"expected {want}")
    emit({"phase": "dryrun", "device": "meta", "cells": rows})
    return rows


def _phase5c_cell(torch):
    """Phase 5c's step as a Cell on the host mesh: the trainer's model and
    step on the meta device, params, AdamW state and batch placed by the
    tp rules (ZeRO-1 for the state)."""
    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch.mesh import (NamedSharding, Placed,
                                         make_host_mesh, map_tree, specs)
    from repro_torch.launch.train import build
    from repro_torch.models.common import abstract_params, sharding_rules
    from repro_torch.train import optimizer as opt_lib
    mesh = make_host_mesh(DEVICE)
    cfg, model, step_fn, _, ocfg = build(
        TRAIN["arch"], reduced=False, batch=TRAIN["batch"], seq=TRAIN["seq"],
        lr=TRAIN["lr"], total_steps=TRAIN["steps"], schedule="cosine",
        device="meta")
    rules = sharding_rules("tp")
    params = abstract_params(model.param_defs(), rules, mesh)
    state = opt_lib.abstract_state(ocfg.name, params, ocfg)
    ospecs = opt_lib.opt_state_pspecs(
        ocfg.name, map_tree(lambda p: p.shape, params), specs(params), mesh)
    state = map_tree(lambda t, sp: Placed(t, NamedSharding(mesh, sp)),
                     state, ospecs)
    batch = specs_lib.batch_specs(cfg, mesh, TRAIN["batch"], TRAIN["seq"],
                                  False)
    cell = specs_lib.Cell(arch=TRAIN["arch"], shape="phase-5c", cfg=cfg,
                          model=model, kind="train",
                          abstract_args=(params, state, batch),
                          step_fn=step_fn, rules=rules, batch=TRAIN["batch"],
                          seq=TRAIN["seq"])
    return cell, mesh


def roofline_check(torch, np) -> dict:
    """6b: the roofline of phase 5c's own step against its measurement."""
    from repro_torch.launch import dryrun, roofline
    cell, mesh = _phase5c_cell(torch)
    t0 = time.perf_counter()
    cost = dryrun.cost_cell(cell, mesh, False)
    seconds = time.perf_counter() - t0
    roof = roofline.analyze(cost["flops"], cost["hbm"], cost["coll"],
                            chips=mesh.size)
    cfg = cell.cfg
    n, tokens = TRAIN["params"], TRAIN["batch"] * TRAIN["seq"]
    # the einsum attention's products: scores and values, forward, remat's
    # forward and the two gradients of each
    attn = 4 * 4 * TRAIN["batch"] * TRAIN["seq"] ** 2 * cfg.num_heads \
        * cfg.hd * cfg.num_layers
    m = TRAIN_MEASURED
    by_class = m["kernel_ms_by_class"]
    out = {"phase": "roofline_check", "model": cfg.name,
           "mesh": mesh.shape, "count_s": seconds,
           "flops": cost["flops"], "flops_per_n_tokens":
           cost["flops"] / (n * tokens), "attention_flops": attn,
           "hbm_bytes": cost["hbm"], "ops": cost["ops"],
           "predicted_compute_ms": roof.compute_term * 1e3,
           "predicted_memory_ms": roof.memory_term * 1e3,
           "predicted_step_ms": roof.step_time_s * 1e3,
           "bottleneck": roof.bottleneck,
           "predicted_peak_gb": cost["memory"]["peak_per_device_gib"]
           * 2**30 / 1e9,
           "measured_step_ms": m["step_ms"],
           "measured_peak_gb": m["peak_mem_bytes"] / 1e9,
           "measured_busy_ms": m["busy_ms"],
           "measured_device_ops": m["device_ops"],
           "measured_matmul_ms": by_class.get("matmul", 0.0),
           "measured_elementwise_ms": by_class.get("elementwise", 0.0),
           "hbm_bytes_by_op": cost["by_op_bytes"]}
    out["predicted_over_measured"] = out["predicted_step_ms"] / m["step_ms"]
    emit(out)
    check(out["predicted_step_ms"] <= m["step_ms"],
          f"roofline: predicted step {out['predicted_step_ms']} ms above "
          f"the measured {m['step_ms']} ms; the model is wrong")
    check(6 * n * tokens <= cost["flops"] <= 9 * n * tokens + attn,
          f"roofline: {cost['flops']} FLOPs outside [6 N T, 9 N T + "
          f"{attn}]")
    return out


def _bits(torch, t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def compression(torch, np) -> dict:
    """6c: compress_grads over phase 5c's gradient tree on the card."""
    from repro_torch.distributed import compression as comp
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import checkpoint as ckpt
    grads = TRAIN_MEASURED.pop("grads")
    flat_g = ckpt._flatten(grads)
    n = sum(t.numel() for t in flat_g.values())
    by_dtype: dict = {}
    for t in flat_g.values():
        by_dtype[str(t.dtype)] = by_dtype.get(str(t.dtype), 0) + t.numel()
    check(n == TRAIN["params"] and all(t.device.type == DEVICE
                                       for t in flat_g.values()),
          f"compress: the gradient tree has {n} elements, not "
          f"{TRAIN['params']} on the card")
    meta = {k: torch.empty(t.shape, dtype=t.dtype, device="meta")
            for k, t in flat_g.items()}
    _, eager = roofline.count(comp.compress_grads, meta,
                              comp.init_error(meta))
    err = comp.init_error(grads)
    applied = {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for k, t in flat_g.items()}
    ms, worst, last_deq = [], 0.0, {}
    for _ in range(COMPRESS["calls"]):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        deq, new_err = comp.compress_grads(grads, err)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        flat_e, flat_ne = ckpt._flatten(err), ckpt._flatten(new_err)
        for k, d in ckpt._flatten(deq).items():
            g32 = flat_g[k].float() + flat_e[k]
            s = float(g32.abs().max()) / 127.0 + 1e-12
            r = float(flat_ne[k].abs().max())
            worst = max(worst, r / (s / 2 + 1e-7))
            check(r <= s / 2 + 1e-7, f"compress {k}: residual {r} above "
                  f"s/2 + 1e-7 = {s / 2 + 1e-7}")
            applied[k].add_(d)
            if k in COMPRESS["cpu_leaves"]:
                last_deq[k] = d
            del g32
        del deq, flat_e
        err = new_err
        del flat_ne, new_err
    flat_e = ckpt._flatten(err)
    tele = 0.0
    for k, g in flat_g.items():
        gf = g.float()
        true = gf.clone()
        for _ in range(COMPRESS["calls"] - 1):
            true.add_(gf)
        resid = float((applied[k] - true).abs().max())
        last = float((gf + flat_e[k]).abs().max()) / 127.0
        tele = max(tele, resid / (2 * max(last, 1e-6)))
        check(resid <= 2 * max(last, 1e-6),
              f"compress {k}: telescoping residual {resid} above "
              f"{2 * max(last, 1e-6)}")
        del gf, true
    del applied
    cpu_equal = {}
    # the last call's dequantized leaf and error, bit for bit against five
    # calls of the port's CPU path on the same gradient leaf
    for k in COMPRESS["cpu_leaves"]:
        g = flat_g[k].cpu()
        e = comp.init_error(g)
        for _ in range(COMPRESS["calls"]):
            d, e = comp.compress_grads(g, e)
        cpu_equal[k] = bool(
            torch.equal(_bits(torch, d), _bits(torch, last_deq[k].cpu()))
            and torch.equal(_bits(torch, e), _bits(torch, flat_e[k].cpu())))
    check(all(cpu_equal.values()),
          f"compress: card and CPU differ on {cpu_equal}")
    mesh = make_host_mesh(DEVICE)
    same = comp.psum_compressed(grads, err, mesh)
    check(same[0] is grads and same[1] is err,
          "compress: psum_compressed over the host mesh is not the identity")
    steady = statistics.median(ms[1:])
    bound_ms = COMPRESS_BYTES_PER_ELEMENT * n / HBM_BYTES_PER_S * 1e3
    out = {"phase": "compress", "elements": n, "leaves": len(flat_g),
           "elements_by_dtype": by_dtype,
           "calls_ms": ms, "ms": steady, "bound_ms": bound_ms,
           "bound_bytes_per_element": COMPRESS_BYTES_PER_ELEMENT,
           "eager_bytes_per_element": eager.hbm_bytes / n,
           "eager_ops": eager.ops, "eager_bound_ms":
           eager.hbm_bytes / HBM_BYTES_PER_S * 1e3,
           "share_of_bound": bound_ms / steady,
           "worst_residual_over_half_step": worst,
           "worst_telescoping_over_bound": tele,
           "cpu_bit_equal": cpu_equal, "psum_host_mesh_identity": True}
    emit(out)
    del grads, err, flat_g, flat_e, same, last_deq
    torch.cuda.empty_cache()
    return out


def elastic_restore(torch, np) -> dict:
    """6d: phase 5c's 2-layer checkpoint restored onto the host mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_host_mesh, shardings
    from repro_torch.models.common import (param_pspecs, sharding_rules,
                                           tree_map_defs)
    from repro_torch.models.transformer import LM
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_lib
    info = TRAIN_MEASURED.pop("resume")
    try:
        mesh = make_host_mesh(DEVICE)
        defs = LM(info["cfg"], device="meta").param_defs()
        pspecs = param_pspecs(defs, sharding_rules("tp"), mesh)
        ospecs = opt_lib.opt_state_pspecs(
            "adamw", tree_map_defs(lambda d: d.shape, defs), pspecs, mesh)
        sh = shardings(mesh, (pspecs, ospecs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, _ = ckpt.restore(info["dir"], info["step"], info["saved"],
                               shardings=sh)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        got, want = ckpt._flatten(tree), ckpt._flatten(info["saved"])
        flat_sh = ckpt._flatten(sh)
        unequal = [k for k in want
                   if not (isinstance(got[k], DTensor)
                           and got[k].device.type == DEVICE
                           and torch.equal(_bits(torch, got[k].to_local()),
                                           _bits(torch, want[k])))]
        misplaced = [k for k in want if got[k].placements
                     != mesh.placements(flat_sh[k].spec)]
        specs_used = sorted({str(flat_sh[k].spec) for k in want})
        out = {"phase": "elastic_restore", "model": info["cfg"].name,
               "layers": info["cfg"].num_layers, "mesh": mesh.shape,
               "leaves": len(want), "restore_ms": restore_ms,
               "specs": specs_used, "unequal_leaves": unequal[:10],
               "misplaced_leaves": misplaced[:10]}
        emit(out)
        check(not unequal and not misplaced,
              f"elastic restore: {len(unequal)} leaves differ, "
              f"{len(misplaced)} misplaced")
        del tree, got, want
    finally:
        shutil.rmtree(info["dir"], ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    del info
    torch.cuda.empty_cache()
    return out


def quickstart_card(torch, np) -> dict:
    """6e: the quickstart twin on the card, in this process (its kernel
    launches counted), against its CPU twin's lines."""
    import contextlib
    import io
    import runpy
    from repro_torch.kernels import _build
    buf = io.StringIO()
    cwd, argv = os.getcwd(), sys.argv
    tmp = tempfile.mkdtemp(prefix="quickstart_cuda_")
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        os.chdir(tmp)
        sys.argv = [str(QUICKSTART), "--device", DEVICE]
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(QUICKSTART), run_name="__main__")
        torch.cuda.synchronize()
        trace_bytes = (Path(tmp) / "trace.json").stat().st_size
    finally:
        sys.argv = argv
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    proc = QUICKSTART_CPU["proc"]
    cpu_out, cpu_err = proc.communicate(timeout=900)
    cpu_s = time.perf_counter() - QUICKSTART_CPU["t0"]
    check(proc.returncode == 0,
          f"quickstart on the CPU exited {proc.returncode}: {cpu_err[-800:]}")
    card, cpu = _priced_lines(buf.getvalue()), _priced_lines(cpu_out)
    differ = [(a, b) for a, b in zip(card, cpu) if a != b]
    out = {"phase": "main_path", "plane": QUICKSTART_PATH,
           "script": "examples/quickstart_torch.py", "seconds": seconds,
           "cpu_twin_seconds_since_start": cpu_s, "lines": len(card),
           "cpu_lines": len(cpu), "differing": differ[:5],
           "trace_bytes": trace_bytes, "launches": launches,
           "wall_lines": [line for line in buf.getvalue().splitlines()
                          if line not in card]}
    emit(out)
    check(len(card) == len(cpu) and not differ and len(card) > 40,
          f"quickstart: {len(differ)} priced lines differ from the CPU "
          f"twin's ({len(card)} against {len(cpu)} lines)")
    for name in PATH_KERNELS[QUICKSTART_PATH]:
        check(launches[name] > 0,
              f"kernel {name} was not launched on {QUICKSTART_PATH}")
    return launches


def launch_and_distributed(torch, np) -> dict:
    """Phase 6: the dry-run, the roofline against phase 5c, compression at
    full width, the elastic restore and the quickstart twin."""
    dryrun_sweep(torch, np)
    roofline_check(torch, np)
    compression(torch, np)
    elastic_restore(torch, np)
    return {QUICKSTART_PATH: quickstart_card(torch, np)}


#: the kernels each main path must launch
PATH_KERNELS = {
    "gids-device": ("segment_mean", "tiered_gather", "store_fill",
                    "cache_bucket", "cache_access"),
    MERGED_PLANE: ("segment_mean", "tiered_gather_unique", "frontier_read",
                   "store_fill", "cache_bucket", "cache_access"),
    "gids-async": ("segment_mean", "tiered_gather", "store_fill"),
    "gids-merged-async": ("segment_mean", "tiered_gather_unique",
                          "store_fill"),
    RESUME_ASYNC: ("segment_mean", "tiered_gather", "store_fill"),
    RESUME_MERGED: ("segment_mean", "tiered_gather_unique", "frontier_read",
                    "store_fill", "cache_bucket", "cache_access"),
    "ladies gids": ("tiered_gather", "store_fill"),
    "ladies gids-device": ("tiered_gather", "store_fill", "cache_bucket",
                           "cache_access"),
    FAULT_PLANE: ("segment_mean", "tiered_gather", "store_fill"),
    CLUSTER_PLANE: ("segment_mean", "tiered_gather_unique", "frontier_read",
                    "store_fill"),
    TRACED_MERGED: ("tiered_gather_unique", "frontier_read", "store_fill",
                    "cache_bucket", "cache_access"),
    TRACED_FAULT: ("tiered_gather", "store_fill"),
    SERVE_S1: ("frontier_read", "tiered_gather_unique", "store_fill",
               "segment_mean"),
    SERVE_S2: ("frontier_read", "tiered_gather", "store_fill",
               "segment_mean"),
    SERVE_S3: ("frontier_read", "tiered_gather_unique", "store_fill"),
    SERVE_S4: ("frontier_read", "tiered_gather_unique", "store_fill",
               "segment_mean"),
    LM_PATH: ("flash_attention",),
    **{family_path_name(name): ("flash_attention",)
       for name in ("recurrentgemma-2b", "internvl2-1b",
                    "llama4-maverick-400b-a17b", "arctic-480b",
                    "whisper-small")},
    family_path_name("mamba2-1.3b"): (),       # no attention, no kernel
    TRAIN_PATH: (),                            # einsum attention, no kernel
    QUICKSTART_PATH: ("tiered_gather", "tiered_gather_unique", "store_fill",
                      "frontier_read"),
}


#: name -> (source, the reference function it replaces, parity class)
SOURCES = {
    "segment_mean": ("src/repro_torch/kernels/csrc/segment_mean.cu",
                     "src/repro/kernels/segment_mean.py:40",
                     "allclose 1e-6 f32, 2e-2 bf16"),
    "tiered_gather": ("src/repro_torch/kernels/csrc/tiered_gather.cu",
                      "src/repro/kernels/tiered_gather.py:154", "exact"),
    "store_fill": ("src/repro_torch/kernels/csrc/tiered_gather.cu",
                   "src/repro/core/device_store.py:48", "exact"),
    "cache_bucket": ("src/repro_torch/kernels/csrc/cache_access.cu",
                     "src/repro/core/cache_jax.py:70", "exact"),
    "cache_access": ("src/repro_torch/kernels/csrc/cache_access.cu",
                     "src/repro/core/cache_jax.py:70", "exact"),
    "tiered_gather_unique": ("src/repro_torch/kernels/csrc/tiered_gather.cu",
                             "src/repro/kernels/tiered_gather.py:235",
                             "exact"),
    "frontier_gather": ("src/repro_torch/kernels/csrc/frontier_gather.cu",
                        "src/repro/kernels/tiered_gather.py:277", "exact"),
    "frontier_read": ("src/repro_torch/kernels/csrc/frontier_gather.cu",
                      "src/repro/kernels/tiered_gather.py:277", "exact"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:74",
                        "allclose 3e-4 f32, 3e-2 bf16; each row within "
                        "1e-4 f32, 1e-2 bf16 of its norm"),
    "flash_combine": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention.py:30",
                      "allclose 1e-5 f32, 1e-2 bf16; the fused decode's "
                      "merge bit-equal to it"),
    "relation_attend": ("src/repro_torch/kernels/csrc/relation_attend.cu",
                        "none (R-GAT has no JAX original): models/rgat.py "
                        "_attend's gather, masked softmax and einsum",
                        "within 1e-5 of the float64 plain formulas by norm; "
                        "backward bit-equal over two runs"),
    "hgt_attend": ("src/repro_torch/kernels/csrc/hgt_attend.cu",
                   "none (HGT has no JAX original): kernels/hgt_attend.py "
                   "attend_ref and attend_backward_ref, the slot gathers, "
                   "scatter max and sums",
                   "within 1e-5 of the float64 plain formulas by norm; "
                   "bit-equal over two runs"),
    "gat_attend": ("src/repro_torch/kernels/csrc/gat_attend.cu",
                   "none (the JAX package leaves GAT's attention to XLA): "
                   "models/gnn.py GNN._layer's eager chain, now "
                   "kernels/gat_attend.py attend_ref",
                   "within 1e-5 of the float64 plain formulas and of the "
                   "float32 eager chain by norm; bit-equal over two runs"),
}


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--plant-fault", choices=sorted(FAULTS),
                        help="instead of the run, show that phase 2's "
                        "flash_attention gate rejects this planted fault")
    parser.add_argument("--segment-mean-variants", action="store_true",
                        help="instead of the run, time the segment_mean "
                        "kernel beside its SEGMENT_MEAN_VARIANTS")
    parser.add_argument("--flash-decode-variants", action="store_true",
                        help="instead of the run, time the fused split-KV "
                        "decode beside the two-launch path it replaced")
    parser.add_argument("--cache-variants", action="store_true",
                        help="instead of the run, time cache_access beside "
                        "its CACHE_VARIANTS")
    parser.add_argument("--cache-ab", nargs="?", const=".", metavar="TREE",
                        help="instead of the run, phase 2's cache rows and "
                        "phase 3 (also profiled) against the package of "
                        "TREE, a directory inside this checkout")
    parser.add_argument("--relation-attend", action="store_true",
                        help="instead of the run, build the kernels and run "
                        "phase 2's relation_attend rows alone")
    parser.add_argument("--hgt-attend", action="store_true",
                        help="instead of the run, build the kernels and run "
                        "phase 2's hgt_attend rows alone")
    parser.add_argument("--gat-attend", action="store_true",
                        help="instead of the run, build the kernels and run "
                        "phase 2's gat_attend rows alone")
    parser.add_argument("--tier-ab", nargs="?", const=".", metavar="TREE",
                        help="instead of the run, phases 3 and 4 against "
                        "the package of TREE, a directory inside this "
                        "checkout")
    args = parser.parse_args()
    # the run uses one card: keep only the first visible one, so that the
    # device count on the last line is the number of cards that did the work
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (visible.split(",")[0]
                                          if visible is not None else "0")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    picked = args.cache_ab if args.tier_ab is None else args.tier_ab
    tree = ROOT if picked is None else (ROOT / picked).resolve()
    if not tree.is_relative_to(ROOT):
        print(f"chip_smoke: {tree} is not inside {ROOT}", file=sys.stderr)
        return 2
    if not (tree / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch in {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree / "src"))
    import numpy as np

    check(torch.cuda.device_count() == 1,
          f"{torch.cuda.device_count()} cards visible after pinning to one")
    if args.plant_fault:
        return plant_fault(torch, args.plant_fault)
    if args.segment_mean_variants:
        return segment_mean_variants(torch)
    if args.flash_decode_variants:
        return flash_decode_variants(torch)
    if args.cache_variants:
        return cache_variants(torch, np)
    if args.cache_ab is not None:
        return cache_ab(torch, np, tree)
    if args.tier_ab is not None:
        return tier_ab(torch, np, tree)
    card_and_build(torch)
    if args.relation_attend:
        kernel_relation_attend(torch, Timer(torch), np)
        return 0
    if args.hgt_attend:
        kernel_hgt_attend(torch, Timer(torch), np)
        return 0
    if args.gat_attend:
        kernel_gat_attend(torch, Timer(torch), np)
        return 0
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    measured = {"segment_mean": kernel_segment_mean(torch, timer, gen),
                "tiered_gather": kernel_tiered_gather(torch, timer, gen),
                "store_fill": kernel_store_fill(torch, timer, gen),
                "cache_access": None, "cache_bucket": None,
                "tiered_gather_unique": kernel_tiered_gather_unique(
                    torch, timer, gen),
                "frontier_gather": kernel_frontier_gather(torch, timer, gen),
                "frontier_read": kernel_frontier_read(torch, timer, np),
                "flash_attention": kernel_flash_attention(torch, timer, gen),
                "flash_combine": kernel_flash_combine(torch, timer, gen),
                "relation_attend": kernel_relation_attend(torch, timer, np),
                "hgt_attend": kernel_hgt_attend(torch, timer, np),
                "gat_attend": kernel_gat_attend(torch, timer, np)}
    cache = {case: dict(zip(("cache_access", "cache_bucket"),
                            kernel_cache_access(torch, timer, np, **kw)))
             for case, kw in CACHE_ROWS}
    measured.update(cache["uniform_8192"])
    launch_floor = kernel_cache_bucket_rows(torch, timer, np)
    cache_bucket_limit(torch)
    del timer
    by_path = {"gids-device": main_path(torch, np)}
    by_path[MERGED_PLANE] = merged_topology_path(torch, np)
    torch.cuda.empty_cache()
    by_path.update(host_planes(torch, np))
    torch.cuda.empty_cache()
    by_path.update(resume_and_samplers(torch, np))
    torch.cuda.empty_cache()
    by_path.update(cluster_planes(torch, np))
    torch.cuda.empty_cache()
    by_path.update(observe_and_serve(torch, np))
    torch.cuda.empty_cache()
    lm_gate_f32(torch, np)
    torch.cuda.empty_cache()
    by_path[LM_PATH] = lm_serve_path(torch, np)
    torch.cuda.empty_cache()
    by_path.update(lm_families(torch, np))
    torch.cuda.empty_cache()
    by_path.update(lm_train(torch, np))
    torch.cuda.empty_cache()
    by_path.update(launch_and_distributed(torch, np))
    kernels = []
    for name, (source, replaces, parity) in SOURCES.items():
        m = measured[name]
        launches = {path: n[name] for path, n in by_path.items()
                    if name in PATH_KERNELS[path]}
        if name in ("cache_access", "cache_bucket"):
            window = cache["merged_window_28000"][name]
            extra = {"merged_window_ms": window["ms"],
                     "merged_window_bound_ms": window["bound_ms"],
                     "hot_4_sets_ms": cache["hot_4_sets"][name]["ms"],
                     "launch_floor_ms": launch_floor}
        else:
            extra = {k: v for k, v in m.items() if k not in SUMMARY_KEYS}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "parity": parity,
                        "launches": sum(launches.values()),
                        "launches_by_path": launches, **extra,
                        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": m["bound_by"],
                        "library_ms": m["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
