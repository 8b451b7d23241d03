"""Multi-pod dry-run on the meta device, the port of `repro.launch.dryrun`:
build every (architecture x input shape) cell on the production mesh, run
its step once on meta tensors under the counters of `launch.roofline`, and
write the memory and roofline terms per device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_1_5b \\
        --shape train_4k [--multi-pod] [--strategy fsdp_tp] \\
        [--override attn_impl='"flash_stub"'] [--tag T]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--skip-existing]

Nothing is allocated and no card is needed: the step runs on the meta
device, whose operations compute shapes only.  The step is the global one
(the whole batch on one abstract device); a per-device term is the global
count divided by the mesh's chip count, except the argument bytes, which
are exact from each argument's placement.  Memory per device:

    argument_bytes  sum over the step's arguments of bytes / the ways its
                    spec splits it
    output_bytes    what the step returns: its in-place updates (the alias
                    bytes, placed as their arguments) and its new tensors
    temp_bytes      the high-water of the storages the step allocated,
                    less its new outputs, over chips
    peak            argument + temp + output - alias

The port loops layers in Python, so the full-depth count is already exact;
`scan_ladder` and `extrapolated_cost` are kept from the reference (whose
HLO cost counts a scanned layer once) and give the same numbers.  There is
no `XLA_FLAGS` device count and no subprocess per cell: a meta step needs
neither.

Collective bytes per device are reckoned from the placements
(`collective_bytes`); see there.  Outputs one JSON per cell under
experiments/dryrun/.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import math
import sys
import time
from pathlib import Path

import torch

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun"


def _def_leaves(defs) -> list:
    from repro_torch.models.common import tree_map_defs
    out: list = []
    tree_map_defs(out.append, defs)
    return out


def active_param_count(model) -> int:
    """Per-token active parameters (routed experts count top_k / E)."""
    cfg = model.cfg
    total = 0
    for d in _def_leaves(model.param_defs()):
        n = math.prod(d.shape)
        if "expert" in d.axes and cfg.moe_experts:
            n = n * cfg.moe_top_k // cfg.moe_experts
        total += n
    return total


def analytic_attn_flops(cfg, kind: str, batch: int, seq: int,
                        chips: int) -> float:
    """Per-device FLOPs of flash attention, added where the step runs the
    `flash_stub` stand-in (which does none of them).

    fwd = 4*B*Sq*Skv*H*hd (scores + AV), halved for causal; train multiplies
    by 3.5 (a flash-2 backward is ~2.5x the forward with its recompute).
    """
    if cfg.family == "ssm":
        return 0.0
    n_attn, n_local = 0, 0
    for i in range(cfg.num_layers):
        if cfg.family == "hybrid":
            n_local += cfg.is_attn_layer(i)
        else:
            n_attn += 1
    H, hd = cfg.num_heads, cfg.hd
    if kind == "train":
        sq = skv = seq
        mult, causal = 3.5, True
    elif kind == "prefill":
        sq = skv = seq
        mult, causal = 1.0, True
    else:  # decode
        sq, skv = 1, seq
        mult, causal = 1.0, False
    per_layer = 4.0 * batch * sq * skv * H * hd
    if causal:
        per_layer *= 0.5
    total = per_layer * n_attn
    # hybrid local attention: window-limited keys
    if n_local:
        w = min(cfg.local_window, skv)
        total += 4.0 * batch * sq * w * H * hd * (0.5 if causal else 1.0) \
            * n_local
    if cfg.attn_window is not None and kind != "decode":
        # SWA caps the key range for the dense layers too
        w = min(cfg.attn_window, skv)
        total = 4.0 * batch * sq * w * H * hd * 0.5 * n_attn
    if cfg.family == "encdec":
        # encoder self-attn (bidirectional) + decoder cross-attn
        total += 4.0 * batch * cfg.encoder_seq ** 2 * H * hd \
            * cfg.encoder_layers
        total += 4.0 * batch * sq * cfg.encoder_seq * H * hd \
            * cfg.num_layers
    return total * mult / chips


def scan_ladder(cfg) -> tuple[dict, list[tuple[dict, int]]]:
    """The reference's depth-extrapolation plan:
        full = cost(A) + sum_i (G_i - 1) * (cost(B_i) - cost(A))
    where A has 1 group per stack, B_i 2 groups in stack i, and G_i is the
    full model's group count."""
    U = {"scan_unroll": True}
    if cfg.family == "encdec":
        A = {"num_layers": 1, "encoder_layers": 1, **U}
        return A, [({"num_layers": 2, "encoder_layers": 1, **U},
                    cfg.num_layers - 1),
                   ({"num_layers": 1, "encoder_layers": 2, **U},
                    cfg.encoder_layers - 1)]
    if cfg.family == "hybrid":
        k = cfg.hybrid_attn_every
        rem = cfg.num_layers % k
        groups = cfg.num_layers // k
        A = {"num_layers": k + rem, **U}
        return A, [({"num_layers": 2 * k + rem, **U}, groups - 1)]
    il = cfg.moe_interleave if cfg.moe_experts else 1
    groups = cfg.num_layers // il
    return {"num_layers": il, **U}, [({"num_layers": 2 * il, **U},
                                      groups - 1)]


def _leaves(tree) -> list:
    from repro_torch.launch.mesh import map_tree
    out: list = []
    map_tree(out.append, tree)
    return out


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    return math.prod(mesh.shape[a]
                     for a in ((entry,) if isinstance(entry, str) else entry))


def collective_bytes(cell, mesh, multi_pod: bool) -> dict:
    """Per-device bytes each collective moves in one step, reckoned from
    the params' placements (nothing here is measured):

      * all-gather: a weight split over batch axes of size g (fsdp_tp's
        "embed" and "expert_ffn" dims) is gathered once a pass,
        (g - 1) * shard bytes; a train step makes 2 passes (forward,
        backward) and 3 with remat (the recomputed forward);
      * reduce-scatter (train): the same weight's gradient, (g - 1) * shard;
      * all-reduce (train): a weight replicated over batch axes of size r
        sums its gradient, 2 (r - 1) / r * shard (a ring);
      * all-reduce (activations): a matrix whose contracted dim (second to
        last) is split over non-batch axes of size m leaves partial sums,
        2 (m - 1) / m * rows * out_cols * bytes a layer and pass, rows the
        tokens on one batch shard (for expert weights, tokens * top_k *
        capacity_factor over the expert split), out_cols its output dim
        over that dim's split;
      * all-to-all: an MoE layer whose experts are split e ways sends and
        returns the dispatched rows of a batch shard (tokens * top_k *
        capacity_factor over the batch split), 2 (e - 1) / e * rows *
        d_model * bytes a layer and pass.
    """
    from repro_torch.launch.mesh import batch_axes
    cfg, kind = cell.cfg, cell.kind
    ba = set(batch_axes(multi_pod))
    G = math.prod(mesh.shape[a] for a in ba)
    train = kind == "train"
    passes = (3 if cfg.remat else 2) if train else 1
    tokens = cell.batch * (cell.seq if kind != "decode" else 1)
    act = torch.empty((), dtype=cfg.compute_dtype).element_size()
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0,
           "all-to-all": 0.0}
    defs = _def_leaves(cell.model.param_defs())
    placed = _leaves(cell.abstract_args[0])
    experts = 1
    for d, p in zip(defs, placed, strict=True):
        spec = p.sharding.spec
        shard = math.prod(d.shape) * p.value.element_size() / mesh.split(spec)
        used = set(spec.axes())
        g = math.prod(mesh.shape[a] for a in used & ba)
        if g > 1:
            out["all-gather"] += passes * (g - 1) * shard
            if train:
                out["reduce-scatter"] += (g - 1) * shard
        r = math.prod(mesh.shape[a] for a in ba - used)
        if train and r > 1:
            out["all-reduce"] += 2 * (r - 1) / r * shard
        layers = d.shape[0] if d.axes and d.axes[0] == "layers" else 1
        matrix = len(d.shape) - (d.axes[0] == "layers") >= 2
        if not matrix:
            continue
        entries = list(spec) + [None] * (len(d.shape) - len(spec))
        rows = tokens / G
        if "expert" in d.axes:
            experts = _axis_size(mesh, entries[d.axes.index("expert")])
            rows = tokens * cfg.moe_top_k * cfg.moe_capacity_factor \
                / (G * experts)
        contracted = entries[-2]
        m_axes = () if contracted is None else tuple(
            a for a in ((contracted,) if isinstance(contracted, str)
                        else contracted) if a not in ba)
        m = math.prod(mesh.shape[a] for a in m_axes)
        if m > 1:
            cols = d.shape[-1] / _axis_size(mesh, entries[-1])
            out["all-reduce"] += passes * layers * 2 * (m - 1) / m \
                * rows * cols * act
    if cfg.moe_experts and experts > 1:
        n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
        rows = tokens * cfg.moe_top_k * cfg.moe_capacity_factor / G
        out["all-to-all"] = passes * n_moe * 2 * (experts - 1) / experts \
            * rows * cfg.d_model * act
    out["total"] = sum(out.values())
    return out


def _bytes_per_device(placed) -> float:
    return sum(p.value.numel() * p.value.element_size()
               / p.sharding.mesh.split(p.sharding.spec)
               for p in _leaves(placed))


def cost_cell(cell, mesh, multi_pod: bool) -> dict:
    """Run the cell's step once on the meta device under the counters and
    the reference's activation placements; per-device counts and memory."""
    from repro_torch.distributed.ctx import activation_sharding
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.specs import activation_specs
    chips = mesh.size
    args = cell.args()
    arg_storages = {id(t.untyped_storage()) for t in _leaves(args)
                    if isinstance(t, torch.Tensor)}
    specs = activation_specs(cell.cfg, mesh, multi_pod, batch=cell.batch,
                             kind=cell.kind,
                             expert_axis=cell.rules.get("expert") or "model")
    t0 = time.perf_counter()
    with activation_sharding(specs):
        out, c = rl.count(cell.step_fn, *args)
    count_s = time.perf_counter() - t0
    outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
    aliased = [t for t in outs if id(t.untyped_storage()) in arg_storages]
    new = sum(t.numel() * t.element_size() for t in outs
              if id(t.untyped_storage()) not in arg_storages)
    # an aliased output is placed as its argument
    placed = {id(p.value.untyped_storage()): p
              for a in cell.abstract_args for p in _leaves(a)
              if isinstance(p.value, torch.Tensor)}
    alias = _bytes_per_device([placed[id(t.untyped_storage())]
                               for t in aliased])
    by_arg = [_bytes_per_device(a) for a in cell.abstract_args]
    argument = sum(by_arg)
    temp = max(c.temp_peak_bytes - new, 0) / chips
    output = alias + new / chips
    return {
        "flops": c.flops / chips,
        "hbm": c.hbm_bytes / chips,
        "coll": collective_bytes(cell, mesh, multi_pod)["total"],
        "ops": c.ops,
        "count_s": count_s,
        "memory": {
            "argument_bytes": argument, "argument_bytes_by_arg": by_arg,
            "output_bytes": output,
            "temp_bytes": temp, "alias_bytes": alias,
            "peak_per_device_gib": (argument + temp + output - alias)
            / 2**30},
        "by_op_bytes": dict(sorted(c.by_op.items(), key=lambda kv: -kv[1])
                            [:12]),
    }


def extrapolated_cost(arch, shape, mesh, multi_pod, strategy, overrides,
                      base_cfg) -> dict:
    """The reference's ladder: per-device flops, bytes and collective bytes
    from the reduced-depth cells of `scan_ladder`."""
    from repro_torch.launch.specs import build_cell
    A_ov, Bs = scan_ladder(base_cfg)
    merged = dict(overrides or {})
    merged.pop("microbatches", None)

    def cost(ov):
        cell = build_cell(arch, shape, mesh, multi_pod=multi_pod,
                          strategy=strategy, overrides={**merged, **ov})
        c = cost_cell(cell, mesh, multi_pod)
        return {k: c[k] for k in ("flops", "hbm", "coll")}

    cost_a = cost(A_ov)
    total = dict(cost_a)
    for B_ov, mult in Bs:
        cost_b = cost(B_ov)
        for key in total:
            total[key] += mult * (cost_b[key] - cost_a[key])
    return total


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape: str, multi_pod: bool, *,
             strategy: str | None = None, overrides: dict | None = None,
             tag: str = "") -> dict:
    from repro_torch import configs
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import SHAPES, build_cell, cell_supported

    cfg = configs.get(arch)
    if overrides:
        cfg = dataclasses.replace(
            cfg, **{k: v for k, v in overrides.items()
                    if k != "microbatches"})
    ok, reason = cell_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name(multi_pod),
           "strategy": strategy, "tag": tag}
    if not ok:
        rec["status"] = reason
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, mesh, multi_pod=multi_pod,
                      strategy=strategy, overrides=overrides)
    build_s = time.perf_counter() - t0
    rec["strategy"] = strategy or ("fsdp_tp" if cfg.moe_experts else "tp")
    cost = cost_cell(cell, mesh, multi_pod)

    spec = SHAPES[shape]
    tokens = spec["batch"] * (spec["seq"] if cell.kind != "decode" else 1)
    n_active = active_param_count(cell.model)
    mult = 6 if cell.kind == "train" else 2
    model_flops = mult * n_active * tokens
    flops = cost["flops"]
    if cfg.attn_impl == "flash_stub":
        flops += analytic_attn_flops(cfg, cell.kind, spec["batch"],
                                     spec["seq"], chips)
    roof = rl.analyze(flops, cost["hbm"], cost["coll"],
                      model_flops=model_flops, chips=chips)
    rec.update({
        "status": "OK",
        "kind": cell.kind,
        "chips": chips,
        "build_s": build_s,
        "count_s": cost["count_s"],
        "memory": cost["memory"],
        "cost": {k: cost[k] for k in ("flops", "hbm", "coll", "ops")},
        "hbm_bytes_by_op": cost["by_op_bytes"],
        "collectives": collective_bytes(cell, mesh, multi_pod),
        "active_params": n_active,
        "tokens_per_step": tokens,
        "roofline": roof.to_dict(),
    })
    return rec


def cell_filename(arch, shape, multi_pod, tag="") -> str:
    suffix = f"_{tag}" if tag else ""
    return f"{arch}_{shape}_{mesh_name(multi_pod)}{suffix}.json"


def _summary(rec: dict) -> str:
    if rec.get("status") != "OK":
        return f"{rec['arch']} x {rec['shape']} ({rec['mesh']}): " \
            f"{rec['status']}"
    r = rec["roofline"]
    return (f"{rec['arch']} x {rec['shape']} ({rec['mesh']}): "
            f"bottleneck={r['bottleneck']} compute={r['compute_term']:.4f}s "
            f"memory={r['memory_term']:.4f}s "
            f"collective={r['collective_term']:.4f}s "
            f"peak={rec['memory']['peak_per_device_gib']:.3f}GiB "
            f"useful={r['useful_ratio']:.3f}")


def _write(rec: dict, multi_pod: bool, tag: str) -> Path:
    fn = OUT_DIR / cell_filename(rec["arch"], rec["shape"], multi_pod, tag)
    fn.write_text(json.dumps(rec, indent=2))
    return fn


def _one(arch, shape, multi_pod, strategy, overrides, tag) -> int:
    try:
        rec = run_cell(arch, shape, multi_pod, strategy=strategy,
                       overrides=overrides or None, tag=tag)
    except Exception as e:  # noqa: BLE001 — record the failure
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name(multi_pod),
               "status": f"FAIL: {type(e).__name__}: {e}"}
        print(rec["status"], file=sys.stderr)
        _write(rec, multi_pod, tag)
        return 1
    print(f"wrote {_write(rec, multi_pod, tag)}")
    print(_summary(rec))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (python literal)")
    ap.add_argument("--all", action="store_true",
                    help="sweep every cell")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    if args.all:
        from repro_torch import configs
        from repro_torch.launch.specs import SHAPES
        failures = []
        for multi_pod in (False, True):
            for arch in configs.ARCH_IDS:
                for shape in SHAPES:
                    fn = OUT_DIR / cell_filename(arch, shape, multi_pod)
                    if args.skip_existing and fn.exists():
                        ok = json.loads(fn.read_text()).get("status", "")
                        if ok == "OK" or ok.startswith("SKIP"):
                            continue
                    if _one(arch, shape, multi_pod, None, None, ""):
                        failures.append((arch, shape, multi_pod))
        print(f"sweep done; {len(failures)} failures: {failures}")
        return 1 if failures else 0

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v
    return _one(args.arch, args.shape, args.multi_pod, args.strategy,
                overrides, args.tag)


if __name__ == "__main__":
    sys.exit(main())
