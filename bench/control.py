"""The readings the limits of `correct` are set from, at a cell's own size.

    python3 -m bench.control --workload <cell> --seeds 1 2 3 [--control-seeds 3]

For each seed the program is set up and driven through its first steps as
a run does, and its numbers are compared with the reference's (the lower
readings).  For the first `--control-seeds` seeds two more runs stand in the
program's place, each compared with the reference by the same numbers (the
upper readings):

- `control`: the reference computed in TF32, the nearest precision below
  the configuration's float32;
- `half_batch`: the reference with half of each batch left out, the mean
  taken over the rest.

With `--witness`, every seed also reads `reordered`: the reference run on
the same batches summed in another order (the family's `reordered`; for
`gnn`, every row's sampled neighbours and their subtrees in reverse
order).  The step is the same sum; only float32's order of
additions changes, so its readings are what round-off alone gives, with no
program in the comparison.  It also reads the program and the float32
reference each against the reference in float64, nearer the exact step
than either.  Each reading names its worst leaves and the gap of every
leaf.

A step that returns its state unchanged reads about 1 by `grad_gap` and
`change_gap` without a run, and an altered answer fails `bad_feature_rows`
(limit 0).  One JSON line per seed, then the lower and upper reading of
each number.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path


def readings(cell, seed: int, device, planted: bool,
             witness: bool = False) -> dict:
    """{"program": gaps} for one seed, with "control" and "half_batch"
    where `planted` and "reordered" where `witness`."""
    import torch

    from . import cell as cell_run
    from . import judge
    from . import trace as trace_mod

    inp, prog, first, program = cell_run.setup(
        cell, seed, device, trace_mod.Spans(False))
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cfg, family = cell.config, cell.family
    params0 = judge.cpu_tree(inp.params)

    def run_ref(steps=first, **kw) -> dict:
        return judge.cpu_tree_all(family.follow(cfg, inp, steps, device,
                                                **kw))

    def as_program(r: dict) -> dict:
        return {"losses": r["losses"], "params1": r["params1"],
                "params_n": r["params"]}

    ref = run_ref()
    out = {"seed": seed,
           "program": judge.training_gaps(program, ref, params0, cfg["lr"])}
    if planted:
        for name, kw in (("control", {"tf32": True}),
                         ("half_batch", {"keep_seeds": 0.5})):
            out[name] = judge.training_gaps(as_program(run_ref(**kw)), ref,
                                            params0, cfg["lr"])
    if witness:
        out["reordered"] = judge.training_gaps(as_program(run_ref(
            [family.reordered(b, cfg) for b in first])), ref,
            params0, cfg["lr"])
        exact = run_ref(dtype=torch.float64)
        out["program_vs_f64"] = judge.training_gaps(program, exact, params0,
                                                    cfg["lr"])
        out["reference_vs_f64"] = judge.training_gaps(as_program(ref), exact,
                                                      params0, cfg["lr"])
    return out


def summary(rows: list[dict]) -> dict:
    """Per number: the largest program reading, the smallest reading of
    each planted run, and the largest of the witness."""
    from . import judge

    out = {}
    for gap in judge.GAPS:
        out[gap] = {"program_max": max(r["program"][gap] for r in rows)}
        for name, pick in (("control", min), ("half_batch", min),
                           ("reordered", max)):
            got = [r[name][gap] for r in rows if name in r]
            if got:
                out[gap][f"{name}_{pick.__name__}"] = pick(got)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "src"))
    import torch

    from . import spec
    if not torch.cuda.is_available():
        print("bench.control: no CUDA device is available", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    rows = []
    for i, seed in enumerate(args.seeds):
        rows.append(readings(cell, seed, torch.device("cuda", 0),
                             planted=i < args.control_seeds,
                             witness=args.witness))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"workload": cell.name, "summary": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
