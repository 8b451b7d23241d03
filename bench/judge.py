"""How `correct` is decided: every number compared with the reference, each
beside its limit from the configuration's `limits`.

- `bad_sample_ids`: ids of the checked batches (the first training steps
  and a sample of the window's steps drawn from the seed) that break what
  the sampler guarantees (the family's `bad_sample_ids`).  Limit 0.
- `bad_feature_rows`: rows of those batches' `Batch.features` whose
  checksum differs from the feature table's.  Limit 0.
- `nonfinite_losses`: steps of the window whose loss is not finite.
  Limit 0.
- `loss_gap`: the worst of the first steps' |loss - reference loss| over
  |reference loss|, the reference (the family's `follow`) following the
  same batches from the same initial parameters.  One step's reading under TF32 can fall to
  float32's own; the worst of three does not.
- `grad_gap`: the first step's gradient as SGD got it, (p0 - p1) / lr,
  against the reference's, read from its parameters the same way: per
  leaf the gap between the two norms, over the larger of the reference's
  norm of that leaf and of the median leaf; the median over the leaves.
- `change_gap`: the same for the parameters' change over the first steps,
  read before the next step moves them.
- `grad_gap_worst`, `change_gap_worst`: the same two at the worst leaf,
  which catches a fault confined to a few leaves (one leaf left unmoved,
  a wrong gradient in one layer) that the median does not see.

Where the program sums in another order than the reference, the gradient
numbers swing from seed to seed: now and then a ReLU unit within
round-off of zero falls on different sides in the two float32 runs, and
the leaves below it move by up to ~1e-4 while the loss barely does.  A
float64 witness finds the swing on either side, not in one of them
(PERF.md, limits of `correct`), so each configuration's limits are set
from its own readings on the card.

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of the last two (`reference.check.counted_leaves`).
"""
from __future__ import annotations

import math
import statistics

import torch

from .reference import check

#: the training step's numbers, compared once the sampled ids are sound
GAPS = ("loss_gap", "grad_gap", "change_gap", "grad_gap_worst",
        "change_gap_worst")
NUMBERS = ("bad_sample_ids", "bad_feature_rows", "nonfinite_losses") + GAPS


def training_gaps(program: dict, ref: dict, params0: dict,
                  lr: float) -> dict:
    """`loss_gap`, `grad_gap` and `change_gap` of a run against the
    reference's (or the control's) run of the same steps, at the median
    and at the worst leaf, with every leaf's gap (for `bench.control`).
    `program` holds "losses", "params1" (after the first step) and
    "params_n" (after the last checked step); `ref` is the family's
    `follow` result, on the host."""
    counted = check.counted_leaves(check.leaf_norms(ref["grads"]))
    grad = check.leaf_gaps(
        check.leaf_norms(check.sgd_gradient(params0, program["params1"], lr)),
        check.leaf_norms(check.sgd_gradient(params0, ref["params1"], lr)),
        counted)
    change = check.leaf_gaps(
        check.leaf_norms(check.difference(program["params_n"], params0)),
        check.leaf_norms(check.difference(ref["params"], params0)), counted)
    loss_gaps = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                 for a, b in zip(program["losses"], ref["losses"],
                                 strict=True)]
    worst_grad = max(grad, key=grad.get)
    worst_change = max(change, key=change.get)
    return {"loss_gap": max(loss_gaps), "loss_gaps": loss_gaps,
            "grad_gap": statistics.median(grad.values()),
            "change_gap": statistics.median(change.values()),
            "grad_gap_worst": grad[worst_grad],
            "change_gap_worst": change[worst_change],
            "grad_worst_leaf": ".".join(worst_grad),
            "change_worst_leaf": ".".join(worst_change),
            "grad_leaves": {".".join(k): v for k, v in grad.items()},
            "change_leaves": {".".join(k): v for k, v in change.items()}}


def cpu_tree(tree: dict) -> dict:
    return {g: {k: v.detach().to("cpu", torch.float64)
                for k, v in grp.items()} for g, grp in tree.items()}


def judge(cell, inputs, first: list[dict], sampled: list[dict],
          program: dict, nonfinite: int, device: torch.device) -> dict:
    """The compared numbers, each as {"value", "limit"}.  `first` and
    `sampled` hold the checked batches (the family's `kept` with
    "row_sums" and "col_sums", host arrays); `program` the first steps'
    losses and parameters (see `training_gaps`)."""
    config, family = cell.config, cell.family
    bad_ids = family.bad_sample_ids(config, cell.traffic, inputs,
                                    first + sampled)
    bad_rows = sum(check.bad_rows(inputs.features, b["all_nodes"],
                                  b["row_sums"], b["col_sums"])
                   for b in first + sampled)
    values = {"bad_sample_ids": bad_ids, "bad_feature_rows": bad_rows,
              "nonfinite_losses": nonfinite}
    if bad_ids == 0:
        ref = family.follow(config, inputs, first, device)
        gaps = training_gaps(program, cpu_tree_all(ref),
                             cpu_tree(inputs.params), config["lr"])
        values |= {k: gaps[k] for k in GAPS}
    else:   # blocks the reference cannot follow: nothing to compare
        values |= dict.fromkeys(GAPS)
    limits = config["limits"]
    # a number that is not finite has no JSON form: it reads as missing,
    # which fails like one over its limit
    return {k: {"value": (values[k] if values[k] is None
                          or math.isfinite(values[k]) else None),
                "limit": limits[k]} for k in NUMBERS}


def cpu_tree_all(ref: dict) -> dict:
    return {"losses": ref["losses"], "grads": cpu_tree(ref["grads"]),
            "params1": cpu_tree(ref["params1"]),
            "params": cpu_tree(ref["params"])}


def passed(checks: dict) -> bool:
    return all(c["value"] is not None and math.isfinite(c["value"])
               and c["value"] <= c["limit"] for c in checks.values())


def checksums(features: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row and per column, the int64 sum of the float32 words' bits,
    computed where the rows lie."""
    bits = features.view(torch.int32)
    return (torch.sum(bits, dim=1, dtype=torch.int64),
            torch.sum(bits, dim=0, dtype=torch.int64))


def nonfinite_count(losses: list[torch.Tensor]) -> int:
    if not losses:
        return 0
    return int((~torch.isfinite(torch.stack(losses))).sum())


def to_host(kept: dict) -> dict:
    out = dict(kept)
    out["row_sums"] = kept["row_sums"].cpu().numpy()
    out["col_sums"] = kept["col_sums"].cpu().numpy()
    return out

