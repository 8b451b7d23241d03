"""Checkpointing with atomic commit and pipeline-state capture, the port of
`repro.train.checkpoint` for a tree on one device.

  * a tree is nested dicts, lists, tuples and NamedTuples (the optimizer
    states) of tensors; each leaf is written as one raw .npy file keyed by
    its path, in the format the JAX package writes for an unsharded array
    on one device, so either package restores the other's checkpoints: dict
    keys sorted, a NamedTuple's items keyed by field name in field order,
    list and tuple items by index, joined with "/",
    files `<key with . for />.0.npy`, the shard's `index` one `[null, null]`
    per dimension, bf16 stored as uint16 with `"bf16_as_u16": true`;
  * manifest.json records every leaf's shape and dtype plus the step and
    the caller's `extra` state (the loader's `state_dict()`, whose PCG64
    state is plain JSON integers).  A numpy array or scalar in `extra` (a
    sharded plane's placement table, the fault plane's EMAs) is written as
    ``extra/<n>.npy`` and stands in the manifest as ``{"__npy__": name}``
    (``"__npy_scalar__"`` for a scalar); `restore` puts it back, type,
    dtype and shape unchanged.  An `extra` without numpy values writes the
    manifest the JAX package writes;
  * writes go to ``step_XXXXXXXX.tmp/`` and one atomic rename publishes the
    checkpoint, so a crash mid-write never corrupts the latest commit; the
    last 3 commits are kept.

`restore(..., shardings=)` is the reference's elastic restore: each leaf
given a `NamedSharding` lands on its mesh's device as a DTensor over the
mesh's `DeviceMesh`, its placements those of the spec, so a checkpoint
written on one topology restores onto whatever mesh the restarted job has.
A spec that would split a leaf across devices raises: this process holds
each leaf whole.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

KEEP = 3


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    """Leaves by path, in the JAX package's order: dict keys sorted, a
    NamedTuple's fields by name in field order, list and tuple items by
    index."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif _is_namedtuple(tree):
        items = ((f, getattr(tree, f)) for f in tree._fields)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(like, flat: dict[str, Any], prefix: str = ""):
    """`like`'s structure with each leaf taken from `flat` by path."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, key(k)) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), flat, key(f))
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, flat, key(i))
                          for i, v in enumerate(like))
    return flat[prefix]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


_NPY, _NPY_SCALAR = "__npy__", "__npy_scalar__"


def _encode_extra(state, out: Path, n: list[int]):
    """`state` with each numpy array or scalar saved under `out` and
    replaced by its marker."""
    if isinstance(state, dict):
        return {k: _encode_extra(v, out, n) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_encode_extra(v, out, n) for v in state]
    if isinstance(state, (np.ndarray, np.generic)):
        out.mkdir(exist_ok=True)
        np.save(out / f"{n[0]}.npy", np.asarray(state))
        marker = _NPY if isinstance(state, np.ndarray) else _NPY_SCALAR
        name = f"{out.name}/{n[0]}.npy"
        n[0] += 1
        return {marker: name}
    return state


def _decode_extra(state, d: Path):
    """`_encode_extra` undone: each marker replaced by its array or
    scalar."""
    if isinstance(state, dict):
        if state.keys() == {_NPY}:
            return np.load(d / state[_NPY])
        if state.keys() == {_NPY_SCALAR}:
            return np.load(d / state[_NPY_SCALAR])[()]
        return {k: _decode_extra(v, d) for k, v in state.items()}
    if isinstance(state, list):
        return [_decode_extra(v, d) for v in state]
    return state


def save(ckpt_dir: str | Path, step: int, tree: Any,
         extra_state: dict | None = None) -> Path:
    """Write a checkpoint; returns the committed directory."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    final = ckpt_dir / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "leaves": {},
                "extra": _encode_extra(extra_state or {}, tmp / "extra", [0])}
    for key, leaf in _flatten(tree).items():
        t = torch.as_tensor(leaf)
        entry = {"shape": list(t.shape), "dtype": _dtype_name(t.dtype),
                 "shards": []}
        fn = f"{key.replace('/', '.')}.0.npy"
        np.save(tmp / fn, _to_numpy(t))
        if t.dtype == torch.bfloat16:
            entry["bf16_as_u16"] = True
        entry["shards"].append({"file": fn,
                                "index": [[None, None]] * t.dim()})
        manifest["leaves"][key] = entry
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic commit
    for old in sorted(ckpt_dir.glob("step_[0-9]*"))[:-KEEP]:
        if old.is_dir() and not old.name.endswith(".tmp"):
            shutil.rmtree(old)
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(int(p.name.split("_")[1]) for p in
                   ckpt_dir.glob("step_[0-9]*") if p.is_dir()
                   and not p.name.endswith(".tmp"))
    return steps[-1] if steps else None


def _load_leaf(d: Path, entry: dict) -> torch.Tensor:
    """One leaf's global array, assembled from its shards (one for the
    port's checkpoints; the JAX package may have written several)."""
    bf16 = entry.get("bf16_as_u16", False)
    out = np.zeros(tuple(entry["shape"]),
                   dtype=np.uint16 if bf16 else entry["dtype"])
    for sh in entry["shards"]:
        data = np.load(d / sh["file"])
        if sh["index"] is None:
            out = data
        else:
            out[tuple(slice(a, b) for a, b in sh["index"])] = data
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(out)


def _place(key: str, t: torch.Tensor, sharding, meshes: dict):
    """Leaf `key` as a DTensor over its sharding's mesh, placed by its
    spec; the mesh's DeviceMesh is made once a restore."""
    from torch.distributed.tensor import DTensor
    mesh, spec = sharding.mesh, sharding.spec
    if len(spec) > t.dim():
        raise ValueError(f"{key}: spec {spec} has more entries than the "
                         f"leaf's {t.dim()} dimensions")
    ways = mesh.split(spec)
    if ways > 1 or not mesh.devices:
        raise ValueError(f"{key}: spec {spec} on mesh {mesh.shape} would "
                         f"split the leaf {ways} ways across devices this "
                         f"process does not hold")
    if mesh not in meshes:
        meshes[mesh] = mesh.device_mesh()
    return DTensor.from_local(t.to(mesh.devices[0]), meshes[mesh],
                              mesh.placements(spec), run_check=False)


def restore(ckpt_dir: str | Path, step: int, like: Any,
            shardings: Any | None = None) -> tuple[Any, dict]:
    """Restore into the structure of `like` (nested dicts, lists, tuples
    and NamedTuples of tensors): each leaf lands on the device and in the
    dtype of its `like` leaf, or, where `shardings` (a tree of the port's
    `NamedSharding`, complete or partial) gives it one, on that sharding's
    mesh.  Returns (tree, extra_state)."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat_like = _flatten(like)
    flat_shard = _flatten(shardings) if shardings is not None else {}
    rebuilt, meshes = {}, {}
    for key, want in flat_like.items():
        want = torch.as_tensor(want)
        leaf = _load_leaf(d, manifest["leaves"][key])
        if flat_shard.get(key) is not None:
            rebuilt[key] = _place(key, leaf.to(dtype=want.dtype),
                                  flat_shard[key], meshes)
        else:
            rebuilt[key] = leaf.to(want.device, want.dtype)
    return _unflatten(like, rebuilt), _decode_extra(
        manifest.get("extra", {}), d)
