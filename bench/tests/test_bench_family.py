"""A configuration's model, graph and reference come from its family module
(`families/<name>.py`), found by name: the `gnn` family reproduces what the
harness made before families existed, a new family is added as files
alone, and a family with no file is refused."""
import hashlib
import json
import shutil

import numpy as np
import pytest
import torch

from bench import cell as cell_run
from bench import judge, spec
from bench import trace as trace_mod

from . import tiny

#: seed of the parity pin: over 32 signed bits, as the driver's are
SEED = 2**31 + 29
INPUTS = {"indptr": "8ff6629fd3236216", "indices": "f4944409e919bf0c",
          "features": "62f3fee8db4b9619", "labels": "981ae19e490f08ee",
          "seed_pool": "7114b442c4c24eb5"}
FIRST_IDS = {"seeds": "db619df0349daa59",
             "hop_nodes": ["a8039f764b0f9a39", "740129853de6c06a",
                           "8c782331c0161b94"],
             "all_nodes": "b5f6ec481589e476"}
SHARED_LEAVES = {"head.b": "a0b242390b2c1652", "head.w": "9ea866e975da745f",
                 "layer0.b": "b8f01b7d541e5eba",
                 "layer1.b": "b8f01b7d541e5eba",
                 "layer2.b": "b8f01b7d541e5eba"}
#: digests and the reference's three losses (float.hex) that the harness
#: gave at tiny.py's size on the CPU before the model-specific steps moved
#: into `families/gnn.py`
PIN = {
    "sage3-igbs.b1024": {
        "params": SHARED_LEAVES | {
            "layer0.w_nbr": "c310204d4e056f4d",
            "layer0.w_self": "1e3ccc2922b6cfd2",
            "layer1.w_nbr": "39717fb282b7a141",
            "layer1.w_self": "71a3cc1fde664a8c",
            "layer2.w_nbr": "a6fad3c49051ecc4",
            "layer2.w_self": "ead8e8ff55c78f83"},
        "ref_losses": ["0x1.9d13fc0000000p+0", "0x1.d5bc940000000p+0",
                       "0x1.7f98bc0000000p+0"]},
    "gat3-igbs.b1024": {
        "params": SHARED_LEAVES | {
            "layer0.attn_dst": "678f39eea060c138",
            "layer0.attn_src": "1f9053b8904dc388",
            "layer0.w_nbr": "26b1e7657c64241f",
            "layer0.w_self": "dbae192059dc34f1",
            "layer1.attn_dst": "d959e652ec398069",
            "layer1.attn_src": "16bde91b669bff80",
            "layer1.w_nbr": "e65a7ec55f1b5a26",
            "layer1.w_self": "ca4278fb4bf61e0c",
            "layer2.attn_dst": "4f57ba286732720c",
            "layer2.attn_src": "e50213a38b685b6d",
            "layer2.w_nbr": "2b8bb1d8ee89ef7d",
            "layer2.w_self": "8d4238928e4c88f2"},
        "ref_losses": ["0x1.b57ab60000000p+0", "0x1.b4624c0000000p+0",
                       "0x1.a3bf0a0000000p+0"]},
}


def digest(a) -> str:
    """sha256 of an array's dtype, shape and bytes, first 16 hex digits."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(PIN))
def test_gnn_family_reproduces_the_pinned_inputs_batch_and_losses(
        tmp_path, name):
    cell = tiny.tiny_cell(tmp_path, name)
    assert cell.family.__file__.endswith("families/gnn.py")
    cpu = torch.device("cpu")
    inp, _, first, _ = cell_run.setup(cell, SEED, cpu,
                                      trace_mod.Spans(False))
    assert {k: digest(getattr(inp, k)) for k in INPUTS} == INPUTS
    assert {f"{g}.{k}": digest(v) for g, grp in inp.params.items()
            for k, v in grp.items()} == PIN[name]["params"]
    b = first[0]
    assert {"seeds": digest(np.asarray(b["seeds"], np.int64)),
            "hop_nodes": [digest(np.asarray(h, np.int64))
                          for h in b["hop_nodes"]],
            "all_nodes": digest(np.asarray(b["all_nodes"], np.int64))
            } == FIRST_IDS
    ref = cell.family.follow(cell.config, inp, first, cpu)
    assert [v.hex() for v in ref["losses"]] == PIN[name]["ref_losses"]


def test_a_family_is_added_as_files_alone(tmp_path):
    """A copy of `gnn` under a new name, a configuration naming it and a
    cell: no file that was there changes, and the cell runs correct through
    the new module."""
    root, bench_dir = tiny.make_tree(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()
              and p.name != "BENCHMARK.json"}
    shutil.copy(bench_dir / "families" / "gnn.py",
                bench_dir / "families" / "toy.py")
    cfg = json.loads((bench_dir / "configs" / "sage3-igbs.json").read_text())
    cfg |= {"name": "toy3", "family": "toy"}
    (bench_dir / "configs" / "toy3.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    n_configs, n_cells = len(bench["configs"]), len(bench["workloads"])
    bench["configs"].append({
        "name": "toy3", "source": "https://arxiv.org/abs/2306.16384",
        "file": "bench/configs/toy3.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy3.b1024", "config": "toy3",
                               "traffic": "b1024", "chips": 1,
                               "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())
    old = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    assert bench["configs"][:n_configs] == old["configs"]
    assert bench["workloads"][:n_cells] == old["workloads"]

    cell = spec.load_cell("toy3.b1024", root=root, bench_dir=bench_dir)
    assert cell.family.__file__ == str(bench_dir / "families" / "toy.py")
    out = cell_run.run(cell, 2**31 + 7, 0.2, True, torch.device("cpu"), 0.0)
    assert out["checks"]["bad_sample_ids"]["value"] == 0
    assert judge.passed(out["checks"]), out["checks"]
    w = out["window"]
    assert w.step_flops == cell.family.step_matmul_flops(
        cell.config, cell.traffic["batch_size"]) > 0
    assert all(set(s.kernels) == {"segment_mean", "tiered_gather"}
               for s in w.steps)


@pytest.mark.parametrize("family", ["nope", "../judge"])
def test_a_family_with_no_file_is_refused(tmp_path, family):
    root, bench_dir = tiny.make_tree(tmp_path)
    path = bench_dir / "configs" / "sage3-igbs.json"
    path.write_text(json.dumps(json.loads(path.read_text())
                               | {"family": family}))
    with pytest.raises(ValueError, match="family"):
        spec.load_cell("sage3-igbs.b1024", root=root, bench_dir=bench_dir)
