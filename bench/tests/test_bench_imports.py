"""What `python3 -m bench.run` loads holds neither JAX nor the JAX package
(top-level names compared whole: `repro_torch` begins with `repro`), nor
anything of `benchmarks/`; the reference loads nothing of `repro_torch`;
only a family module and the reference know the model."""
import ast
import json
import subprocess
import sys

from bench import spec

PROBE = """
import json, sys
sys.path.insert(0, {src!r})
import importlib
for m in {mods!r}:
    importlib.import_module(m)
for name in {metrics!r}:
    importlib.import_module("bench.spec").load_reader(name)
for name in {families!r}:
    importlib.import_module("bench.spec").load_family(name)
print(json.dumps({{m: getattr(sys.modules[m], "__file__", None) or ""
                  for m in list(sys.modules)}}))
"""

RUN_MODULES = ["bench.run", "bench.cell", "bench.judge", "bench.trace",
               "bench.inputs", "bench.rmat", "bench.spec", "bench.yardstick",
               "bench.control"]
#: every file of the reference, a family's added one too
REFERENCE_MODULES = sorted(
    f"bench.reference.{p.stem}"
    for p in (spec.BENCH_DIR / "reference").glob("*.py")
    if p.stem != "__init__")
FAMILIES = sorted(p.stem for p in (spec.BENCH_DIR / "families").glob("*.py"))
#: files that hold no step of a particular model: every file of the
#: harness but the families, the reference and `yardstick.py` (whose
#: `step_matmul_flops` counts the `gnn` family's models)
GENERIC_FILES = sorted(
    p for p in [*spec.BENCH_DIR.glob("*.py"),
                *(spec.BENCH_DIR / "metrics").glob("*.py")]
    if p.name != "yardstick.py")


def _loaded(mods, metrics=(), families=()):
    code = PROBE.format(src=str(spec.ROOT / "src"), mods=mods,
                        metrics=list(metrics), families=list(families))
    got = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert got.returncode == 0, got.stderr
    return json.loads(got.stdout.splitlines()[-1])


def test_run_loads_neither_jax_nor_the_jax_package():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    loaded = _loaded(RUN_MODULES, [m["name"] for m in bench["per_layer"]],
                     FAMILIES)
    tops = {m.split(".")[0] for m in loaded}
    assert "repro_torch" in tops                 # the measured package
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    benchmarks = str(spec.ROOT / "benchmarks")
    assert not [m for m, f in loaded.items() if f.startswith(benchmarks)]


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded(REFERENCE_MODULES)
    tops = {m.split(".")[0] for m in loaded}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    ours = {m for m in loaded if m.split(".")[0] == "bench"}
    assert ours <= {"bench", "bench.reference", *REFERENCE_MODULES}


def test_reference_sources_import_only_torch_numpy_and_the_standard_library():
    allowed = {"torch", "numpy", "math", "statistics", "typing",
               "__future__"}
    for path in (spec.BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:          # within the reference package
                    continue
                names = [node.module]
            else:
                continue
            assert {n.split(".")[0] for n in names} <= allowed, (path, names)


def test_reference_modules_are_every_file_of_the_reference():
    assert "bench.reference.gnn" in REFERENCE_MODULES
    assert "bench.reference.check" in REFERENCE_MODULES
    assert FAMILIES == sorted(FAMILIES) and "gnn" in FAMILIES


def test_generic_files_branch_on_no_model_and_import_no_model():
    """No comparison with a model's name (`== "sage"`, `!= "gat"`, `in
    (...)`) and no import of `repro_torch.models` outside the families and
    the reference; docstrings do not count."""
    models = {"sage", "gat", "gcn"}
    assert len(GENERIC_FILES) > 20
    for path in GENERIC_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Compare):
                names = {n.value for n in ast.walk(node)
                         if isinstance(n, ast.Constant)}
                assert not names & models, (path, node.lineno)
            elif isinstance(node, ast.Import):
                assert not any(a.name.startswith("repro_torch.models")
                               for a in node.names), path
            elif isinstance(node, ast.ImportFrom):
                module = node.module or ""
                assert not module.startswith("repro_torch.models"), path
                assert not (module == "repro_torch" and "models" in {
                    a.name for a in node.names}), path
