"""What `python3 -m bench.run` loads holds neither JAX nor the JAX package
(top-level names compared whole: `repro_torch` begins with `repro`), nor
anything of `benchmarks/`; the reference loads nothing of `repro_torch`."""
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
print(json.dumps({{m: getattr(sys.modules[m], "__file__", None) or ""
                  for m in list(sys.modules)}}))
"""

RUN_MODULES = ["bench.run", "bench.cell", "bench.judge", "bench.trace",
               "bench.inputs", "bench.rmat", "bench.spec", "bench.yardstick",
               "bench.control"]
REFERENCE_MODULES = ["bench.reference.gnn", "bench.reference.check",
                     "bench.reference.follow"]


def _loaded(mods, metrics=()):
    code = PROBE.format(src=str(spec.ROOT / "src"), mods=mods,
                        metrics=list(metrics))
    got = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert got.returncode == 0, got.stderr
    return json.loads(got.stdout.splitlines()[-1])


def test_run_loads_neither_jax_nor_the_jax_package():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    loaded = _loaded(RUN_MODULES, [m["name"] for m in bench["per_layer"]])
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
