"""`examples/quickstart_torch.py` on the CPU against the JAX package's
`examples/quickstart.py`: every line the two scripts print is equal, but
the wall-clock column of the observability section, which measures this
machine.  The port's trace also holds its own hot-path wall spans, which
the reference does not record: its event count is the reference's plus
those.  The port's script runs with JAX and the JAX package
unimportable."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
_BLOCK_JAX = ("import sys; sys.modules['jax'] = None; "
              "sys.modules['repro'] = None\n")


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu")


def _port(cwd: Path, *args: str) -> subprocess.Popen:
    code = _BLOCK_JAX + (
        "import runpy\n"
        f"sys.argv = ['quickstart_torch.py', *{list(args)!r}]\n"
        f"runpy.run_path({str(ROOT / 'examples' / 'quickstart_torch.py')!r},"
        " run_name='__main__')\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=cwd,
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _priced(text: str) -> list[str]:
    return [line for line in text.splitlines()
            if not line.rstrip().endswith("spans)")]


def _without_hot_path(text: str, trace: Path) -> tuple[str, int]:
    """`text` with the printed trace event count less the written trace's
    hot-path spans (category "hot_path"), and their number."""
    events = json.loads(trace.read_text())["traceEvents"]
    n = sum(1 for e in events if e.get("cat") == "hot_path")
    return re.sub(r"\((\d+) events;",
                  lambda m: f"({int(m.group(1)) - n} events;", text), n


def test_quickstart_twin_prints_the_reference_numbers(tmp_path):
    """Both scripts run side by side; every priced line (tier splits, prep
    and exposed prep, shard and host telemetry, migrations, the topology
    plane's hops, serving latencies, fault recovery, spans) is equal, and
    each writes a trace."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = subprocess.Popen([sys.executable,
                            str(ROOT / "examples" / "quickstart.py")],
                           cwd=tmp_path / "ref", env=_env(),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    port = _port(tmp_path / "port", "--device", "cpu")
    try:
        want, want_err = ref.communicate(timeout=600)
        got, got_err = port.communicate(timeout=600)
    finally:
        ref.kill()
        port.kill()
    assert ref.returncode == 0, want_err[-2000:]
    assert port.returncode == 0, got_err[-2000:]
    got, n_hot_path = _without_hot_path(got, tmp_path / "port" / "trace.json")
    assert n_hot_path > 0
    assert _priced(got) == _priced(want)
    assert len(_priced(got)) > 40
    walls = [line for line in got.splitlines() if line.rstrip()
             .endswith("spans)")]
    assert len(walls) == 2
    assert (tmp_path / "port" / "trace.json").stat().st_size > 0
    assert (tmp_path / "ref" / "trace.json").stat().st_size > 0


def test_quickstart_twin_defaults_to_the_card(tmp_path):
    """Without a card and without --device cpu the twin raises instead of
    running on the CPU."""
    code = _BLOCK_JAX + (
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "import runpy\n"
        "sys.argv = ['quickstart_torch.py']\n"
        f"runpy.run_path({str(ROOT / 'examples' / 'quickstart_torch.py')!r},"
        " run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""
