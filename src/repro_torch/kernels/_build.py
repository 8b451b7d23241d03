"""Build the port's CUDA sources and load them through ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so

into `build/kernels/` at the repository root, at first use.  The file name
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded.  `build()` starts one nvcc per stale
source and waits for all of them; `library(name)` builds if needed and
loads.  Nothing here runs at import: the CPU tests import every module.

`LAUNCHES` counts kernel launches per wrapper: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show which kernels its
main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("segment_mean", "tiered_gather", "cache_access",
           "frontier_gather", "flash_attention", "relation_attend",
           "hgt_attend", "gat_attend")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = dict.fromkeys(
    ("segment_mean", "tiered_gather", "store_fill", "cache_bucket",
     "cache_access", "tiered_gather_unique", "frontier_gather",
     "frontier_read", "flash_attention", "flash_combine",
     "relation_attend_fwd", "relation_attend_bwd", "fold_scores_fwd",
     "fold_scores_bwd", "hgt_attend_fwd", "hgt_attend_bwd",
     "gat_attend_fwd", "gat_attend_bwd"), 0)

_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the port's "
            "CUDA kernels are built from source on the machine with the card")
    return found


def _lib_path(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every stale source among `names`, one nvcc each, all started
    together.  Returns nvcc's output per compiled source (the -Xptxas -v
    register and shared-memory report); raises if any compile fails."""
    jobs = []
    for name in names:
        src, out = _lib_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    logs, failed = {}, []
    for name, out, tmp, proc in jobs:
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)[1]))
        _libs[name] = lib
    return lib


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(library(lib_name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise on a refused launch: the C entry points return
    cudaGetLastError() right after launching."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous CUDA tensors on one device and nothing
    else; a wrapper calls this before it passes pointers."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
