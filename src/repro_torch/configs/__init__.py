"""Architecture registry, the port's subset of `repro.configs`: the four
dense architectures.  `get(name)` returns the full published config;
`get(name, reduced=True)` the smoke-test reduction (same family and
topology, tiny dims).  The other six wait for their families (ROADMAP.md
Queue 1 item 10).
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "llama4_maverick_400b_a17b",
    "arctic_480b",
    "minicpm_2b",
    "h2o_danube_1_8b",
    "qwen3_14b",
    "qwen2_1_5b",
    "internvl2_1b",
    "whisper_small",
    "recurrentgemma_2b",
    "mamba2_1_3b",
]
PORTED = ("minicpm_2b", "h2o_danube_1_8b", "qwen3_14b", "qwen2_1_5b")


def normalize(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get(name: str, reduced: bool = False):
    arch = normalize(name)
    if arch in ARCH_IDS and arch not in PORTED:
        raise NotImplementedError(
            f"config {arch!r} is not ported yet: its family waits for "
            f"ROADMAP.md Queue 1 item 10; ported: {list(PORTED)}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.reduced_config() if reduced else mod.config()
