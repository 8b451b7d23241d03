"""Architecture registry, the port of `repro.configs`: one module per
assigned architecture.  `get(name)` returns the full published config;
`get(name, reduced=True)` the smoke-test reduction (same family and
topology, tiny dims).
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


def normalize(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get(name: str, reduced: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{normalize(name)}")
    return mod.reduced_config() if reduced else mod.config()


def all_configs(reduced: bool = False):
    return {a: get(a, reduced) for a in ARCH_IDS}
