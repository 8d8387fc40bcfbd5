"""Assigned-architecture configs (one module per arch) + registry.

A copy of ``repro.configs`` as data: the same ids, ``ALIASES`` and
values.

Every config module exposes ``CONFIG`` (the exact assigned
architecture) and ``SMOKE`` (a reduced same-family config for CPU smoke
tests).  ``get_config(name)`` / ``get_smoke(name)`` look them up;
``ARCHS`` lists all ten assigned ids, and ``PORT_ARCHS`` the configs
only the port has (deepseek-v2-lite), which the lookups take too.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, SHAPES, ShapeConfig

ARCHS = [
    "granite_moe_3b_a800m",
    "qwen3_moe_235b_a22b",
    "qwen15_32b",
    "granite_3_2b",
    "granite_20b",
    "minicpm3_4b",
    "mamba2_2p7b",
    "whisper_base",
    "zamba2_1p2b",
    "internvl2_26b",
]

#: assigned ids as given (hyphenated) -> module name
ALIASES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen1.5-32b": "qwen15_32b",
    "granite-3-2b": "granite_3_2b",
    "granite-20b": "granite_20b",
    "minicpm3-4b": "minicpm3_4b",
    "mamba2-2.7b": "mamba2_2p7b",
    "whisper-base": "whisper_base",
    "zamba2-1.2b": "zamba2_1p2b",
    "internvl2-26b": "internvl2_26b",
}

#: configs with no twin in the reference
PORT_ARCHS = ["deepseek_v2_lite"]


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCHS + PORT_ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from "
                       f"{ARCHS + PORT_ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["ARCHS", "ALIASES", "PORT_ARCHS", "get_config", "get_smoke",
           "SHAPES", "ShapeConfig", "ModelConfig"]
