"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The port serves the llama family, mamba2, hymba, the gemma family, the MoE
family (moonshot-v1-16b-a3b, mixtral-8x7b), llama-3.2-vision-11b and the
multi-codebook musicgen-medium; the other architectures of the JAX package
are listed in ROADMAP.md as still to be ported.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = ("mamba2-1.3b", "hymba-1.5b", "gemma3-1b", "llama3-8b", "gemma2-2b",
            "mixtral-8x7b", "moonshot-v1-16b-a3b", "llama-3.2-vision-11b",
            "musicgen-medium")

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE
