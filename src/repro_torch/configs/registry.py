"""Architecture registry of the port: the architectures it serves so far.

One entry: the port's first slice serves ``internlm2-1.8b``.  The rest
of the JAX package's model zoo joins with the model-zoo item of
ROADMAP Queue 1.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCHES = {
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
}


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHES)}")
    mod = importlib.import_module(ARCHES[arch])
    return mod.SMOKE if smoke else mod.CONFIG


def all_archs() -> list[str]:
    return list(ARCHES)
