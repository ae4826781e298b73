"""Configurations the port runs (counterpart of ``repro.configs``).

``astro_stacking`` is the data-diffusion workload of slice 1.  The model
registry holds the four dense decoders of slice 2 and the Mamba-1 stack of
slice 3 (falcon-mamba-7b); the other architectures of the reference's
registry come with their slices (``ROADMAP.md``).
``--arch <id>`` resolves through :func:`get_config`.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (falcon_mamba_7b, gemma2_27b, h2o_danube3_4b, nemotron4_15b,
               starcoder2_15b)

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (starcoder2_15b, h2o_danube3_4b, gemma2_27b, nemotron4_15b,
              falcon_mamba_7b)
}

ARCH_IDS = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
