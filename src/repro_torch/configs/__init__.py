"""Configurations the port runs (counterpart of ``repro.configs``).

``astro_stacking`` is the data-diffusion workload of slice 1.  The model
registry is the reference's, all ten configs: the four dense decoders of
slice 2, the Mamba-1 stack of slice 3 (falcon-mamba-7b), the MoE models of
slice 7 (qwen3-moe-30b-a3b, mixtral-8x22b and the hybrid
jamba-1.5-large-398b) and the encoder-decoder and vision model of slice 9
(whisper-base, llava-next-mistral-7b).
``--arch <id>`` resolves through :func:`get_config`; the dry run
(``repro_torch.launch.dryrun``) iterates :func:`cells`, the reference's
grid of architecture x input shape with its documented skips.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

from repro_torch.models.config import ModelConfig

from . import (falcon_mamba_7b, gemma2_27b, h2o_danube3_4b,
               jamba15_large_398b, llava_next_mistral_7b, mixtral_8x22b,
               nemotron4_15b, qwen3_moe_30b_a3b, starcoder2_15b, whisper_base)

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (starcoder2_15b, h2o_danube3_4b, gemma2_27b, nemotron4_15b,
              llava_next_mistral_7b, falcon_mamba_7b, qwen3_moe_30b_a3b,
              mixtral_8x22b, whisper_base, jamba15_large_398b)
}

ARCH_IDS = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.long_context:
        return "pure full-attention arch: long_500k needs sub-quadratic attention (DESIGN.md §4)"
    return None


def cells(include_skipped: bool = False
          ) -> Iterator[tuple[ModelConfig, ShapeSpec, Optional[str]]]:
    """All 40 (arch x shape) cells; skipped ones carry their reason."""
    for cfg in REGISTRY.values():
        for shape in SHAPES.values():
            reason = skip_reason(cfg, shape)
            if reason is None or include_skipped:
                yield cfg, shape, reason
