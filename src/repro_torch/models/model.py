"""Model API: the step builders the serving engine and launchers call.

The port of the reference's ``repro.models.model``, decoder branch:
``make_forward``, ``make_prefill`` and ``make_serve_step`` return plain
functions over (params, batch).  PyTorch runs eagerly, so there is nothing
to jit; callers run them under ``torch.inference_mode()``.

Left out, each for its slice (``ROADMAP.md``): ``lm_loss``,
``make_loss_fn``, ``make_train_step`` and ``make_hidden_forward``
(training); the encoder-decoder and vision branches; ``input_specs``,
``abstract_cache`` and ``batch_logical`` (the dry-run and the mesh).
"""
from __future__ import annotations

from typing import Callable

import torch

from . import transformer as T
from .config import ModelConfig


def make_forward(cfg: ModelConfig) -> Callable[..., tuple[torch.Tensor,
                                                          torch.Tensor]]:
    """fwd(params, {"tokens": (B,S)}) -> (logits (B,S,V) fp32, aux)."""
    T._check_supported(cfg)

    def fwd(params, batch):
        return T.forward_lm(cfg, params, batch["tokens"])
    return fwd


def make_prefill(cfg: ModelConfig):
    """Full-sequence forward that returns the LAST position's logits
    (B, 1, V): the serving semantic."""
    T._check_supported(cfg)

    def prefill(params, batch):
        x = T.embed_inputs(cfg, params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x = T._blocks(cfg, x, params["blocks"], positions)
        x = T._norm(cfg, x, params, "final")
        return T._unembed(cfg, params, x[:, -1:, :])
    return prefill


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, {"token": (B,1), "pos": int}) ->
    (logits (B,1,V), cache): one-token decode against the KV/state cache."""
    T._check_supported(cfg)

    def serve_step(params, cache, batch):
        return T.decode_step_lm(cfg, params, cache, batch["token"],
                                batch["pos"])
    return serve_step
