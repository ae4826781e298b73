"""The LM substrate of the port: configuration schema, the decoder and the
encoder-decoder with their step functions, and the MoE layer (counterpart
of ``repro.models``)."""
from .config import LayerSpec, ModelConfig
from .model import (lm_loss, make_forward, make_loss_fn, make_prefill,
                    make_serve_step, make_train_step)
from .moe import moe_block, moe_block_onehot, router_probs
from .transformer import init_cache, init_params, param_defs

__all__ = [
    "LayerSpec",
    "ModelConfig",
    "init_cache",
    "init_params",
    "lm_loss",
    "make_forward",
    "make_loss_fn",
    "make_prefill",
    "make_serve_step",
    "make_train_step",
    "moe_block",
    "moe_block_onehot",
    "param_defs",
    "router_probs",
]
