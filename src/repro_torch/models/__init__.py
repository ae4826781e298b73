"""The LM substrate of the port: configuration schema, the decoder and the
encoder-decoder with their step functions, and the MoE layer (counterpart
of ``repro.models``)."""
from .config import LayerSpec, ModelConfig
from .model import (abstract_cache, batch_logical, input_specs, lm_loss,
                    make_forward, make_loss_fn, make_prefill, make_serve_step,
                    make_train_step)
from .moe import moe_block, moe_block_onehot, router_probs
from .transformer import (abstract_params, cache_logical, init_cache,
                          init_params, param_defs, param_logical)

__all__ = [
    "LayerSpec",
    "ModelConfig",
    "abstract_cache",
    "abstract_params",
    "batch_logical",
    "cache_logical",
    "init_cache",
    "init_params",
    "input_specs",
    "lm_loss",
    "make_forward",
    "make_loss_fn",
    "make_prefill",
    "make_serve_step",
    "make_train_step",
    "moe_block",
    "moe_block_onehot",
    "param_defs",
    "param_logical",
    "router_probs",
]
