"""The LM substrate of the port: configuration schema, the decoder
and its step builders (counterpart of ``repro.models``)."""
from .config import LayerSpec, ModelConfig
from .model import (lm_loss, make_forward, make_loss_fn, make_prefill,
                    make_serve_step, make_train_step)
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
    "param_defs",
]
