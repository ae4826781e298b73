"""The patterned decoder of the LM-family architectures: attention and
Mamba-1 sub-layers with dense MLPs, MoE MLPs or none.

The port of the reference's ``repro.models.transformer``.  Parameters are
the reference's nested dict with the same leaf names, shapes and dtypes:
per-block leaves keep their leading ``n_blocks`` dim, so a JAX parameter
tree converts leaf for leaf (``repro_torch.convert.params_from_jax``).  The
reference's ``lax.scan`` over blocks is a Python loop over layers, each
reading its slice of the stacked leaves (a view, no copy).

Remat: ``cfg.remat == "full"`` runs each block under
``torch.utils.checkpoint`` (its activations are recomputed in the
backward, as ``jax.checkpoint`` does); ``"dots"`` checkpoints it
selectively, saving the outputs of the products without batch dimensions
and recomputing the rest (the reference's
``dots_with_no_batch_dims_saveable``).  The reference's gradient barrier
is an XLA artifact and has no counterpart.  The MoE aux loss is summed as
the reference sums it: per block in pattern order, then over the blocks.

Left out, each for its slice (``ROADMAP.md``): the encoder-decoder and
its learned positions, the vision splice, logical sharding axes and
``abstract_params``.
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers as L
from .config import LayerSpec, ModelConfig
from .mamba import mamba_block, mamba_decode, mamba_param_shapes
from .moe import moe_block_sharded, moe_param_shapes

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    return _DTYPES[name]


class ParamDef(NamedTuple):
    shape: tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones
    dtype: str = "param"      # param (cfg.dtype) | float32


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return {
        "wq": ParamDef((D, H, dh)),
        "wk": ParamDef((D, KV, dh)),
        "wv": ParamDef((D, KV, dh)),
        "wo": ParamDef((H, dh, D)),
    }


def _mlp_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    D, F = cfg.d_model, cfg.d_ff
    defs = {"w_up": ParamDef((D, F)), "w_down": ParamDef((F, D))}
    if cfg.gated_mlp:
        defs["w_gate"] = ParamDef((D, F))
    return defs


def _norm_defs(cfg: ModelConfig, name: str) -> dict[str, ParamDef]:
    D = cfg.d_model
    if cfg.norm == "layer":
        return {f"{name}_scale": ParamDef((D,), "ones", "float32"),
                f"{name}_bias": ParamDef((D,), "zeros", "float32")}
    init = "zeros" if cfg.rms_plus_one else "ones"
    return {f"{name}_scale": ParamDef((D,), init, "float32")}


def _check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet, naming the slice that
    brings it: attention and mamba sub-layers with dense or MoE MLPs (or
    none) run."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder comes with the encdec slice")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend comes with the "
            f"vision slice")
    if not cfg.use_rope and cfg.max_learned_pos > 0:
        raise NotImplementedError(
            f"{cfg.name}: learned positions (pos_embed) come with the "
            f"encdec slice")
    for spec in cfg.pattern:
        if spec.kind not in ("attn", "mamba"):
            raise NotImplementedError(
                f"{cfg.name}: unknown sub-layer kind {spec.kind!r}")


_MAMBA_FP32 = ("A_log", "D", "dt_bias", "conv_b")
_MAMBA_ZEROS = ("dt_bias", "conv_b", "D")


def _mamba_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    shapes = mamba_param_shapes(cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                cfg.ssm_conv, cfg.dt_rank)
    return {k: ParamDef(shape, "zeros" if k in _MAMBA_ZEROS else "normal",
                        "float32" if k in _MAMBA_FP32 else "param")
            for k, shape in shapes.items()}


def _moe_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    shapes = moe_param_shapes(cfg.d_model, cfg.d_ff, cfg.n_experts,
                              cfg.gated_mlp)
    return {k: ParamDef(shape, "normal",
                        "float32" if k == "w_router" else "param")
            for k, shape in shapes.items()}


def _sub_defs(cfg: ModelConfig, spec: LayerSpec) -> dict[str, ParamDef]:
    defs: dict[str, ParamDef] = {}
    defs.update(_norm_defs(cfg, "ln1"))
    if spec.kind == "attn":
        defs.update(_attn_defs(cfg))
    else:
        defs.update(_mamba_defs(cfg))
    if cfg.post_norms:
        defs.update(_norm_defs(cfg, "post_ln1"))
    if spec.mlp == "dense":
        defs.update(_norm_defs(cfg, "ln2"))
        defs.update(_mlp_defs(cfg))
    elif spec.mlp == "moe":
        defs.update(_norm_defs(cfg, "ln2"))
        defs.update(_moe_defs(cfg))
    if cfg.post_norms and spec.mlp != "none":
        defs.update(_norm_defs(cfg, "post_ln2"))
    return defs


def _stack(defs: dict[str, ParamDef], n: int) -> dict[str, ParamDef]:
    return {k: ParamDef((n,) + d.shape, d.init, d.dtype)
            for k, d in defs.items()}


def param_defs(cfg: ModelConfig) -> dict[str, Any]:
    """The reference's parameter tree, as ParamDefs."""
    _check_supported(cfg)
    V, D = cfg.vocab_size, cfg.d_model
    defs: dict[str, Any] = {
        "embed": ParamDef((V, D)),
        "blocks": {f"sub{i}": _stack(_sub_defs(cfg, spec), cfg.n_blocks)
                   for i, spec in enumerate(cfg.pattern)},
    }
    defs.update(_norm_defs(cfg, "final"))
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((V, D))
    return defs


def flatten(tree: dict, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs of a nested dict in sorted-key order (the
    order ``jax.tree.flatten`` visits a dict), paths joined by ``/``."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.extend(flatten(v, path))
        else:
            out.append((path, v))
    return out


def unflatten(pairs) -> dict:
    """Inverse of :func:`flatten`."""
    tree: dict = {}
    for path, leaf in pairs:
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def _materialize(d: ParamDef, cfg: ModelConfig, gen: torch.Generator,
                 device: torch.device, stacked: bool) -> torch.Tensor:
    """One leaf.  A ``stacked`` leaf (leading ``n_blocks`` dim) is drawn
    one layer slice at a time into its final-dtype tensor, so the fp32
    draw never holds more than one layer (qwen3-moe-30b-a3b's whole
    w_up stack is 38.7 GB in fp32)."""
    dtype = torch.float32 if d.dtype == "float32" else torch_dtype(cfg.dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    scale = 1.0 / math.sqrt(max(fan_in, 1))

    def draw(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(scale)
    if not stacked:
        return draw(d.shape).to(dtype)
    out = torch.empty(d.shape, dtype=dtype, device=device)
    for i in range(d.shape[0]):
        out[i] = draw(d.shape[1:])
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> dict:
    """Random weights at the config's widths, by the reference's rules:
    ``normal · 1/√fan_in`` (fan_in = the second-to-last dim), zeros and
    ones for norms, fp32 norms and routers and the rest in ``cfg.dtype``.
    Drawn from ``generator`` (on ``device``) leaf by leaf in sorted-path
    order, a block leaf layer by layer; the numbers differ from JAX's at
    the same seed, so a test that needs the reference's weights converts
    them (``convert.params_from_jax``)."""
    dev = torch.device(device)
    return unflatten(
        (path, _materialize(d, cfg, generator, dev,
                            stacked=path.startswith("blocks/")))
        for path, d in flatten(param_defs(cfg)))


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, x, p, name):
    if cfg.norm == "layer":
        return L.layer_norm(x, p[f"{name}_scale"], p[f"{name}_bias"])
    return L.rms_norm(x, p[f"{name}_scale"], plus_one=cfg.rms_plus_one)


def _variant(cfg: ModelConfig, spec: LayerSpec,
             causal: bool = True) -> L.AttnVariant:
    return L.AttnVariant(kind=spec.attn, window=cfg.window,
                         softcap=cfg.attn_softcap, causal=causal)


def _apply_sub(cfg: ModelConfig, spec: LayerSpec, x, p, positions,
               causal: bool = True):
    """One sub-layer (token mixer: attention or mamba; then the MLP, dense
    or MoE, if any) with residuals.  Returns (x, aux): the MoE aux loss, 0
    without MoE."""
    aux = torch.zeros((), device=x.device)
    h = _norm(cfg, x, p, "ln1")
    if spec.kind == "attn":
        h = L.attention_block(h, p, positions, _variant(cfg, spec, causal),
                              cfg.rope_theta, use_rope=cfg.use_rope,
                              impl=cfg.attn_impl)
    else:
        h = mamba_block(h, p, use_kernel=cfg.use_mamba_kernel,
                        chunk=cfg.ssm_chunk)
    if cfg.post_norms:
        h = _norm(cfg, h, p, "post_ln1")
    x = x + h
    if spec.mlp != "none":
        h = _norm(cfg, x, p, "ln2")
        if spec.mlp == "moe":
            h, aux = moe_block_sharded(h, p, cfg)
        else:
            h = L.mlp_block(h, p, cfg.mlp_act)
        if cfg.post_norms:
            h = _norm(cfg, h, p, "post_ln2")
        x = x + h
    return x, aux


def _layer(block: dict, i: int) -> dict:
    """Block ``i``'s parameters: views into the stacked leaves."""
    return {k: v[i] for k, v in block.items()}


def _block_fn(cfg: ModelConfig, positions):
    """Block i: all sub-layers of the pattern, each with its parameters.
    Returns (x, the block's aux summed in pattern order)."""
    def fn(x, *subs):
        total = None
        for spec, p in zip(cfg.pattern, subs):
            x, aux = _apply_sub(cfg, spec, x, p, positions)
            total = aux if total is None else total + aux
        return x, total
    return fn


def _blocks(cfg: ModelConfig, x, blocks: dict, positions):
    """The blocks in order.  Each stacked leaf is unbound into its layers'
    slices once (views), so a backward gathers each leaf's gradient with
    one stack, not a zero-filled full-size tensor per layer.  Where a
    gradient is wanted and ``cfg.remat`` is ``"full"`` or ``"dots"``, each
    block runs under ``torch.utils.checkpoint``.  Returns (x, aux summed
    over the blocks)."""
    fn = _block_fn(cfg, positions)
    layers = [{k: v.unbind(0) for k, v in blocks[f"sub{j}"].items()}
              for j in range(len(cfg.pattern))]
    remat = _remat(cfg) if torch.is_grad_enabled() else None
    auxs = []
    for i in range(cfg.n_blocks):
        subs = [{k: v[i] for k, v in sub.items()} for sub in layers]
        if remat is not None:
            x, aux = checkpoint(fn, x, *subs, use_reentrant=False,
                                preserve_rng_state=False, **remat)
        else:
            x, aux = fn(x, *subs)
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products_without_batch(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: save what a product without batch dimensions
    returns, recompute everything else.  ``torch.einsum`` lowers a
    projection such as ``bsd,di->bsi`` to ``bmm`` over a batch of 1, and a
    product with batch dimensions (the attention's ``bhqd,bhkd``, the MoE's
    expert products ``ecd,edf``) to ``bmm`` over their product, so a
    ``bmm`` of batch 1 counts as a product without batch dimensions, as
    ``mm`` and ``addmm`` do."""
    if op in _PRODUCTS or (op is torch.ops.aten.bmm.default
                           and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig) -> Optional[dict]:
    """How blocks are recomputed in the backward: None (not at all, remat
    none), or the extra arguments of ``torch.utils.checkpoint`` (none for
    remat full; the selective policy's contexts for remat dots)."""
    if cfg.remat == "none":
        return None
    if cfg.remat == "full":
        return {}
    if cfg.remat == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts,
            _save_products_without_batch)}
    raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r} (none, full "
                     f"or dots)")


def forward_lm_hidden(cfg: ModelConfig, params, batch: dict
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward up to the final norm (no unembed): the chunked loss's input.
    Returns (hidden (B,S,D), aux scalar)."""
    x = embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _blocks(cfg, x, params["blocks"], positions)
    return _norm(cfg, x, params, "final"), aux


def embed_inputs(cfg: ModelConfig, params, batch: dict) -> torch.Tensor:
    """tokens -> (B, S, D) residual stream."""
    return L.embed(batch["tokens"], params["embed"], cfg.embed_scale)


def _unembed(cfg: ModelConfig, params, x) -> torch.Tensor:
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed(x, table, cfg.final_softcap)


def forward_lm(cfg: ModelConfig, params, tokens: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B,S,V) fp32, aux scalar).  The aux loss is
    the MoE routers'; a model without MoE has 0."""
    x, aux = forward_lm_hidden(cfg, params, {"tokens": tokens})
    return _unembed(cfg, params, x), aux


# ---------------------------------------------------------------------------
# KV / state caches + single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype: Optional[str] = None,
               device: str | torch.device = "cuda") -> dict:
    """The reference's cache tree, zeros with a leading ``n_blocks`` dim:
    ``{"sub<i>": {"k", "v"}}`` on attention sub-layers, each (n_blocks,
    batch, S_cache, KV, Dh) with S_cache = min(window, seq_len) on SWA
    layers; ``{"sub<i>": {"conv", "ssm"}}`` on mamba sub-layers, the conv
    window (n_blocks, batch, K-1, I) in the cache dtype and the state
    (n_blocks, batch, I, N) in fp32."""
    _check_supported(cfg)
    dt = torch_dtype(dtype or cfg.dtype)
    nb, KV, dh = cfg.n_blocks, cfg.n_kv_heads, cfg.head_dim_
    cache: dict[str, Any] = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.kind == "attn":
            sc = cfg.kv_cache_len(spec, seq_len)
            shapes = {"k": ((nb, batch, sc, KV, dh), dt),
                      "v": ((nb, batch, sc, KV, dh), dt)}
        else:
            I, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
            shapes = {"conv": ((nb, batch, K - 1, I), dt),
                      "ssm": ((nb, batch, I, N), torch.float32)}
        cache[f"sub{i}"] = {
            name: torch.zeros(shape, dtype=d, device=device)
            for name, (shape, d) in shapes.items()}
    return cache


def decode_step_lm(cfg: ModelConfig, params, cache, token: torch.Tensor,
                   pos: int) -> tuple[torch.Tensor, Any]:
    """One-token serve step: token (B, 1) at absolute position ``pos`` (a
    host integer).  Returns (logits (B,1,V), cache); the cache is updated
    in place."""
    x = L.embed(token, params["embed"], cfg.embed_scale)
    for i in range(cfg.n_blocks):
        for j, spec in enumerate(cfg.pattern):
            c = _layer(cache[f"sub{j}"], i)
            p = _layer(params["blocks"][f"sub{j}"], i)
            x = _decode_sub(cfg, spec, x, p, c, pos)
    x = _norm(cfg, x, params, "final")
    return _unembed(cfg, params, x), cache


def _decode_sub(cfg: ModelConfig, spec: LayerSpec, x, p, cache: dict,
                pos: int):
    """One sub-layer of the decode step (the reference's scan body).
    ``cache`` holds this layer's slices of the cache leaves (views), which
    are updated in place: k and v at the new position on an attention
    sub-layer, the new conv window and ssm state on a mamba sub-layer (the
    reference returns a new cache tree; the port writes into this one)."""
    h = _norm(cfg, x, p, "ln1")
    if spec.kind == "attn":
        h, _, _ = L.attention_decode(h, p, cache["k"], cache["v"], pos,
                                     _variant(cfg, spec), cfg.rope_theta,
                                     use_rope=cfg.use_rope)
    else:
        h, conv, ssm = mamba_decode(h, p, cache["conv"], cache["ssm"])
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(ssm)
    if cfg.post_norms:
        h = _norm(cfg, h, p, "post_ln1")
    x = x + h
    if spec.mlp != "none":
        h = _norm(cfg, x, p, "ln2")
        if spec.mlp == "moe":   # the decode step drops the aux loss
            h, _ = moe_block_sharded(h, p, cfg)
        else:
            h = L.mlp_block(h, p, cfg.mlp_act)
        if cfg.post_norms:
            h = _norm(cfg, h, p, "post_ln2")
        x = x + h
    return x
