"""The patterned decoder of the LM-family architectures (attention and
Mamba-1 sub-layers with dense MLPs, MoE MLPs or none) and the
encoder-decoder (whisper).

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
``dots_with_no_batch_dims_saveable``).  The same remat applies to the
encoder's blocks and to the encoder-decoder's decoder blocks.  The
reference's gradient barrier is an XLA artifact and has no counterpart.
The MoE aux loss is summed as the reference sums it: per block in pattern
order, then over the blocks.

The modality frontends are stubs, as in the reference: the vision model
takes precomputed patch embeddings (``image_embeds``, spliced into the
token embeddings at ``cfg.frontend_offset``), the encoder-decoder
precomputed frame embeddings (``frame_embeds``), and a decoder can take
its input embeddings whole (``inputs_embeds``).

Each leaf carries the reference's logical sharding axes
(``ParamDef.logical``, read by :func:`param_logical`; the cache's by
:func:`cache_logical`), and :func:`abstract_params` gives the tree as
``meta`` tensors, which the dry run (``repro_torch.launch.cellrun``) runs
the step on without allocating.  The entry points take the reference's
``rules`` argument: on one card nothing is sharded, so it is not read
(``takes_rules`` checks its type).
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers as L
from repro_torch.parallel.sharding import LogicalRules, takes_rules

from .config import LayerSpec, ModelConfig
from .mamba import MAMBA_LOGICAL, mamba_block, mamba_decode, mamba_param_shapes
from .moe import MOE_LOGICAL, moe_block_sharded, moe_param_shapes

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    return _DTYPES[name]


class ParamDef(NamedTuple):
    shape: tuple[int, ...]
    logical: tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones
    dtype: str = "param"      # param (cfg.dtype) | float32


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return {
        "wq": ParamDef((D, H, dh), ("fsdp", "tp", None)),
        "wk": ParamDef((D, KV, dh), ("fsdp", "tp", None)),
        "wv": ParamDef((D, KV, dh), ("fsdp", "tp", None)),
        "wo": ParamDef((H, dh, D), ("tp", None, "fsdp")),
    }


def _mlp_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    D, F = cfg.d_model, cfg.d_ff
    defs = {"w_up": ParamDef((D, F), ("fsdp", "tp")),
            "w_down": ParamDef((F, D), ("tp", "fsdp"))}
    if cfg.gated_mlp:
        defs["w_gate"] = ParamDef((D, F), ("fsdp", "tp"))
    return defs


def _norm_defs(cfg: ModelConfig, name: str) -> dict[str, ParamDef]:
    D = cfg.d_model
    if cfg.norm == "layer":
        return {f"{name}_scale": ParamDef((D,), (None,), "ones", "float32"),
                f"{name}_bias": ParamDef((D,), (None,), "zeros", "float32")}
    init = "zeros" if cfg.rms_plus_one else "ones"
    return {f"{name}_scale": ParamDef((D,), (None,), init, "float32")}


def _check_supported(cfg: ModelConfig) -> None:
    """Raise for a sub-layer kind the model does not know (attention and
    mamba sub-layers, with dense or MoE MLPs or none, run)."""
    for spec in cfg.pattern:
        if spec.kind not in ("attn", "mamba"):
            raise NotImplementedError(
                f"{cfg.name}: unknown sub-layer kind {spec.kind!r}")


_MAMBA_FP32 = ("A_log", "D", "dt_bias", "conv_b")
_MAMBA_ZEROS = ("dt_bias", "conv_b", "D")


def _mamba_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    shapes = mamba_param_shapes(cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                cfg.ssm_conv, cfg.dt_rank)
    return {k: ParamDef(shape, MAMBA_LOGICAL[k],
                        "zeros" if k in _MAMBA_ZEROS else "normal",
                        "float32" if k in _MAMBA_FP32 else "param")
            for k, shape in shapes.items()}


def _moe_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    shapes = moe_param_shapes(cfg.d_model, cfg.d_ff, cfg.n_experts,
                              cfg.gated_mlp)
    return {k: ParamDef(shape, MOE_LOGICAL[k], "normal",
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
    return {k: ParamDef((n,) + d.shape, ("layers",) + d.logical, d.init,
                        d.dtype)
            for k, d in defs.items()}


def param_defs(cfg: ModelConfig) -> dict[str, Any]:
    """The reference's parameter tree, as ParamDefs."""
    _check_supported(cfg)
    V, D = cfg.vocab_size, cfg.d_model
    defs: dict[str, Any] = {
        "embed": ParamDef((V, D), ("tp", "fsdp")),
        "blocks": {f"sub{i}": _stack(_sub_defs(cfg, spec), cfg.n_blocks)
                   for i, spec in enumerate(cfg.pattern)},
    }
    defs.update(_norm_defs(cfg, "final"))
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((V, D), ("tp", "fsdp"))
    if not cfg.use_rope and cfg.max_learned_pos > 0:
        defs["pos_embed"] = ParamDef((cfg.max_learned_pos, D),
                                     (None, "fsdp"))
    if cfg.is_encdec:
        enc_sub: dict[str, ParamDef] = {}
        enc_sub.update(_norm_defs(cfg, "ln1"))
        enc_sub.update(_attn_defs(cfg))
        enc_sub.update(_norm_defs(cfg, "ln2"))
        enc_sub.update(_mlp_defs(cfg))
        defs["encoder"] = {"sub0": _stack(enc_sub, cfg.enc_layers)}
        defs.update({f"enc_{k}": v
                     for k, v in _norm_defs(cfg, "final").items()})
        cross: dict[str, ParamDef] = {}
        cross.update(_norm_defs(cfg, "ln_x"))
        cross.update({f"x_{k}": v for k, v in _attn_defs(cfg).items()})
        defs["cross"] = {"sub0": _stack(cross, cfg.n_layers)}
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
    dtype = _leaf_dtype(d, cfg)
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


#: the subtrees whose leaves carry a leading layer dim
_STACKED_ROOTS = ("blocks", "encoder", "cross")


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
                            stacked=path.split("/")[0] in _STACKED_ROOTS))
        for path, d in flatten(param_defs(cfg)))


def _leaf_dtype(d: ParamDef, cfg: ModelConfig) -> torch.dtype:
    return torch.float32 if d.dtype == "float32" else torch_dtype(cfg.dtype)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as ``meta`` tensors of the leaves' shapes and
    dtypes: what the dry run runs a step on (nothing is allocated)."""
    return unflatten((path, torch.empty(d.shape, dtype=_leaf_dtype(d, cfg),
                                        device="meta"))
                     for path, d in flatten(param_defs(cfg)))


def param_logical(cfg: ModelConfig) -> dict:
    """Each parameter leaf's logical sharding axes, in the tree's shape."""
    return unflatten((path, d.logical)
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


def _block_fn(cfg: ModelConfig, positions, causal: bool = True):
    """Block i: all sub-layers of the pattern, each with its parameters.
    Returns (x, the block's aux summed in pattern order)."""
    def fn(x, *subs):
        total = None
        for spec, p in zip(cfg.pattern, subs):
            x, aux = _apply_sub(cfg, spec, x, p, positions, causal)
            total = aux if total is None else total + aux
        return x, total
    return fn


def _run_layers(cfg: ModelConfig, fn, x, stacks: list[dict], n: int):
    """``x, aux = fn(x, *layer_params)`` for each of ``n`` layers, where
    layer i's parameters are the i-th slices of each of ``stacks`` (dicts
    of stacked leaves).  Each stacked leaf is unbound into its layers'
    slices once (views), so a backward gathers each leaf's gradient with
    one stack, not a zero-filled full-size tensor per layer.  Where a
    gradient is wanted and ``cfg.remat`` is ``"full"`` or ``"dots"``, each
    layer runs under ``torch.utils.checkpoint``.  Returns (x, aux summed
    over the layers)."""
    layers = [{k: v.unbind(0) for k, v in stack.items()} for stack in stacks]
    remat = _remat(cfg) if torch.is_grad_enabled() else None
    auxs = []
    for i in range(n):
        subs = [{k: v[i] for k, v in sub.items()} for sub in layers]
        if remat is not None:
            x, aux = checkpoint(fn, x, *subs, use_reentrant=False,
                                preserve_rng_state=False, **remat)
        else:
            x, aux = fn(x, *subs)
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


def _blocks(cfg: ModelConfig, x, blocks: dict, positions,
            causal: bool = True):
    """The blocks in order (``causal=False``: the encoder's unmasked
    self-attention).  Returns (x, aux summed over the blocks)."""
    return _run_layers(cfg, _block_fn(cfg, positions, causal), x,
                       [blocks[f"sub{j}"] for j in range(len(cfg.pattern))],
                       cfg.n_blocks)


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


@takes_rules
def forward_lm_hidden(cfg: ModelConfig, params, batch: dict,
                      rules: Optional[LogicalRules] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward up to the final norm (no unembed): the chunked loss's input.
    Returns (hidden (B,S,D), aux scalar)."""
    x = embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _blocks(cfg, x, params["blocks"], positions)
    return _norm(cfg, x, params, "final"), aux


@takes_rules
def embed_inputs(cfg: ModelConfig, params, batch: dict,
                 rules: Optional[LogicalRules] = None) -> torch.Tensor:
    """tokens (+ the stub frontend's embeddings) -> (B, S, D) residual
    stream: ``inputs_embeds`` (B, S, D) replace the token embeddings;
    ``image_embeds`` (B, T, D) overwrite T of them from
    ``cfg.frontend_offset``; a learned position table is added."""
    if "inputs_embeds" in batch:
        x = batch["inputs_embeds"].to(torch_dtype(cfg.dtype))
    else:
        x = L.embed(batch["tokens"], params["embed"], cfg.embed_scale)
        if "image_embeds" in batch:
            x = _splice(x, batch["image_embeds"].to(x.dtype),
                        cfg.frontend_offset)
    if "pos_embed" in params:
        x = x + params["pos_embed"][: x.shape[1]][None].to(x.dtype)
    return x


def _splice(x: torch.Tensor, img: torch.Tensor, offset: int) -> torch.Tensor:
    """``img`` (B, T, D) written over ``x`` (B, S, D) from position
    ``offset``, as ``jax.lax.dynamic_update_slice`` writes it: the start is
    clamped into [0, S − T], so the image always fits (at S − T when
    S < offset + T), and an image longer than S is refused.  Built with
    ``torch.cat``, not written in place, so autograd keeps the token
    embeddings it saved."""
    s, t = x.shape[1], img.shape[1]
    if t > s or img.shape[0] != x.shape[0] or img.shape[2] != x.shape[2]:
        raise TypeError(f"image_embeds of shape {tuple(img.shape)} do not "
                        f"fit the token embeddings' {tuple(x.shape)}")
    start = min(max(offset, 0), s - t)
    return torch.cat([x[:, :start], img, x[:, start + t:]], dim=1)


def _unembed(cfg: ModelConfig, params, x) -> torch.Tensor:
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed(x, table, cfg.final_softcap)


@takes_rules
def forward_lm(cfg: ModelConfig, params, tokens: torch.Tensor,
               rules: Optional[LogicalRules] = None,
               image_embeds: Optional[torch.Tensor] = None,
               inputs_embeds: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B,S,V) fp32, aux scalar).  The aux loss is
    the MoE routers'; a model without MoE has 0.  ``image_embeds`` (B, T,
    D) are the vision stub's patch embeddings, ``inputs_embeds`` (B, S, D)
    replace the token embeddings (see :func:`embed_inputs`)."""
    batch = {"tokens": tokens}
    if image_embeds is not None:
        batch["image_embeds"] = image_embeds
    if inputs_embeds is not None:
        batch["inputs_embeds"] = inputs_embeds
    x, aux = forward_lm_hidden(cfg, params, batch)
    return _unembed(cfg, params, x), aux


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper): the frontend is a stub, the encoder takes
# precomputed frame embeddings
# ---------------------------------------------------------------------------

def _sinusoid(S: int, D: int, device=None) -> torch.Tensor:
    """(S, D) fp32 sinusoid positions: sin then cos of pos / 10000^(2i/D)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None]
    angle = pos / torch.pow(10_000.0, 2 * dim / D)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


@takes_rules
def encode(cfg: ModelConfig, params, frame_embeds: torch.Tensor,
           rules: Optional[LogicalRules] = None) -> torch.Tensor:
    """frame_embeds (B, S_enc, D) -> the encoder's output (B, S_enc, D):
    sinusoid positions, then ``cfg.enc_layers`` blocks of unmasked
    self-attention (through ``cfg.attn_impl``) and a dense MLP, then the
    encoder's final norm."""
    x = frame_embeds.to(torch_dtype(cfg.dtype))
    S = x.shape[1]
    x = x + _sinusoid(S, cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(S, device=x.device)
    ecfg = cfg.with_(pattern=(LayerSpec(kind="attn", attn="full",
                                        mlp="dense"),),
                     n_layers=cfg.enc_layers)
    x, _ = _blocks(ecfg, x, params["encoder"], positions, causal=False)
    return _norm(cfg, x, params, "enc_final")


def _encdec_block_fn(cfg: ModelConfig, enc: torch.Tensor, positions):
    """One decoder layer in whisper's order: causal self-attention,
    cross-attention to ``enc``, then the MLP, each with its residual.
    Returns (x, 0): the decoder has no aux loss."""
    spec = cfg.pattern[0]

    def fn(x, self_p, cross_p):
        h = _norm(cfg, x, self_p, "ln1")
        x = x + L.attention_block(h, self_p, positions, _variant(cfg, spec),
                                  cfg.rope_theta, use_rope=cfg.use_rope,
                                  impl=cfg.attn_impl)
        x = x + L.cross_attention_block(_norm(cfg, x, cross_p, "ln_x"), enc,
                                        _cross_params(cross_p))
        h = _norm(cfg, x, self_p, "ln2")
        x = x + L.mlp_block(h, self_p, cfg.mlp_act)
        return x, torch.zeros((), device=x.device)
    return fn


def _cross_params(cross_p: dict) -> dict:
    """A layer's cross-attention weights under the attention's names."""
    return {k[2:]: v for k, v in cross_p.items() if k.startswith("x_")}


@takes_rules
def forward_encdec_hidden(cfg: ModelConfig, params, frame_embeds,
                          dec_tokens, rules: Optional[LogicalRules] = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoder, then the decoder up to its final norm (the chunked loss's
    input).  Returns (hidden (B,S_dec,D), aux 0)."""
    enc = encode(cfg, params, frame_embeds)
    return _decoder_hidden(cfg, params, enc, dec_tokens)


def _decoder_hidden(cfg: ModelConfig, params, enc, dec_tokens):
    """The decoder over ``dec_tokens`` against the encoder's output ``enc``,
    up to its final norm: (hidden (B,S_dec,D), aux 0)."""
    x = embed_inputs(cfg, params, {"tokens": dec_tokens})
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _run_layers(cfg, _encdec_block_fn(cfg, enc, positions), x,
                         [params["blocks"]["sub0"], params["cross"]["sub0"]],
                         cfg.n_layers)
    return _norm(cfg, x, params, "final"), aux


@takes_rules
def decode_train(cfg: ModelConfig, params, enc: torch.Tensor,
                 dec_tokens: torch.Tensor,
                 rules: Optional[LogicalRules] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The decoder over ``dec_tokens`` (B, S_dec) against the encoder's
    output: (logits (B,S_dec,V) fp32, aux 0)."""
    x, aux = _decoder_hidden(cfg, params, enc, dec_tokens)
    return _unembed(cfg, params, x), aux


@takes_rules
def forward_encdec(cfg: ModelConfig, params, frame_embeds: torch.Tensor,
                   dec_tokens: torch.Tensor,
                   rules: Optional[LogicalRules] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """frame_embeds (B, S_enc, D), dec_tokens (B, S_dec) -> (logits
    (B,S_dec,V) fp32, aux 0)."""
    return decode_train(cfg, params, encode(cfg, params, frame_embeds),
                        dec_tokens)


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


def cache_logical(cfg: ModelConfig) -> dict:
    """Logical axes tree matching :func:`init_cache`'s output."""
    out: dict[str, Any] = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.kind == "attn":
            out[f"sub{i}"] = {"k": (None, "batch", "kv_seq", None, None),
                              "v": (None, "batch", "kv_seq", None, None)}
        else:
            out[f"sub{i}"] = {"conv": (None, "batch", None, "tp"),
                              "ssm": (None, "batch", "tp", None)}
    return out


@takes_rules
def decode_step_lm(cfg: ModelConfig, params, cache, token: torch.Tensor,
                   pos: int, rules: Optional[LogicalRules] = None
                   ) -> tuple[torch.Tensor, Any]:
    """One-token serve step: token (B, 1) at absolute position ``pos`` (a
    host integer).  Returns (logits (B,1,V), cache); the cache is updated
    in place."""
    x = _embed_at(cfg, params, token, pos)
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


def _embed_at(cfg: ModelConfig, params, token: torch.Tensor, pos: int):
    """The token's embedding plus, with a learned position table, its row
    ``pos`` (clamped into the table, as ``dynamic_slice`` clamps)."""
    x = L.embed(token, params["embed"], cfg.embed_scale)
    if "pos_embed" in params:
        table = params["pos_embed"]
        row = min(max(pos, 0), table.shape[0] - 1)
        x = x + table[row: row + 1][None].to(x.dtype)
    return x


@takes_rules
def decode_step_encdec(cfg: ModelConfig, params, cache, enc: torch.Tensor,
                       token: torch.Tensor, pos: int,
                       rules: Optional[LogicalRules] = None
                       ) -> tuple[torch.Tensor, Any]:
    """Whisper's one-token decode step: token (B, 1) at ``pos`` (a host
    integer), the self-attention cache updated in place, cross-attention
    to the encoder's output ``enc`` (B, S_enc, D).  Returns (logits
    (B,1,V), cache)."""
    x = _embed_at(cfg, params, token, pos)
    spec = cfg.pattern[0]
    for i in range(cfg.n_layers):
        self_p = _layer(params["blocks"]["sub0"], i)
        cross_p = _layer(params["cross"]["sub0"], i)
        c = _layer(cache["sub0"], i)
        h = _norm(cfg, x, self_p, "ln1")
        h, _, _ = L.attention_decode(h, self_p, c["k"], c["v"], pos,
                                     _variant(cfg, spec), cfg.rope_theta,
                                     use_rope=cfg.use_rope)
        x = x + h
        x = x + L.cross_attention_block(_norm(cfg, x, cross_p, "ln_x"), enc,
                                        _cross_params(cross_p))
        h = _norm(cfg, x, self_p, "ln2")
        x = x + L.mlp_block(h, self_p, cfg.mlp_act)
    x = _norm(cfg, x, params, "final")
    return _unembed(cfg, params, x), cache
