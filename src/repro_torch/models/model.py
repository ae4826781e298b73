"""Model API: the loss, and the step functions that the trainer, the
serving engine and the launchers call.

The port of the reference's ``repro.models.model``: ``make_forward``,
``make_prefill`` and ``make_serve_step`` return plain functions over
(params, batch), which callers run under ``torch.inference_mode()``;
``make_loss_fn`` and ``make_train_step`` are the training side.  PyTorch
runs eagerly, so there is nothing to jit.

Each of these has the reference's three branches: the decoder (batch
``{"tokens"}``), the vision model (``{"tokens", "image_embeds"}``, the
stub frontend's patch embeddings spliced in at ``cfg.frontend_offset``)
and the encoder-decoder (``{"frame_embeds", "tokens"}``; its serve step
reads the encoder's output as ``"enc_out"``).  Every config the port runs
also trains, under remat none, full or dots.

Each takes the reference's ``rules`` (``repro_torch.parallel``) at the
reference's position and hands it on as the reference does; on one card
nothing is sharded, so no layer reads it, and anything but None or a
``LogicalRules`` in its place raises (``takes_rules``).  :func:`input_specs`,
:func:`abstract_cache` and :func:`batch_logical` give a cell's inputs as
``meta`` tensors and their logical axes, for the dry run
(``repro_torch.launch.cellrun``).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.parallel.sharding import LogicalRules, takes_rules

from . import transformer as T
from .config import ModelConfig
from .transformer import torch_dtype

#: the adaptive chunk rule bounds each chunk's fp32 logits to this many
#: bytes (the reference's figure)
LOGITS_CHUNK_BYTES = 96 * 10**9


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

@takes_rules
def lm_loss(cfg: ModelConfig, logits: torch.Tensor, tokens: torch.Tensor,
            aux: torch.Tensor,
            rules: Optional[LogicalRules] = None) -> torch.Tensor:
    """Next-token cross-entropy (fp32) + MoE aux.  logits (B,S,V); the last
    position has no target and is masked."""
    B, S, V = logits.shape
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        dim=1).long()
    mask = torch.cat([torch.ones((B, S - 1), device=logits.device),
                      torch.zeros((B, 1), device=logits.device)], dim=1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = ((logz - gold) * mask).sum() / mask.sum()
    return nll + cfg.router_aux_coef * aux


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

@takes_rules
def make_forward(cfg: ModelConfig, rules: Optional[LogicalRules] = None
                 ) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """fwd(params, batch) -> (logits (B,S,V) fp32, aux).  The vision
    model's batch must hold ``image_embeds`` (a ``KeyError`` otherwise, as
    in the reference), the encoder-decoder's ``frame_embeds``."""
    T._check_supported(cfg)
    if cfg.is_encdec:
        def fwd(params, batch):
            return T.forward_encdec(cfg, params, batch["frame_embeds"],
                                    batch["tokens"], rules)
    elif cfg.frontend == "vision":
        def fwd(params, batch):
            return T.forward_lm(cfg, params, batch["tokens"], rules,
                                image_embeds=batch["image_embeds"])
    else:
        def fwd(params, batch):
            return T.forward_lm(cfg, params, batch["tokens"], rules)
    return fwd


@takes_rules
def make_prefill(cfg: ModelConfig, rules: Optional[LogicalRules] = None):
    """Full-sequence forward that returns the LAST position's logits
    (B, 1, V): the serving semantic.  The encoder-decoder encodes
    ``frame_embeds`` and runs the decoder over ``tokens``; the decoder
    reads what the batch holds through ``embed_inputs``."""
    T._check_supported(cfg)
    if cfg.is_encdec:
        def prefill(params, batch):
            enc = T.encode(cfg, params, batch["frame_embeds"], rules)
            x, _ = T._decoder_hidden(cfg, params, enc, batch["tokens"])
            return T._unembed(cfg, params, x[:, -1:, :])
        return prefill

    def prefill(params, batch):
        x, _ = T.forward_lm_hidden(cfg, params, batch, rules)
        return T._unembed(cfg, params, x[:, -1:, :])
    return prefill


@takes_rules
def make_serve_step(cfg: ModelConfig,
                    rules: Optional[LogicalRules] = None):
    """serve_step(params, cache, {"token": (B,1), "pos": int}) ->
    (logits (B,1,V), cache): one-token decode against the KV/state cache.
    The encoder-decoder's batch also holds the encoder's output,
    ``"enc_out"`` (B, S_enc, D)."""
    T._check_supported(cfg)
    if cfg.is_encdec:
        def serve_step(params, cache, batch):
            return T.decode_step_encdec(cfg, params, cache, batch["enc_out"],
                                        batch["token"], batch["pos"], rules)
        return serve_step

    def serve_step(params, cache, batch):
        return T.decode_step_lm(cfg, params, cache, batch["token"],
                                batch["pos"], rules)
    return serve_step


@takes_rules
def make_hidden_forward(cfg: ModelConfig,
                        rules: Optional[LogicalRules] = None):
    """fwd(params, batch) -> (hidden (B,S,D) after the final norm, aux)."""
    T._check_supported(cfg)
    if cfg.is_encdec:
        def fwd(params, batch):
            return T.forward_encdec_hidden(cfg, params, batch["frame_embeds"],
                                           batch["tokens"], rules)
        return fwd

    def fwd(params, batch):
        return T.forward_lm_hidden(cfg, params, batch, rules)
    return fwd


@takes_rules
def make_loss_fn(cfg: ModelConfig, rules: Optional[LogicalRules] = None,
                 seq_chunk: int = 0):
    """Chunked-vocab cross-entropy over the hidden states, the reference's:
    the unembed runs one sequence chunk at a time, so fp32 logits live for
    one chunk; ``seq_chunk`` 0 picks the chunk by the adaptive rule (the
    fewest chunks that keep each chunk's global fp32 logits under
    ``LOGITS_CHUNK_BYTES``).  The loss sums the masked nll of every chunk
    and divides by B·(S−1)."""
    hfwd = make_hidden_forward(cfg, rules)

    def loss_fn(params, batch):
        x, aux = hfwd(params, batch)
        tokens = batch["tokens"]
        B, S = tokens.shape
        V = cfg.vocab_size
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                            dim=1).long()
        nll_sum = torch.zeros((), device=x.device)
        if seq_chunk > 0:
            step = min(seq_chunk, S)
        else:
            n_chunks = max(1, -(-B * S * V * 4 // LOGITS_CHUNK_BYTES))
            step = max(-(-S // n_chunks), 1)
        for s0 in range(0, S, step):
            xe = x[:, s0: s0 + step]
            lg = torch.einsum("bsd,vd->bsv", xe, table.to(xe.dtype)).float()
            if cfg.final_softcap:
                lg = cfg.final_softcap * torch.tanh(lg / cfg.final_softcap)
            tg = targets[:, s0: s0 + step]
            logz = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, tg[..., None])[..., 0]
            nll = logz - gold
            if s0 + step >= S:   # mask the final position (no next token)
                c = tg.shape[1]  # the last chunk may be shorter than step
                nll = nll * torch.cat(
                    [torch.ones((B, c - 1), device=x.device),
                     torch.zeros((B, 1), device=x.device)], dim=1)
            nll_sum = nll_sum + nll.sum()
        loss = nll_sum / (B * (S - 1))
        return loss + cfg.router_aux_coef * aux

    return loss_fn


@takes_rules
def make_train_step(cfg: ModelConfig, optimizer,
                    rules: Optional[LogicalRules] = None):
    """Returns train_step(state, batch) -> (state, metrics): the loss and
    its gradients (autograd), then ``optimizer.apply``, which updates the
    state's tensors in place.  ``optimizer`` is a
    ``repro_torch.train.optimizer.Optimizer``; metrics are
    ``{"loss", "grad_norm", "step"}`` as 0-dim tensors."""
    # imported here: repro_torch.train imports this package
    from repro_torch.train.optimizer import global_norm

    loss_fn = make_loss_fn(cfg, rules)

    def train_step(state, batch):
        pairs = T.flatten(state.params)
        leaves = [p.requires_grad_() for _, p in pairs]
        loss = loss_fn(state.params, batch)
        grads = torch.autograd.grad(loss, leaves)
        grads = T.unflatten((path, g) for (path, _), g in zip(pairs, grads))
        with torch.no_grad():
            gnorm = global_norm(grads)
            new_state = optimizer.apply(state, grads, gnorm=gnorm)
        return new_state, {"loss": loss.detach(), "grad_norm": gnorm,
                           "step": new_state.step}

    return train_step



# ---------------------------------------------------------------------------
# Dry-run input specs (meta tensors: nothing is allocated)
# ---------------------------------------------------------------------------

def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                mode: str) -> dict[str, Any]:
    """Stand-ins for every model input of a (arch x shape) cell: ``meta``
    tensors of the reference's shapes and dtypes.

    mode: "train" | "prefill" | "decode".  Frontend stubs: vlm cells get
    precomputed patch embeddings, audio cells get frame embeddings (the
    conv/patch frontend is not modeled).  The decode position ``pos`` is a
    0-dim int32 stand-in, as in the reference; the port's serve step takes
    it as a host integer (the dry run passes one)."""
    B, S, D = global_batch, seq_len, cfg.d_model
    i32 = torch.int32
    dt = torch_dtype(cfg.dtype)
    if mode in ("train", "prefill"):
        if cfg.is_encdec:
            return {"frame_embeds": _meta((B, S, D), dt),
                    "tokens": _meta((B, S), i32)}
        if cfg.frontend == "vision":
            return {"tokens": _meta((B, S), i32),
                    "image_embeds": _meta((B, cfg.num_frontend_tokens, D),
                                          dt)}
        return {"tokens": _meta((B, S), i32)}
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r} (train, prefill or decode)")
    batch = {"token": _meta((B, 1), i32), "pos": _meta((), i32)}
    if cfg.is_encdec:
        # encoder ran at prefill; decode sees its output (standard 30 s
        # window = 1500 frames), while the self-attn cache spans seq_len.
        batch["enc_out"] = _meta((B, 1500, D), dt)
    return batch


def abstract_cache(cfg: ModelConfig, global_batch: int, seq_len: int):
    """:func:`~repro_torch.models.transformer.init_cache`'s tree as
    ``meta`` tensors."""
    return T.init_cache(cfg, global_batch, seq_len, device="meta")


def batch_logical(cfg: ModelConfig, mode: str) -> dict[str, tuple]:
    """Logical sharding axes for each input (matched to input_specs)."""
    if mode in ("train", "prefill"):
        out: dict[str, tuple] = {"tokens": ("batch", None)}
        if cfg.is_encdec:
            out["frame_embeds"] = ("batch", None, None)
        if cfg.frontend == "vision":
            out["image_embeds"] = ("batch", None, None)
        return out
    out = {"token": ("batch", None), "pos": ()}
    if cfg.is_encdec:
        out["enc_out"] = ("batch", None, None)
    return out
