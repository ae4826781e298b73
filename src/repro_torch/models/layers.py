"""Model building blocks: norms, RoPE, GQA attention variants, MLPs.

The port of the reference's ``repro.models.layers``: pure functions over
explicit parameter dicts, with the reference's arithmetic (fp32 variance and
softmax, the rescale in the compute dtype) so the two agree on the same
weights.  Attention supports full and sliding-window (SWA) masks, logit
softcapping (gemma2) and GQA with any kv-head count; ``impl="flash"`` runs
the hand-written CUDA flash-attention kernel on the card.

Cross-attention (the encoder-decoder's) takes the plain attention, as the
reference's does: its call sites never hand it ``cfg.attn_impl``.  Left
out: the ``rules``/``shard`` arguments (one card, no mesh).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm: the variance of ``x*x`` accumulated in fp32, the rescale in
    the compute dtype (no full-tensor upcast), as the reference does."""
    dt = x.dtype
    var = x.square().sum(-1, keepdim=True, dtype=torch.float32) / x.shape[-1]
    inv = torch.rsqrt(var + eps)
    w = (1.0 + scale.float()) if plus_one else scale.float()
    return x * (inv * w).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the reference's pairwise pre-sum in the compute dtype
    before the fp32 mean."""
    dt = x.dtype
    d = x.shape[-1]
    pair = x.reshape(x.shape[:-1] + (d // 2, 2))
    s2 = pair[..., 0] + pair[..., 1]
    mu = (s2.sum(-1, dtype=torch.float32) / d)[..., None]
    sq = (x.square().sum(-1, dtype=torch.float32) / d)[..., None]
    var = torch.clamp_min(sq - mu * mu, 0.0)
    inv = torch.rsqrt(var + eps)
    xc = x - mu.to(dt)
    return xc * (inv * scale.float()).to(dt) + bias.to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python base: no host-to-device copy (which would synchronise)
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) integers."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)              # (Dh/2,)
    angles = positions[..., None].float() * freqs              # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

NEG_INF = -2.0 ** 30  # large-negative that survives bf16 softmax


@dataclasses.dataclass(frozen=True)
class AttnVariant:
    kind: str = "full"            # full | swa
    window: int = 0               # swa window (keys kept: window, inclusive)
    softcap: float = 0.0          # gemma2 attn logit softcap
    causal: bool = True           # False for encoder self-attention


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                   variant: AttnVariant) -> torch.Tensor:
    """(Sq, Sk) boolean validity mask from absolute positions."""
    ok = torch.ones(q_pos.shape[-1:] + k_pos.shape[-1:], dtype=torch.bool,
                    device=q_pos.device)
    if variant.causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if variant.kind == "swa" and variant.window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - variant.window
    return ok


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor,
                  variant: AttnVariant,
                  k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference GQA attention (fp32 softmax).  q (B,Sq,H,Dh), k/v
    (B,Sk,KV,Dh); ``k_valid`` (B,Sk) is extra validity.  Returns
    (B,Sq,H,Dh)."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) / math.sqrt(dh)
    logits = _softcap(logits, variant.softcap)
    mask = attention_mask(q_pos, k_pos, variant)               # (Sq, Sk)
    if k_valid is not None:
        mask = mask[None] & k_valid[:, None, :]                # (B, Sq, Sk)
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    else:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor,
                      variant: AttnVariant,
                      block_k: int = 1024) -> torch.Tensor:
    """Online-softmax attention chunked over keys: the peak intermediate is
    (B,H,Sq,block_k) instead of (B,H,Sq,Sk)."""
    b, sq, h, dh = q.shape
    kv, sk = k.shape[2], k.shape[1]
    g = h // kv
    bk = min(block_k, sk)
    pad = (-sk) % bk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=2**30)
    nk = (sk + pad) // bk
    qg = q.reshape(b, sq, kv, g, dh).float() / math.sqrt(dh)
    kc = k.reshape(b, nk, bk, kv, dh)
    vc = v.reshape(b, nk, bk, kv, dh)
    kp = k_pos.reshape(nk, bk)
    m = torch.full((b, kv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, kv, g, sq), device=q.device)
    acc = torch.zeros((b, kv, g, sq, dh), device=q.device)
    for i in range(nk):
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kc[:, i].float())
        s = _softcap(s, variant.softcap)
        kpi = kp[i]
        ok = torch.ones((sq, bk), dtype=torch.bool, device=q.device)
        if variant.causal:
            ok &= kpi[None, :] <= q_pos[:, None]
        if variant.kind == "swa" and variant.window > 0:
            ok &= kpi[None, :] > q_pos[:, None] - variant.window
        ok &= (kpi < 2**30)[None, :]
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, vc[:, i].float())
        m = m_new
    out = acc / torch.where(l > 0, l, 1.0)[..., None]
    out = out.reshape(b, kv * g, sq, dh).movedim(1, 2)
    return out.to(q.dtype)


def attention_block(x: torch.Tensor, p: dict, positions: torch.Tensor,
                    variant: AttnVariant, rope_theta: float,
                    use_rope: bool = True,
                    impl: str = "blocked") -> torch.Tensor:
    """x (B,S,D); p holds wq, wk, wv, wo.  ``impl`` is ref, blocked or
    flash (the hand-written kernel on the card; with gradients, its
    backward is the plain version's)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if impl == "flash":
        # the kernel is forward only: where a gradient is wanted, take the
        # op whose backward is the plain version's (the one place where
        # the port's routing departs from the reference's model)
        wants_grad = torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad)
        op = (fa_ops.flash_attention_with_ref_vjp if wants_grad
              else fa_ops.flash_attention)
        out = op(q, k, v, causal=variant.causal,
                 window=variant.window if variant.kind == "swa" else 0,
                 softcap=variant.softcap)
    elif impl == "blocked":
        out = blocked_attention(q, k, v, positions, positions, variant)
    elif impl == "ref":
        out = gqa_attention(q, k, v, positions, positions, variant)
    else:
        raise ValueError(f"unknown attention impl {impl!r} "
                         f"(ref, blocked or flash)")
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def attention_decode(x: torch.Tensor, p: dict, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, variant: AttnVariant,
                     rope_theta: float, use_rope: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x (B,1,D); cache_k/v (B,S_cache,KV,Dh); ``pos``
    the absolute position (a host integer).

    The caches are updated in place (the reference returns new arrays; the
    port saves the copy) and returned.  SWA layers use the cache as a ring
    buffer of size min(window, S_cache)."""
    s_cache = cache_k.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if use_rope:
        pos_arr = torch.full((1,), pos, device=x.device)  # no host copy
        q = apply_rope(q, pos_arr, rope_theta)
        k = apply_rope(k, pos_arr, rope_theta)
    # ring placement: identity while pos < S_cache, wraps afterwards
    slot = pos % s_cache
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    # absolute position of every cache slot under ring placement
    idx = torch.arange(s_cache, device=x.device)
    wraps = pos // s_cache
    k_pos = torch.where(idx <= slot, wraps * s_cache + idx,
                        (wraps - 1) * s_cache + idx)
    valid = (k_pos >= 0) & (k_pos <= pos)
    if variant.kind == "swa" and variant.window > 0:
        valid &= k_pos > pos - variant.window
    kv, dh = k.shape[2], k.shape[3]
    h = q.shape[2]
    qg = q.reshape(q.shape[0], 1, kv, h // kv, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          cache_k.float()) / math.sqrt(dh)
    logits = _softcap(logits, variant.softcap)
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, cache_v.float())
    out = out.reshape(x.shape[0], 1, h, dh).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return y, cache_k, cache_v


def cross_attention_block(x: torch.Tensor, enc: torch.Tensor, p: dict,
                          impl: str = "blocked") -> torch.Tensor:
    """Decoder states x (B,Sq,D) attend to the encoder's output enc
    (B,Sk,D), unmasked; p holds wq, wk, wv, wo.  Blocked attention for
    Sq > 1 under ``impl="blocked"`` (the default every caller takes), else
    the plain GQA attention (one decode position)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", enc, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc, p["wv"].to(x.dtype))
    sq, sk = x.shape[1], enc.shape[1]
    q_pos = torch.arange(sq, device=x.device)
    k_pos = torch.arange(sk, device=x.device)
    variant = AttnVariant(kind="full", causal=False)
    if impl == "blocked" and sq > 1:
        out = blocked_attention(q, k, v, q_pos, k_pos, variant)
    else:
        out = gqa_attention(q, k, v, q_pos, k_pos, variant)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_block(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """Gated (silu/gelu "glu" style) or plain (gelu / squared-relu) MLP.
    Presence of p["w_gate"] selects gated."""
    if "w_gate" in p:
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype))
        u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype))
        h = _activate(g, act) * u
    else:
        h = torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype))
        h = _activate(h, act)
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(x.dtype))


def _activate(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        return F.gelu(x, approximate="tanh")
    if act == "relu2":  # nemotron squared ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {act}")


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed(tokens: torch.Tensor, table: torch.Tensor,
          scale_by_sqrt_dim: bool = False) -> torch.Tensor:
    x = table[tokens]
    if scale_by_sqrt_dim:
        x = x * torch.tensor(math.sqrt(table.shape[-1]), dtype=torch.float32
                             ).to(x.dtype)
    return x


def unembed(x: torch.Tensor, table: torch.Tensor,
            softcap: float = 0.0) -> torch.Tensor:
    # the transposed view goes to the matmul as is (no copy of the table)
    logits = torch.matmul(x, table.to(x.dtype).t())
    return _softcap(logits.float(), softcap)
