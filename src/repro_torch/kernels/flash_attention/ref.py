"""Plain PyTorch version of the flash-attention kernel (the oracle it is
held to), fp32 end to end, in the kernel's (B, H, S, D) layout."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  q_chunk: int = 0) -> torch.Tensor:
    """q (B,H,Sq,D), k/v (B,KV,Sk,D) -> (B,H,Sq,D) in q's dtype.

    ``softmax(q·kᵀ/√D)·v`` with GQA (query head h reads kv head h // (H/KV)),
    an optional tanh softcap applied before the mask, a causal mask
    ``k <= q`` and a window mask ``k > q - window``.  Masked logits are the
    finite -2^30; a row with no valid key outputs 0.  With ``q_chunk > 0``
    the query rows go in chunks of that many, which bounds the (Sq, Sk)
    score tensor; the result is the same."""
    sq, d = q.shape[2], q.shape[3]
    group = q.shape[1] // k.shape[1]
    kg = k.float().repeat_interleave(group, dim=1)
    vg = v.float().repeat_interleave(group, dim=1)
    k_pos = torch.arange(k.shape[2], device=q.device)
    step = q_chunk if q_chunk > 0 else sq
    outs = []
    for q0 in range(0, sq, step):
        qc = q[:, :, q0:q0 + step].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kg) / math.sqrt(d)
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        q_pos = torch.arange(q0, q0 + qc.shape[2], device=q.device)[:, None]
        ok = torch.ones(qc.shape[2], k.shape[2], dtype=torch.bool,
                        device=q.device)
        if causal:
            ok &= k_pos[None, :] <= q_pos
        if window > 0:
            ok &= k_pos[None, :] > q_pos - window
        s = torch.where(ok, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        # rows with no valid key give uniform probabilities; zero them
        p = torch.where(ok.any(-1)[:, None], p, 0.0)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, vg))
    return torch.cat(outs, dim=2).to(q.dtype)
