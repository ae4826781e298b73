"""The flash-attention op in the model's layout, on the tensors' device.

The reference's wrapper (``repro.kernels.flash_attention.ops``) pads
head_dim to a 128-lane multiple and the sequence to its block size, and
rescales q to undo the padded √D.  Those are TPU layout; the CUDA kernels
take any head_dim up to 256 and any Sq, Sk as they are (the tensor-core
kernel's TMA loads fill the ragged edges with zeros), so nothing is padded
and the scale is 1/√Dh of the true Dh.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_fwd
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B,S,H,Dh), k/v (B,S,KV,Dh) -> (B,S,H,Dh) in q's dtype.

    CUDA tensors launch a hand-written kernel (or raise); CPU tensors take
    the plain version -- the only reason the plain version runs is that the
    tensors lie on the CPU."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.is_cuda:
        qt, kt, vt = (t if t.stride(-1) == 1 else t.contiguous()
                      for t in (qt, kt, vt))
        out = flash_attention_fwd(qt, kt, vt, causal=causal, window=window,
                                  softcap=softcap)
    else:
        out = attention_ref(qt, kt, vt, causal=causal, window=window,
                            softcap=softcap)
    return out.transpose(1, 2)
