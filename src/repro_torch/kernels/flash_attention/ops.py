"""The flash-attention op in the model's layout, on the tensors' device.

The reference's wrapper (``repro.kernels.flash_attention.ops``) pads
head_dim to a 128-lane multiple and the sequence to its block size, and
rescales q to undo the padded √D.  Those are TPU layout; the CUDA kernels
take any head_dim up to 256 and any Sq, Sk as they are (the tensor-core
kernel's TMA loads fill the ragged edges with zeros), so nothing is padded
and the scale is 1/√Dh of the true Dh.

The kernels are forward only, as the reference's is.
``flash_attention_with_ref_vjp`` is the op training takes: the kernel's
forward and the plain version's gradients.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_fwd
from .ref import attention_ref

#: what the kernels take; anything else (float16) runs in fp32 and comes
#: back in q's dtype, as the reference kernel casts q, k and v to fp32
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B,S,H,Dh), k/v (B,S,KV,Dh) -> (B,S,H,Dh) in q's dtype.

    CUDA tensors launch a hand-written kernel (or raise); CPU tensors take
    the plain version -- the only reason the plain version runs is that the
    tensors lie on the CPU."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if not q.is_cuda:
        out = attention_ref(qt, kt, vt, causal=causal, window=window,
                            softcap=softcap)
        return out.transpose(1, 2)
    if q.dtype not in _KERNEL_DTYPES:
        qt, kt, vt = (t.float() for t in (qt, kt, vt))
    qt, kt, vt = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (qt, kt, vt))
    out = flash_attention_fwd(qt, kt, vt, causal=causal, window=window,
                              softcap=softcap)
    return out.transpose(1, 2).to(q.dtype)


class _FlashRefVJP(torch.autograd.Function):
    """Forward: :func:`flash_attention` (the kernel on the card).
    Backward: autograd through the plain ``attention_ref`` on the saved
    q, k and v, the exact math the kernel computes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, softcap)
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)

    @staticmethod
    def backward(ctx, g):
        causal, window, softcap = ctx.mask
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            qt, kt, vt = (t.transpose(1, 2) for t in inputs)
            out = attention_ref(qt, kt, vt, causal=causal, window=window,
                                softcap=softcap).transpose(1, 2)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None, None)


def flash_attention_with_ref_vjp(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, causal: bool = True,
                                 window: int = 0,
                                 softcap: float = 0.0) -> torch.Tensor:
    """:func:`flash_attention` with gradients: the kernel forward, the
    backward through the plain version (the reference's
    ``flash_attention_with_ref_vjp``, whose backward is the jnp VJP)."""
    return _FlashRefVJP.apply(q, k, v, causal, window, softcap)
