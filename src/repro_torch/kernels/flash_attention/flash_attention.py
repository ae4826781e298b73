"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

The kernel replaces the TPU kernel ``repro.kernels.flash_attention.
flash_attention._fa_kernel``; the source's head note says what bounds it
and how its design answers that.  ``flash_attention_fwd`` checks its
inputs, allocates the output, launches on PyTorch's current stream and
counts the launch.  It takes CUDA tensors only: the CPU's path is
``ref.py``, chosen in ``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..build import LaunchCounter, load

#: launches of the flash-attention kernel (``launches.value``; ``reset()``)
launches = LaunchCounter()

#: the largest head_dim the kernel takes
MAX_HEAD_DIM = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


@functools.cache
def _entry():
    """The C entry point, loaded (and built) on first launch."""
    fn = load("flash_attention").flash_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q (B,H,Sq,D), k/v (B,KV,Sk,D): fp32 or bf16 on one CUDA device, any
    strides with a contiguous last dim (so the model's (B,S,H,D) tensors go
    in as transposed views, uncopied).  Returns (B,H,Sq,D) in q's dtype,
    laid out in memory as q is."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-d, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, kv, sk, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be ({b}, KV, Sk, {d}) alike, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if min(b, h, sq, kv, sk, d) < 1 or h % kv:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f" (H must be a multiple of KV)")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q is {q.dtype}; the kernel takes float32 or "
                        f"bfloat16")
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{label} is on {t.device}; the kernel takes "
                             f"tensors on one CUDA device ({q.device})")
        if t.dtype != q.dtype:
            raise TypeError(f"{label} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{label}'s last dim is not contiguous")
    # same strides as q (a dense permuted q gives a dense permuted out)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, h, kv, sq, sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), int(window), float(softcap), 1.0 / math.sqrt(d),
        q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches.add()
    return out
