"""The selective-scan op the model calls, on the tensors' device.

The reference's wrapper (``repro.kernels.mamba_scan.ops``) pads I to its
channel block and S to its chunk (padded steps have dt = 0, which leaves
the state unchanged).  That is TPU tiling; the CUDA kernel masks its own
ragged I and S, so nothing is padded, and a missing h0 is a zero state the
kernel never reads.
"""
from __future__ import annotations

from typing import Optional

import torch

from .mamba_scan import mamba_scan_fwd
from .ref import mamba_scan_ref


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """u, dt (B,S,I); A (I,N); Bm, Cm (B,S,N); D (I,); h0 (B,I,N) or None,
    in any float dtype.  Returns (y (B,S,I) in u's dtype, h_last (B,I,N)
    fp32), as the reference, which casts each block to fp32.

    CUDA tensors launch the hand-written kernel (or raise); CPU tensors take
    the plain version -- the only reason the plain version runs is that the
    tensors lie on the CPU."""
    if not u.is_cuda:
        return mamba_scan_ref(u, dt, A, Bm, Cm, D, h0)
    y, h_last = mamba_scan_fwd(_fp32(u), _fp32(dt), _fp32(A), _fp32(Bm),
                               _fp32(Cm), _fp32(D),
                               None if h0 is None else _fp32(h0))
    return y.to(u.dtype), h_last


def _fp32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, the tensor itself (strides and all) when it already
    is: the kernel takes fp32 only."""
    return t if t.dtype == torch.float32 else t.float()
