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
    """u, dt (B,S,I); A (I,N); Bm, Cm (B,S,N); D (I,); h0 (B,I,N) or None.
    Returns (y (B,S,I), h_last (B,I,N) fp32).

    CUDA tensors launch the hand-written kernel (or raise); CPU tensors take
    the plain version -- the only reason the plain version runs is that the
    tensors lie on the CPU."""
    if u.is_cuda:
        return mamba_scan_fwd(u, dt, A, Bm, Cm, D, h0)
    return mamba_scan_ref(u, dt, A, Bm, Cm, D, h0)
