"""The stacking op: the reference's argument layout, on the tensors' device."""
from __future__ import annotations

import torch

from .ref import stack_rois_ref
from .stacking import stack_rois_fwd


def stack_rois(rois: torch.Tensor, sky: torch.Tensor, cal: torch.Tensor,
               dy: torch.Tensor, dx: torch.Tensor, *,
               mean: bool = True) -> torch.Tensor:
    """rois (N,H,W); sky/cal/dy/dx (N,).  Returns the (H,W) fp32 coadd,
    divided by N when ``mean``.  Inputs are cast to fp32.

    CUDA tensors launch the hand-written kernel (or raise); CPU tensors take
    the plain version -- the only reason the plain version runs is that the
    tensors lie on the CPU."""
    rois, sky, cal, dy, dx = (_fp32(t) for t in (rois, sky, cal, dy, dx))
    if rois.is_cuda:
        return stack_rois_fwd(rois, sky, cal, dy, dx, mean=mean)
    out = stack_rois_ref(rois, sky, cal, dy, dx)
    if mean:
        out = out / rois.shape[0]
    return out


def _fp32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous fp32; the tensor itself when it already is (no
    op is issued, which matters on the many-threaded main path)."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.float().contiguous()
