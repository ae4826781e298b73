"""Wrapper of the hand-written CUDA stacking kernel (``csrc/stack_rois.cu``).

The kernel replaces the TPU kernel ``repro.kernels.stacking.stacking.
_stack_kernel``; the source's head note says what bounds it and how its
design answers that.  ``stack_rois_fwd`` checks its inputs, allocates the
output, launches on PyTorch's current stream and counts the launch.  It
takes CUDA tensors only: the CPU's path is ``ref.py``, chosen in ``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import LaunchCounter, load

#: launches of the stacking kernel (``launches.value``; ``reset()`` to zero)
launches = LaunchCounter()

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@functools.cache
def _entry():
    """The C entry point, loaded (and built) on first launch."""
    fn = load("stack_rois").stack_rois_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def stack_rois_fwd(rois: torch.Tensor, sky: torch.Tensor, cal: torch.Tensor,
                   dy: torch.Tensor, dx: torch.Tensor, *,
                   mean: bool = False) -> torch.Tensor:
    """rois (N,H,W); sky/cal/dy/dx (N,): contiguous fp32 on one CUDA device.
    Returns the (H,W) fp32 coadd, divided by N when ``mean``."""
    if rois.dim() != 3:
        raise ValueError(f"rois must be (N, H, W), got {tuple(rois.shape)}")
    n, h, w = rois.shape
    if n < 1 or h < 1 or w < 1:
        raise ValueError(f"empty rois {tuple(rois.shape)}")
    for label, t in (("rois", rois), ("sky", sky), ("cal", cal),
                     ("dy", dy), ("dx", dx)):
        if t.device.type != "cuda" or t.device != rois.device:
            raise ValueError(f"{label} is on {t.device}; the kernel takes "
                             f"tensors on one CUDA device ({rois.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{label} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{label} is not contiguous")
        if t is not rois and tuple(t.shape) != (n,):
            raise ValueError(f"{label} must be ({n},), got {tuple(t.shape)}")
    out = torch.empty((h, w), dtype=torch.float32, device=rois.device)
    stream = torch.cuda.current_stream(rois.device).cuda_stream
    err = _entry()(rois.data_ptr(), sky.data_ptr(), cal.data_ptr(),
                   dy.data_ptr(), dx.data_ptr(), out.data_ptr(),
                   n, h, w, int(mean), rois.device.index, stream)
    if err != 0:
        raise RuntimeError(f"stack_rois kernel launch failed: CUDA error {err}")
    launches.add()
    return out
