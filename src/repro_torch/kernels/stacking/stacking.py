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
launches = LaunchCounter("stack_rois")

_F32 = torch.float32
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@functools.cache
def _entry():
    """The C entry point, loaded (and built) on first launch."""
    fn = load("stack_rois").stack_rois_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _inputs_ok(rois, sky, cal, dy, dx) -> bool:
    """Whether every check of ``check_inputs`` passes, in one expression of
    cheap attribute reads (the app's own tensors always pass)."""
    if rois.dim() != 3 or not rois.is_cuda:
        return False
    d = rois.get_device()
    n, h, w = rois.shape
    return (n >= 1 and h >= 1 and w >= 1 and rois.dtype is _F32
            and rois.is_contiguous()
            and sky.is_cuda and sky.get_device() == d and sky.dtype is _F32
            and sky.is_contiguous() and sky.shape == (n,)
            and cal.is_cuda and cal.get_device() == d and cal.dtype is _F32
            and cal.is_contiguous() and cal.shape == (n,)
            and dy.is_cuda and dy.get_device() == d and dy.dtype is _F32
            and dy.is_contiguous() and dy.shape == (n,)
            and dx.is_cuda and dx.get_device() == d and dx.dtype is _F32
            and dx.is_contiguous() and dx.shape == (n,))


def check_inputs(rois: torch.Tensor, sky: torch.Tensor, cal: torch.Tensor,
                 dy: torch.Tensor, dx: torch.Tensor) -> None:
    """Raise unless rois (N,H,W) and sky/cal/dy/dx (N,) are contiguous
    fp32 on one CUDA device.  Inputs that pass cost one expression; only a
    failure walks the tensors one by one to name the culprit."""
    if _inputs_ok(rois, sky, cal, dy, dx):
        return
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


def stack_rois_fwd(rois: torch.Tensor, sky: torch.Tensor, cal: torch.Tensor,
                   dy: torch.Tensor, dx: torch.Tensor, *,
                   mean: bool = False) -> torch.Tensor:
    """rois (N,H,W); sky/cal/dy/dx (N,): contiguous fp32 on one CUDA device.
    Returns the (H,W) fp32 coadd, divided by N when ``mean``."""
    check_inputs(rois, sky, cal, dy, dx)
    n, h, w = rois.shape
    out = rois.new_empty((h, w))   # fp32 on rois's device
    device = rois.get_device()
    # PyTorch's current stream on that device, as an int: what
    # torch.cuda.current_stream(device).cuda_stream gives, without building
    # a Stream object (chip_smoke.py's host costs time both)
    stream = torch._C._cuda_getCurrentRawStream(device)
    err = _entry()(rois.data_ptr(), sky.data_ptr(), cal.data_ptr(),
                   dy.data_ptr(), dx.data_ptr(), out.data_ptr(),
                   n, h, w, int(mean), device, stream)
    if err != 0:
        raise RuntimeError(f"stack_rois kernel launch failed: CUDA error {err}")
    launches.add()
    return out
