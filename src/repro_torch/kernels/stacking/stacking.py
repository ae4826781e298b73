"""Wrapper of the hand-written CUDA stacking kernel (``csrc/stack_rois.cu``).

The kernel replaces the TPU kernel ``repro.kernels.stacking.stacking.
_stack_kernel``; the source's head note says what bounds it and how its
design answers that.  ``stack_rois_fwd`` checks its inputs, allocates the
output, launches on PyTorch's current stream and counts the launch.  It
takes CUDA tensors only: the CPU's path is ``ref.py``, chosen in ``ops.py``.
Inside a recorded request attempt (``repro_torch.obs.request``) the launch
call is a ``launch`` span of that request.

``coadd_fwd`` is a mean-sky coadd in one foreign call: sky a given
fraction of each tile's mean, cal 1, the shifts given on the host (the app
names the fraction).  The many executor threads of the runtime share the
interpreter lock and the card's one stream.  Each PyTorch call around a
launch gives up the lock and waits behind the other threads to take it
back, and a blocking copy of the shifts from pageable memory synchronises
the shared stream, so a request waited for every kernel and store read
queued before it.  So the wrapper makes one allocation (the output, then a
scratch of 4N floats for sky, cal, dy and dx) and one call into the
library, which is a ``PyDLL`` and keeps the lock.  The call enqueues a
hand-written prep kernel (the sky means, the unit cals, the shifts) and
the stacking kernel, and returns: nothing synchronises.  The shifts travel
inside the prep kernel's launch as parameters, with no copy of their own,
256 tiles' worth a launch (``csrc/stack_rois.cu``'s head says more).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...obs.recorder import request
from ..build import LaunchCounter, load

#: launches of the stacking kernel (``launches.value``; ``reset()`` to zero)
launches = LaunchCounter("stack_rois")
#: coadds issued through the one-call entry (``coadd_fwd``)
coadd_calls = LaunchCounter("stack_rois/coadd")

_F32 = torch.float32
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
#: tiles, shifts (host bytes), sky fraction, scratch, out; n, h, w, mean,
#: device; stream
_COADD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_float,
                    ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])


@functools.cache
def _entry():
    """The C entry point, loaded (and built) on first launch."""
    fn = load("stack_rois").stack_rois_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _coadd_entry():
    """The one-call coadd's C entry, loaded (and built) on first call."""
    fn = load("stack_rois").stack_rois_coadd
    fn.argtypes = _COADD_ARGTYPES
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
    launch = _entry()
    args = (rois.data_ptr(), sky.data_ptr(), cal.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), out.data_ptr(), n, h, w, int(mean), device, stream)
    ctx = request()
    if ctx is None:
        err = launch(*args)
    else:
        rec, tid, eid = ctx
        t0 = rec.clock()
        err = launch(*args)
        rec.span("launch", t0, rec.clock() - t0, tid=tid, eid=eid,
                 kernel="stack_rois", parent="fn")
    if err != 0:
        raise RuntimeError(f"stack_rois kernel launch failed: CUDA error {err}")
    launches.add()
    return out


def check_coadd_inputs(tiles: torch.Tensor, shifts: np.ndarray) -> None:
    """Raise unless tiles (N,H,W) are contiguous fp32 on a CUDA device, none
    of N, H, W 0, and shifts a (2, N) float32 host array.  Inputs that pass
    cost one expression."""
    if (tiles.dim() == 3 and tiles.is_cuda and tiles.dtype is _F32
            and tiles.is_contiguous() and min(tiles.shape) >= 1
            and isinstance(shifts, np.ndarray) and shifts.dtype == np.float32
            and shifts.shape == (2, tiles.shape[0])):
        return
    if tiles.dim() != 3 or min(tiles.shape) < 1:
        raise ValueError(f"tiles must be (N, H, W), none of them 0, got "
                         f"{tuple(tiles.shape)}")
    if not tiles.is_cuda:
        raise ValueError(f"tiles are on {tiles.device}; the kernel takes a "
                         f"CUDA device")
    if tiles.dtype != torch.float32:
        raise TypeError(f"tiles are {tiles.dtype}; the kernel takes float32")
    if not tiles.is_contiguous():
        raise ValueError("tiles are not contiguous")
    raise ValueError(f"shifts must be a float32 host array of shape "
                     f"(2, {tiles.shape[0]})")


def coadd_fwd(tiles: torch.Tensor, shifts: np.ndarray,
              sky_fraction: float) -> torch.Tensor:
    """The (H,W) fp32 mean coadd of ``tiles`` (N,H,W), contiguous fp32 on a
    CUDA device: each tile calibrated with sky ``sky_fraction`` times its
    fp32 mean and cal 1, shifted by its (dy, dx) -- ``shifts`` a (2, N)
    float32 host array, dy then dx -- summed and divided by N.  One
    allocation and one call into the library; the kernels are queued on
    PyTorch's current stream and nothing waits for them."""
    check_coadd_inputs(tiles, shifts)
    n, h, w = tiles.shape
    # the output's rows, then whole rows that hold sky, cal, dy and dx
    buf = tiles.new_empty((h + -(-4 * n // w), w))
    out = buf[:h]
    device = tiles.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    coadd = _coadd_entry()
    ptr = buf.data_ptr()
    args = (tiles.data_ptr(), shifts.tobytes(), sky_fraction,
            ptr + 4 * h * w, ptr, n, h, w, 1, device, stream)
    ctx = request()
    if ctx is None:
        err = coadd(*args)
    else:
        rec, tid, eid = ctx
        t0 = rec.clock()
        err = coadd(*args)
        rec.span("launch", t0, rec.clock() - t0, tid=tid, eid=eid,
                 kernel="stack_rois", parent="fn")
    if err != 0:
        raise RuntimeError(f"stack_rois coadd failed: CUDA error {err}")
    launches.add()
    coadd_calls.add()
    return out
