"""Wrapper of the hand-written CUDA selective-scan kernel
(``csrc/mamba_scan.cu``).

The kernel replaces the TPU kernel ``repro.kernels.mamba_scan.mamba_scan.
_scan_kernel``; the source's head note says what bounds it and how its
design answers that.  ``mamba_scan_fwd`` checks its inputs, picks the
kernel's lane layout with ``kernel_path``, allocates y and h_last, launches
on PyTorch's current stream and counts the launch.  It takes CUDA tensors
only: the CPU's path is ``ref.py``, chosen in
``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..build import LaunchCounter, load, refuse_grad

#: launches of the selective-scan kernel (``launches.value``; ``reset()``)
launches = LaunchCounter()
#: launches per lane layout, by ``kernel_path``'s answer
path_launches = {"pair": LaunchCounter(), "quad": LaunchCounter()}
#: lanes of a warp that share one (b, i) channel, per path
LANES = {"pair": 2, "quad": 4}
#: below this many (b, i) channels, two lanes per channel leave the SMs
#: short of warps, and four lanes share each channel
QUAD_BELOW_CHANNELS = 16384

#: the largest state size N the kernel takes (the states live in registers)
MAX_STATE = 32

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 13 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])


@functools.cache
def _entry():
    """The C entry point, loaded (and built) on first launch."""
    fn = load("mamba_scan").mamba_scan_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def kernel_path(batch: int, inner: int) -> str:
    """Which lane layout takes a scan over ``batch`` x ``inner`` channels:
    ``"pair"``, two lanes per channel each holding half its states, where
    there are channels enough to fill the card (the serving waves: B=8,
    I=8192); else ``"quad"``, four lanes per channel each holding a quarter
    of the states (a one-row prefill).  At B·I = 16,384 the two tie on the
    H100 (``chip_smoke.py`` times both at the main shapes)."""
    return "quad" if batch * inner < QUAD_BELOW_CHANNELS else "pair"


def mamba_scan_fwd(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """u, dt (B,S,I); A (I,N); Bm, Cm (B,S,N); D (I,); h0 (B,I,N) or None
    (a zero state): fp32 on one CUDA device, any strides with a contiguous
    last dim (so column slices of the model's projection go in uncopied).
    Returns (y (B,S,I), h_last (B,I,N)), both fp32 and contiguous.  The
    kernel has no backward: inputs that require grad while grad mode is on
    are refused."""
    refuse_grad("mamba_scan", u=u, dt=dt, A=A, Bm=Bm, Cm=Cm, D=D, h0=h0)
    if u.dim() != 3:
        raise ValueError(f"u must be (B, S, I), got {tuple(u.shape)}")
    b, s, i = u.shape
    if A.dim() != 2 or A.shape[0] != i:
        raise ValueError(f"A must be ({i}, N), got {tuple(A.shape)}")
    n = A.shape[1]
    named = {"u": u, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "D": D}
    want = {"dt": (b, s, i), "Bm": (b, s, n), "Cm": (b, s, n), "D": (i,)}
    if h0 is not None:
        named["h0"], want["h0"] = h0, (b, i, n)
    for label, shape in want.items():
        if tuple(named[label].shape) != shape:
            raise ValueError(f"{label} must be {shape}, got "
                             f"{tuple(named[label].shape)}")
    if min(b, s, i, n) < 1 or b > 65535:
        raise ValueError(f"bad shape (B, S, I, N) = {(b, s, i, n)}")
    if n > MAX_STATE:
        raise ValueError(f"state size {n} > {MAX_STATE}")
    for label, t in named.items():
        if t.device.type != "cuda" or t.device != u.device:
            raise ValueError(f"{label} is on {t.device}; the kernel takes "
                             f"tensors on one CUDA device ({u.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{label} is {t.dtype}; the kernel takes "
                            f"float32")
        if t.stride(-1) != 1:
            raise ValueError(f"{label}'s last dim is not contiguous")
    y = torch.empty((b, s, i), dtype=torch.float32, device=u.device)
    h_last = torch.empty((b, i, n), dtype=torch.float32, device=u.device)
    h0_ptr, h0_sb, h0_si = ((h0.data_ptr(), h0.stride(0), h0.stride(1))
                            if h0 is not None else (None, 0, 0))
    path = kernel_path(b, i)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = _entry()(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), D.data_ptr(), h0_ptr, y.data_ptr(), h_last.data_ptr(),
        b, s, i, n, u.stride(0), u.stride(1), dt.stride(0), dt.stride(1),
        A.stride(0), Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
        h0_sb, h0_si, y.stride(0), y.stride(1), LANES[path],
        u.device.index, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan {path} kernel launch failed: CUDA "
                           f"error {err}")
    launches.add()
    path_launches[path].add()
    return y, h_last
