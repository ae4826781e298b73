"""Wrapper of the hand-written CUDA flash-attention kernels
(``csrc/flash_attention.cu``).

The kernels replace the TPU kernel ``repro.kernels.flash_attention.
flash_attention._fa_kernel``; the source's head note says what bounds them
and how their design answers that.  ``flash_attention_fwd`` checks its
inputs, picks a kernel with ``kernel_path``, allocates the output, launches
on PyTorch's current stream and counts the launch.  It takes CUDA tensors
only: the CPU's path is ``ref.py``, chosen in ``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..build import LaunchCounter, load, refuse_grad

#: launches of either flash-attention kernel (``launches.value``;
#: ``reset()``)
launches = LaunchCounter()
#: launches per kernel, by ``kernel_path``'s answer
path_launches = {"wgmma": LaunchCounter(), "simt": LaunchCounter()}

#: the largest head_dim the SIMT kernel takes
MAX_HEAD_DIM = 256
#: the largest head_dim the tensor-core kernel takes (two 64-column boxes)
MAX_TC_HEAD_DIM = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
_TC_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2
                + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


@functools.cache
def _entry(path: str):
    """The C entry point of a kernel, loaded (and built) on first launch."""
    lib = load("flash_attention")
    if path == "wgmma":
        fn, fn.argtypes = lib.flash_attention_tc_launch, _TC_ARGTYPES
    else:
        fn, fn.argtypes = lib.flash_attention_launch, _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def kernel_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which kernel takes these (B,H,S,D) inputs: ``"wgmma"``, the
    tensor-core kernel, for bf16 with head_dim a multiple of 8 up to 128
    where TMA can read every tensor as it lies (base address and the
    strides of every dim longer than 1 a positive multiple of 16 bytes,
    last dim contiguous); else ``"simt"``, which also takes a broadcast
    (stride 0) dim.  fp32 stays on the SIMT kernel: wgmma would take it
    only as TF32, which misses the reference's 2e-5."""
    d = q.shape[-1]
    if (any(t.dtype != torch.bfloat16 for t in (q, k, v))
            or d % 8 or d > MAX_TC_HEAD_DIM):
        return "simt"
    for t in (q, k, v):
        if t.stride(-1) != 1 or t.data_ptr() % 16:
            return "simt"
        if any(n > 1 and (st <= 0 or (st * t.element_size()) % 16)
               for n, st in zip(t.shape[:3], t.stride()[:3])):
            return "simt"
    return "wgmma"


def _tma_strides(t: torch.Tensor) -> list[int]:
    """t's batch, head and sequence strides, where a dim of size 1 (whose
    stride is never used) gets head_dim, a stride TMA takes."""
    return [st if n > 1 else t.shape[-1]
            for n, st in zip(t.shape[:3], t.stride()[:3])]


def _launch_args(path: str, q, k, v, out, causal: bool, window: int,
                 softcap: float) -> tuple:
    """The arguments of ``path``'s C entry point for checked inputs."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if path == "wgmma":
        shape_args = (b, h, kv, sq, sk, d, *(s for t in (q, k, v, out)
                                             for s in _tma_strides(t)))
    else:
        shape_args = (_DTYPES[q.dtype], b, h, kv, sq, sk, d,
                      *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *shape_args, int(causal), int(window), float(softcap),
            1.0 / math.sqrt(d), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q (B,H,Sq,D), k/v (B,KV,Sk,D): fp32 or bf16 on one CUDA device, any
    strides with a contiguous last dim (so the model's (B,S,H,D) tensors go
    in as transposed views, uncopied).  Returns (B,H,Sq,D) in q's dtype,
    laid out in memory as q is.  The kernel has no backward: inputs that
    require grad while grad mode is on are refused (``ops.
    flash_attention_with_ref_vjp`` is the op with gradients)."""
    refuse_grad("flash_attention", q=q, k=k, v=v)
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
    path = kernel_path(q, k, v)
    err = _entry(path)(*_launch_args(path, q, k, v, out, causal, window,
                                     softcap))
    if err != 0:
        what = (f"tensor map encoding failed: CUresult {-err}" if err < 0
                else f"CUDA error {err}")
        raise RuntimeError(f"flash_attention {path} kernel launch failed: "
                           f"{what}")
    launches.add()
    path_launches[path].add()
    return out
