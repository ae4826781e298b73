"""The selective-scan op the model calls, on the tensors' device.

The reference's wrapper (``repro.kernels.mamba_scan.ops``) pads I to its
channel block and S to its chunk (padded steps have dt = 0, which leaves
the state unchanged).  That is TPU tiling; the CUDA kernel masks its own
ragged I and S, so nothing is padded, and a missing h0 is a zero state the
kernel never reads.

The kernel is forward only, as the reference's is.
``mamba_scan_with_ref_vjp`` is the op training takes: the kernel's forward
and the gradients of the reference model's plain chunked scan.
"""
from __future__ import annotations

from typing import Optional

import torch

from .mamba_scan import mamba_scan_fwd
from .ref import chunk_slices, mamba_scan_ref, ssm_scan


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


class _ScanRefVJP(torch.autograd.Function):
    """Forward: :func:`mamba_scan` (the kernel on the card).  Backward: the
    VJP of the reference model's chunked plain scan (``ssm_scan`` over
    chunks of ``chunk`` steps, each checkpointed), in fp32, so one chunk's
    (B, L, I, N) intermediates are live at a time.

    The backward first runs the plain scan without a graph to record the
    state entering each chunk, then walks the chunks in reverse: each is
    recomputed with a graph from its entering state, differentiated against
    its inputs and that state, and the state's gradient is carried to the
    chunk before.  The forward's y comes from the kernel, which forms
    ``(dt·u)·B`` where the plain scan forms ``dt·B·u``: the two differ by
    fp32 rounding, as flash's forward and its plain backward do."""

    @staticmethod
    def forward(ctx, u, dt, A, Bm, Cm, D, h0, chunk):
        ctx.save_for_backward(u, dt, A, Bm, Cm, D, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return mamba_scan(u, dt, A, Bm, Cm, D, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        u, dt, A, Bm, Cm, D, h0 = ctx.saved_tensors
        if gy is None and gh is None:
            return (None,) * 8
        slices = chunk_slices(u.shape[1], ctx.chunk)

        def chunk_of(sl, ts):
            u_, dt_, A_, B_, C_, D_ = ts
            return [u_[:, sl], dt_[:, sl], A_, B_[:, sl], C_[:, sl], D_]

        # the state entering each chunk (None: a zero state), without a graph
        h_in = [None if h0 is None else h0.float()]
        f32 = [t.float() for t in (u, dt, A, Bm, Cm, D)]
        with torch.no_grad():
            for sl in slices[:-1]:
                h_in.append(ssm_scan(*chunk_of(sl, f32), h0=h_in[-1])[1])
        del f32
        g_u, g_dt, g_B, g_C = (torch.zeros_like(t) for t in (u, dt, Bm, Cm))
        g_A = g_D = None
        g_h = gh
        for sl, h in zip(reversed(slices), reversed(h_in)):
            ins = [t.detach().requires_grad_()
                   for t in chunk_of(sl, (u, dt, A, Bm, Cm, D))]
            if h is not None:
                ins.append(h.detach().requires_grad_())
            with torch.enable_grad():
                y_c, h_out = ssm_scan(*(t.float() for t in ins[:6]),
                                      h0=ins[6] if h is not None else None)
                pairs = [(o, g) for o, g in (
                    (y_c, None if gy is None else gy[:, sl]), (h_out, g_h))
                    if g is not None]
                # h_last alone reads neither Cm nor D: zeros for them
                got = torch.autograd.grad([o for o, _ in pairs], ins,
                                          [g.float() for _, g in pairs],
                                          allow_unused=True,
                                          materialize_grads=True)
            g_u[:, sl], g_dt[:, sl], gA_c, g_B[:, sl], g_C[:, sl], gD_c = \
                got[:6]
            g_A = gA_c if g_A is None else g_A + gA_c
            g_D = gD_c if g_D is None else g_D + gD_c
            g_h = got[6] if h is not None else None
        g_h0 = None if h0 is None else g_h.to(h0.dtype)
        return g_u, g_dt, g_A, g_B, g_C, g_D, g_h0, None


def mamba_scan_with_ref_vjp(u: torch.Tensor, dt: torch.Tensor,
                            A: torch.Tensor, Bm: torch.Tensor,
                            Cm: torch.Tensor, D: torch.Tensor,
                            h0: Optional[torch.Tensor] = None,
                            chunk: int = 256
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba_scan` with gradients: the kernel forward, the backward
    through the reference model's plain scan in chunks of ``chunk`` steps
    (the reference trains through ``jax.checkpoint`` of that scan; its
    Pallas kernel has no backward)."""
    return _ScanRefVJP.apply(u, dt, A, Bm, Cm, D, h0, chunk)
