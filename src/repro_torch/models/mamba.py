"""Mamba-1 selective SSM block (falcon-mamba / jamba mamba layers).

The port of the reference's ``repro.models.mamba``.  The full-sequence
block (prefill and training) runs the selective scan either through the
hand-written CUDA kernel (``use_kernel``; ``kernels/mamba_scan``) or
through the plain chunked path; decode is the O(1) recurrent update.  The
kernel is forward only: where a gradient is wanted the block takes
``mamba_scan_with_ref_vjp`` (the kernel's forward, the plain chunked
scan's gradients), and the plain path checkpoints each chunk, as the
reference's ``jax.checkpoint`` does.  The reference's order of operations
is kept where bf16 rounding depends on it: the causal conv as K shifted
multiply-adds summed in the order of k, the projection cast to fp32
before its split into dt, B and C, and y cast to x's dtype before the
gate.

Shapes (per layer): d_inner = expand * d_model, N = d_state, R = dt_rank.
  in_proj  (D, 2*d_inner)     conv_w  (K, d_inner)      x_proj (d_inner, R+2N)
  dt_proj  (R, d_inner)       A_log   (d_inner, N)      D      (d_inner,)
  out_proj (d_inner, D)

Left out: the ``rules``/``shard`` arguments of the layers (one card, no
mesh); the leaves' logical axes are :data:`MAMBA_LOGICAL`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.mamba_scan.ref import ssm_scan_chunked


def mamba_param_shapes(d_model: int, d_inner: int, d_state: int,
                       d_conv: int, dt_rank: int) -> dict:
    """Leaf name -> shape of one mamba layer's parameters."""
    return {
        "in_proj": (d_model, 2 * d_inner),
        "conv_w": (d_conv, d_inner),
        "conv_b": (d_inner,),
        "x_proj": (d_inner, dt_rank + 2 * d_state),
        "dt_proj": (dt_rank, d_inner),
        "dt_bias": (d_inner,),
        "A_log": (d_inner, d_state),
        "D": (d_inner,),
        "out_proj": (d_inner, d_model),
    }


#: each leaf's logical sharding axes (the reference's, from its
#: ``mamba_param_shapes``)
MAMBA_LOGICAL = {
    "in_proj": ("fsdp", "tp"),
    "conv_w": (None, "tp_fsdp"),
    "conv_b": ("tp_fsdp",),
    "x_proj": ("tp_fsdp", None),
    "dt_proj": (None, "tp_fsdp"),
    "dt_bias": ("tp_fsdp",),
    "A_log": ("tp_fsdp", None),
    "D": ("tp_fsdp",),
    "out_proj": ("tp", "fsdp"),
}


def mamba_block(x: torch.Tensor, p: dict,
                conv_state: Optional[torch.Tensor] = None,
                ssm_state: Optional[torch.Tensor] = None,
                return_state: bool = False, use_kernel: bool = False,
                chunk: int = 256):
    """Full-sequence Mamba block (prefill and training).  x (B,S,D);
    ``conv_state`` (B,K-1,I) is carried context and ``ssm_state`` (B,I,N)
    an initial state.  Returns the output (B,S,D), and with
    ``return_state`` also the new conv state and the last ssm state.
    ``use_kernel`` runs the scan through the CUDA kernel on the card (its
    plain version on the CPU); otherwise the plain scan runs in chunks of
    ``chunk`` steps.  Under autograd either way differentiates the plain
    chunked scan, one chunk's intermediates at a time."""
    b, s, _ = x.shape
    k_conv, i = p["conv_w"].shape
    n = p["A_log"].shape[-1]
    r = p["dt_proj"].shape[0]

    xz = torch.einsum("bsd,di->bsi", x, p["in_proj"].to(x.dtype))
    xs, z = xz.chunk(2, dim=-1)

    # causal depthwise conv1d as K shifted multiply-adds, summed in k order
    pad = conv_state if conv_state is not None else torch.zeros(
        (b, k_conv - 1, i), dtype=xs.dtype, device=xs.device)
    xpad = torch.cat([pad, xs], dim=1)                          # (B,S+K-1,I)
    w = p["conv_w"].to(x.dtype)
    xc = sum(xpad[:, k: k + s] * w[k][None, None, :] for k in range(k_conv))
    xc = xc + p["conv_b"].to(x.dtype)
    xc = F.silu(xc)
    new_conv_state = xpad[:, s:] if k_conv > 1 else pad

    proj = torch.einsum("bsi,ir->bsr", xc, p["x_proj"].to(x.dtype)).float()
    dt_r, Bm, Cm = proj[..., :r], proj[..., r: r + n], proj[..., r + n:]
    dt = F.softplus(torch.einsum("bsr,ri->bsi", dt_r, p["dt_proj"].float())
                    + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    Dv = p["D"].float()
    u32 = xc.float()

    args = (u32, dt, A, Bm, Cm, Dv)
    if use_kernel:
        # the kernel is forward only: where a gradient is wanted, take the
        # op whose backward is the plain chunked scan's
        wants_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in args + (ssm_state,) if t is not None)
        if wants_grad:
            y, h_last = ms_ops.mamba_scan_with_ref_vjp(*args, h0=ssm_state,
                                                       chunk=chunk)
        else:
            y, h_last = ms_ops.mamba_scan(*args, h0=ssm_state)
    else:
        y, h_last = ssm_scan_chunked(*args, h0=ssm_state, chunk=chunk)
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"].to(x.dtype))
    if return_state:
        return out, new_conv_state, h_last
    return out


def mamba_decode(x: torch.Tensor, p: dict, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) single-token recurrence.  x (B,1,D); conv_state (B,K-1,I);
    ssm_state (B,I,N) fp32.  Returns (out (B,1,D), new conv state, new ssm
    state); the inputs are not modified."""
    n = p["A_log"].shape[-1]
    r = p["dt_proj"].shape[0]

    xz = torch.einsum("bsd,di->bsi", x, p["in_proj"].to(x.dtype))
    xs, z = xz.chunk(2, dim=-1)                                  # (B,1,I)
    window = torch.cat([conv_state, xs], dim=1)                  # (B,K,I)
    xc = torch.einsum("bki,ki->bi", window, p["conv_w"].to(x.dtype))
    xc = F.silu(xc + p["conv_b"].to(x.dtype))                    # (B,I)
    new_conv_state = window[:, 1:]

    proj = torch.einsum("bi,ir->br", xc, p["x_proj"].to(x.dtype)).float()
    dt_r, Bm, Cm = proj[..., :r], proj[..., r: r + n], proj[..., r + n:]
    dt = F.softplus(torch.einsum("br,ri->bi", dt_r, p["dt_proj"].float())
                    + p["dt_bias"].float())                      # (B,I)
    A = -torch.exp(p["A_log"].float())                           # (I,N)
    u32 = xc.float()
    dA = torch.exp(dt[..., None] * A[None])                      # (B,I,N)
    dBu = dt[..., None] * Bm[:, None, :] * u32[..., None]
    h = dA * ssm_state + dBu                                     # (B,I,N)
    y = torch.einsum("bin,bn->bi", h, Cm) + u32 * p["D"].float()[None]
    y = (y.to(x.dtype) * F.silu(z[:, 0]))[:, None, :]            # (B,1,I)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"].to(x.dtype))
    return out, new_conv_state, h
