"""Plain PyTorch versions of the selective scan.

``mamba_scan_ref`` is the oracle the kernel is held to: a loop over the
sequence on (B, I, N) fp32 tensors, in the order of the reference's oracle
and kernel.  ``ssm_scan`` and ``ssm_scan_chunked`` are the reference
model's own plain scan (``repro.models.mamba._ssm_scan`` and the chunked
loop around it), the math that training differentiates."""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def mamba_scan_ref(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """u, dt (B,S,I); A (I,N); Bm, Cm (B,S,N); D (I,); h0 (B,I,N) or None
    (a zero state).  Returns (y (B,S,I) in u's dtype, h_last (B,I,N) fp32).

    Per step: ``dA = exp(dt·A)``, ``dBu = (dt·u)·B``, ``h = dA·h + dBu``,
    ``y = Σ_n h·C + u·D``, all in fp32."""
    b, s, i = u.shape
    n = A.shape[1]
    A, D = A.float(), D.float()
    h = (torch.zeros((b, i, n), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(s):
        u_t, dt_t = u[:, t].float(), dt[:, t].float()          # (B, I)
        dA = torch.exp(dt_t[..., None] * A[None])              # (B, I, N)
        dBu = (dt_t * u_t)[..., None] * Bm[:, t, None, :].float()
        h = dA * h + dBu
        ys.append(torch.einsum("bin,bn->bi", h, Cm[:, t].float())
                  + u_t * D[None])
    return torch.stack(ys, dim=1).to(u.dtype), h


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan, the reference model's plain form.  u, dt (B,S,I);
    A (I,N); Bm, Cm (B,S,N); D (I,).  Returns (y (B,S,I), h_last (B,I,N)).

    dA and dBu are formed for the whole sequence at once, then a loop over
    time; dBu in the order ``dt·B·u`` (the kernel's is ``(dt·u)·B``).  The
    loop walks ``unbind``'s views: its backward stacks one gradient for
    all steps, where indexing ``dA[:, t]`` would zero-fill a full-size one
    per step."""
    b, s, i = u.shape
    h = (torch.zeros((b, i, A.shape[1]), dtype=torch.float32,
                     device=u.device) if h0 is None else h0)
    dA = torch.exp(dt[..., None] * A[None, None])                # (B,S,I,N)
    dBu = dt[..., None] * Bm[:, :, None, :] * u[..., None]       # (B,S,I,N)
    hs = []
    for dA_t, dBu_t in zip(dA.unbind(1), dBu.unbind(1)):
        h = dA_t * h + dBu_t
        hs.append(h)
    y = torch.einsum("bsin,bsn->bsi", torch.stack(hs, dim=1), Cm) \
        + u * D[None, None]
    return y, h


def chunk_slices(s: int, chunk: int) -> list[slice]:
    """The sequence cut into chunks of ``chunk`` steps (the last one may be
    shorter); ``chunk`` 0 is one chunk."""
    step = min(chunk, s) if chunk > 0 else s
    return [slice(s0, min(s0 + step, s)) for s0 in range(0, s, step)]


def ssm_scan_chunked(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                     h0: Optional[torch.Tensor] = None, chunk: int = 256
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssm_scan` over chunks of ``chunk`` steps, the state carried
    across: one chunk's (B, L, I, N) fp32 intermediates live at a time.
    Where a gradient is wanted each chunk runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so the
    backward too holds one chunk's, not all of them."""
    h = h0
    ys = []
    grad = torch.is_grad_enabled()
    for sl in chunk_slices(u.shape[1], chunk):
        args = (u[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl], D, h)
        if grad:
            y_c, h = checkpoint(ssm_scan, *args, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            y_c, h = ssm_scan(*args)
        ys.append(y_c)
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)), h
