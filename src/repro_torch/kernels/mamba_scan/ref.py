"""Plain PyTorch version of the selective-scan kernel (the oracle it is held
to): a loop over the sequence on (B, I, N) fp32 tensors, in the order of the
reference's oracle and kernel."""
from __future__ import annotations

from typing import Optional

import torch


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
