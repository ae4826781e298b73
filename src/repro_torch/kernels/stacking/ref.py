"""Plain PyTorch version of the stacking kernel (the oracle it is held to)."""
from __future__ import annotations

import torch


def stack_rois_ref(rois: torch.Tensor, sky: torch.Tensor, cal: torch.Tensor,
                   dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """rois (N,H,W); sky/cal/dy/dx (N,). Returns the (H,W) fp32 coadd.

    Each ROI is calibrated, ``img = (roi - sky) * cal``, shifted by the
    bilinear weights of (dy, dx) over ``img`` and its one-pixel shifts down,
    right and down-right -- the shifts repeat row 0 / column 0 at the edge --
    and the N shifted images are summed."""
    img = (rois.float() - sky[:, None, None]) * cal[:, None, None]
    down = torch.cat([img[:, :1], img[:, :-1]], dim=1)
    right = torch.cat([img[:, :, :1], img[:, :, :-1]], dim=2)
    downright = torch.cat([down[:, :, :1], down[:, :, :-1]], dim=2)
    w00 = ((1 - dy) * (1 - dx))[:, None, None]
    w01 = ((1 - dy) * dx)[:, None, None]
    w10 = (dy * (1 - dx))[:, None, None]
    w11 = (dy * dx)[:, None, None]
    shifted = w00 * img + w01 * right + w10 * down + w11 * downright
    return shifted.sum(dim=0)
