"""Optimizers built from scratch: AdamW and a factored-second-moment
Adafactor-style variant for memory-tight very-large configs.

The port of the reference's ``repro.train.optimizer``, with its exact
math: each op of the update runs in fp32 in the reference's order, and the
new parameter is cast back to its dtype.  Two departures, neither of which
changes a result:

  * ``apply`` updates the state's tensors in place and returns a state
    holding them (the reference returns new arrays; its train step donates
    the old ones);
  * a leaf with a leading layer axis (ndim >= 3) is updated one layer
    slice at a time.  Every op is elementwise, or a mean over the last two
    axes for the factored v, so the slices give the whole leaf's result,
    and the fp32 temporaries are one layer's, not the stack's (at
    h2o-danube-3-4b's widths a stacked MLP leaf is 3.8 GB in fp32).

State layout mirrors the param tree (``m``, and ``v`` or its factored
pair, per leaf).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.models.transformer import flatten, unflatten

PyTree = Any


class TrainState(NamedTuple):
    step: torch.Tensor       # 0-dim int32, on the host
    params: PyTree
    m: PyTree                # first moment (fp32)
    v: PyTree                # second moment (fp32; factored => tuple leaves)


@dataclass(frozen=True)
class Optimizer:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    factored: bool = False    # Adafactor-style factored v for 2D+ params

    # ------------------------------------------------------------------
    def init(self, params: PyTree) -> TrainState:
        pairs = flatten(params)
        m = unflatten((k, _zeros(p.shape, p)) for k, p in pairs)
        v = unflatten((k, self._init_v(p)) for k, p in pairs)
        return TrainState(step=torch.zeros((), dtype=torch.int32),
                          params=params, m=m, v=v)

    def _init_v(self, p: torch.Tensor):
        if self.factored and p.dim() >= 2:
            return (_zeros(p.shape[:-1], p),
                    _zeros(p.shape[:-2] + p.shape[-1:], p))
        return _zeros(p.shape, p)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def apply(self, state: TrainState, grads: PyTree,
              gnorm: Optional[torch.Tensor] = None) -> TrainState:
        """One step.  ``gnorm`` is the grads' global norm where the caller
        has it already (the train step reports it)."""
        step = state.step + 1
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = torch.where(gnorm > self.grad_clip,
                            self.grad_clip / (gnorm + 1e-9), 1.0)
        lr = self.lr(step)
        bc1 = 1.0 - torch.pow(self.b1, step.to(torch.float32))
        bc2 = 1.0 - torch.pow(self.b2, step.to(torch.float32))
        pairs = flatten(state.params)
        flat_g = dict(flatten(grads))
        flat_m = dict(flatten(state.m))
        flat_v = dict(flatten(state.v))   # a factored pair is one leaf
        for path, p in pairs:
            decay = p.dim() >= 2   # decoupled weight decay on matrices only
            g, m, v = flat_g[path], flat_m[path], flat_v[path]
            if p.dim() >= 3:       # a stack of layers: one slice at a time
                for i in range(p.shape[0]):
                    vi = (v[0][i], v[1][i]) if isinstance(v, tuple) else v[i]
                    self._update(p[i], g[i], m[i], vi, decay, scale, lr,
                                 bc1, bc2)
            else:
                self._update(p, g, m, v, decay, scale, lr, bc1, bc2)
        return TrainState(step=step, params=state.params, m=state.m,
                          v=state.v)

    def _update(self, p, g, m, v, decay, scale, lr, bc1, bc2) -> None:
        """The reference's ``upd`` on one leaf (or layer slice), in place."""
        g = g.float() * scale
        m.mul_(self.b1).add_(g * (1 - self.b1))
        if isinstance(v, tuple):
            gg = g * g
            vr, vc = v
            vr.mul_(self.b2).add_(gg.mean(-1) * (1 - self.b2))
            vc.mul_(self.b2).add_(gg.mean(-2) * (1 - self.b2))
            rmean = vr.mean(-1, keepdim=True)
            vhat = (vr[..., None] * vc[..., None, :]
                    / torch.clamp_min(rmean[..., None], 1e-30)) / bc2
        else:
            v.mul_(self.b2).add_(g * (1 - self.b2) * g)
            vhat = v / bc2
        mhat = m / bc1
        delta = mhat / (torch.sqrt(vhat) + self.eps)
        if decay:
            delta = delta + self.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    # ------------------------------------------------------------------
    def state_logical(self, params_logical: PyTree) -> "TrainState":
        """Logical axes for TrainState given the params' logical tree
        (m like params; factored v drops the last / second-to-last axis)."""
        def v_logical(lg):
            if self.factored and len(lg) >= 2:
                return (lg[:-1], lg[:-2] + lg[-1:])
            return lg
        return TrainState(
            step=(),
            params=params_logical,
            m=params_logical,
            v=unflatten((k, v_logical(lg))
                        for k, lg in flatten(params_logical)),
        )


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of each leaf's fp32
    sum of squares; a stacked leaf is summed one layer slice at a time, so
    no fp32 copy of the whole stack is made."""
    total = None
    for _, g in flatten(tree):
        slices = g.unbind(0) if g.dim() >= 3 else (g,)
        for s in slices:
            sq = torch.sum(torch.square(s.float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw(peak_lr: float = 3e-4, warmup: int = 100, total: int = 10_000,
          **kw) -> Optimizer:
    from .schedule import warmup_cosine
    return Optimizer(lr=warmup_cosine(peak_lr, warmup, total), **kw)
