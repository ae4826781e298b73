"""Mixture-of-Experts layer (GShard/Switch-style capacity routing).

The port of the reference's ``repro.models.moe``.  A top-k softmax router
with renormalised gates; each expert takes at most ``capacity`` (token,
choice) pairs, in token-major order, and the pairs past it are dropped;
gated (or plain) expert MLPs; the Switch load-balancing aux loss.

:func:`moe_block` computes what the reference's one-hot ``moe_block``
computes, but dispatches with the reference's own sort+gather routing
(``_local_route``/``_combine``), so no (tokens, experts, capacity) one-hot
tensor is formed.  A stable sort keeps each expert's pairs in token-major
order, which is the order of the reference's cumsum, so the same pairs are
dropped.  :func:`moe_block_onehot` is the reference's literal one-hot
einsum formulation: the plain version that ``moe_block`` is held against.
The expert products run as batched matmuls over (experts, capacity, ·):
the reference has no Pallas kernel here.

Left out: the mesh (``moe_block_sharded`` keeps only its no-mesh fallback)
and the ``rules``/``shard`` arguments of the layer; the leaves' logical
axes are :data:`MOE_LOGICAL`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _activate


def moe_param_shapes(d_model: int, d_ff: int, n_experts: int,
                     gated: bool) -> dict[str, tuple[int, ...]]:
    """Leaf name -> shape of one MoE layer's parameters (the caller adds
    the leading layer-stack dim)."""
    shapes = {
        "w_router": (d_model, n_experts),
        "w_up": (n_experts, d_model, d_ff),
        "w_down": (n_experts, d_ff, d_model),
    }
    if gated:
        shapes["w_gate"] = (n_experts, d_model, d_ff)
    return shapes


#: each leaf's logical sharding axes (the reference's, from its
#: ``moe_param_shapes``)
MOE_LOGICAL = {
    "w_router": (None, None),
    "w_up": ("expert", "fsdp", "tp"),
    "w_down": ("expert", "tp", "fsdp"),
    "w_gate": ("expert", "fsdp", "tp"),
}


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """The reference's slots per expert: k·cf·⌈T/E⌉, at least 1."""
    return int(max(top_k * capacity_factor
                   * ((n_tokens + n_experts - 1) // n_experts), 1))


def _router_softmax(xt: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """(T, E) fp32 router probabilities."""
    logits = torch.einsum("td,de->te", xt.float(), w_router.float())
    return torch.softmax(logits, dim=-1)


def _top_k(probs: torch.Tensor, top_k: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    gates, idx = torch.topk(probs, top_k, dim=-1)
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx


def router_probs(x: torch.Tensor, w_router: torch.Tensor, top_k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (gates (T, k) fp32 renormalised, idx (T, k) int64)."""
    return _top_k(_router_softmax(x, w_router), top_k)


def _expert_counts(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Pairs routed to each expert (before drops).  A scatter-add, not
    ``bincount``, which waits for the card to size its output."""
    return torch.zeros(n_experts, dtype=torch.long,
                       device=flat_e.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))


def _local_route(xt: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
                 E: int, capacity: int):
    """Sort+gather dispatch.  xt (T, D); gates/idx (T, K).  Returns
    (disp (E, C, D), combine info): each expert's first ``capacity`` pairs
    in token-major order, zeros in the empty slots; the info is, per pair,
    its expert, its slot (clipped) and whether it is within capacity.
    ``gates`` is not read (the reference's signature)."""
    T, _ = xt.shape
    K = idx.shape[1]
    dev = xt.device
    flat_e = idx.reshape(-1)                                     # (T*K,)
    # stable: each expert's pairs stay in token-major order, the order of
    # the reference's cumsum, so the same pairs fall past capacity
    order = torch.argsort(flat_e, stable=True)
    counts = _expert_counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    slots = torch.arange(capacity, device=dev)
    src = starts[:, None] + slots[None, :]                       # (E, C)
    valid = slots[None, :] < torch.clamp_max(counts, capacity)[:, None]
    pair = order[src.clamp(0, T * K - 1)]                        # (E, C)
    disp = xt[pair // K] * valid[..., None].to(xt.dtype)         # (E, C, D)
    # combine side: each pair's position within its expert's run
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, device=dev))
    c_of_pair = inv - starts[flat_e]                             # (T*K,)
    in_cap = c_of_pair < capacity
    return disp, (flat_e, c_of_pair.clamp(0, capacity - 1), in_cap)


def _combine(expert_out: torch.Tensor, combine_info, gates: torch.Tensor,
             T: int, K: int) -> torch.Tensor:
    """expert_out (E, C, D) -> (T, D): each token's kept pairs, weighted by
    their gates (cast to the experts' dtype first) and summed."""
    flat_e, c_of_pair, in_cap = combine_info
    picked = expert_out[flat_e, c_of_pair]                       # (T*K, D)
    picked = picked * in_cap[:, None].to(picked.dtype)
    picked = picked.reshape(T, K, -1)
    return torch.einsum("tk,tkd->td", gates.to(picked.dtype), picked)


def _experts(ex_in: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """(E, C, D) -> (E, C, D): each expert's MLP on its slots, as batched
    matmuls in ex_in's dtype.  Presence of p["w_gate"] selects gated."""
    dt = ex_in.dtype
    if "w_gate" in p:
        g = torch.bmm(ex_in, p["w_gate"].to(dt))
        u = torch.bmm(ex_in, p["w_up"].to(dt))
        h = _activate(g, act) * u
    else:
        h = _activate(torch.bmm(ex_in, p["w_up"].to(dt)), act)
    return torch.bmm(h, p["w_down"].to(dt))


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, E: int,
              top_k: int) -> torch.Tensor:
    """Switch load balancing, E·Σ_e f_e·P_e / k: f_e the share of tokens
    routed to e (before drops), P_e the mean router probability."""
    T = probs.shape[0]
    me = _expert_counts(idx.reshape(-1), E).float() / T
    pe = probs.mean(0)
    return E * torch.sum(me * pe) / top_k


def moe_block(x: torch.Tensor, p: dict, top_k: int, act: str = "silu",
              capacity_factor: float = 1.25
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D); p holds w_router (D, E), w_gate/w_up (E, D, F), w_down
    (E, F, D).  Returns (output (B, S, D), aux loss, a 0-dim fp32 tensor)."""
    B, S, D = x.shape
    E = p["w_router"].shape[-1]
    T = B * S
    xt = x.reshape(T, D)
    probs = _router_softmax(xt, p["w_router"])
    gates, idx = _top_k(probs, top_k)
    disp, info = _local_route(xt, gates, idx, E,
                              capacity(T, E, top_k, capacity_factor))
    out = _combine(_experts(disp, p, act), info, gates, T, top_k)
    return out.reshape(B, S, D), _aux_loss(probs, idx, E, top_k)


def moe_block_onehot(x: torch.Tensor, p: dict, top_k: int,
                     act: str = "silu", capacity_factor: float = 1.25
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``moe_block`` as it is written: queue positions from
    a cumsum over the (token, choice) pairs, the overflow's gates zeroed,
    dispatch and combine as one-hot einsums over a (T, E, capacity) tensor
    in x's dtype.  The plain version :func:`moe_block` is held against; it
    routes alike (the same ``router_probs``), so the two drop the same
    pairs."""
    B, S, D = x.shape
    E = p["w_router"].shape[-1]
    T = B * S
    xt = x.reshape(T, D)
    probs = _router_softmax(xt, p["w_router"])
    gates, idx = _top_k(probs, top_k)
    cap = capacity(T, E, top_k, capacity_factor)
    onehot = F.one_hot(idx, E)                                  # (T, k, E)
    flat = onehot.reshape(T * top_k, E)
    pos = (torch.cumsum(flat, 0) - flat).reshape(T, top_k, E)
    pos = (pos * onehot).sum(-1)                                # (T, k)
    keep = pos < cap
    gates = gates * keep.to(gates.dtype)
    slot_oh = F.one_hot(torch.where(keep, pos, cap), cap + 1).to(
        x.dtype)[..., :cap]                                     # (T, k, C)
    oh = onehot.to(x.dtype)
    dispatch = torch.einsum("tke,tkc->tec", oh, slot_oh)
    combine = torch.einsum("tk,tke,tkc->tec", gates.to(x.dtype), oh, slot_oh)
    ex_in = torch.einsum("tec,td->ecd", dispatch, xt)
    out = torch.einsum("tec,ecd->td", combine, _experts(ex_in, p, act))
    return out.reshape(B, S, D), _aux_loss(probs, idx, E, top_k)


def moe_block_sharded(x: torch.Tensor, p: dict, cfg
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's entry point, without a mesh: :func:`moe_block` at
    the config's top-k, activation and capacity factor."""
    return moe_block(x, p, cfg.top_k, cfg.mlp_act, cfg.capacity_factor)
