"""Batched serving engine: prefill + decode over the model substrate, with
prefix-aware routing across replicas.

The port of the reference's ``repro.serve.engine``.  Single process, R
logical replicas of one model sharing one set of weights: requests are
routed by PrefixAwareRouter, the wave's full forward runs (on the card its
attention is the hand-written flash kernel when ``cfg.attn_impl`` is
``"flash"``, and its Mamba layers' scan the hand-written scan kernel when
``cfg.use_mamba_kernel``), the KV/state cache is filled by replaying the
prompt through the decode step, and the batch is decoded greedily -- all
as the reference does.  Beyond the reference, each wave leaves a :class:`WaveRecord`: the
forward's and the replay's logits at every request's last prompt position
(the two must agree), and the wave's times.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cache import EvictionPolicy
from repro_torch.core.policies import DispatchPolicy
from repro_torch.device import resolve_device
from repro_torch.models import (init_cache, init_params, make_forward,
                                make_serve_step)
from repro_torch.models.config import ModelConfig
from .kvcache import kv_bytes_per_token
from .router import PrefixAwareRouter, RouteResult


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    output: list[int] = field(default_factory=list)
    replica: str = ""
    reused_tokens: int = 0


@dataclass
class WaveRecord:
    """One ``generate`` call: its padded tokens (B, max_seq), prompt
    lengths, the forward's and the replay's logits (B, V) at each request's
    last prompt position, and host-clock seconds of the forward, the replay
    and the greedy decode (each ends in a synchronise on the card)."""
    tokens: torch.Tensor
    lens: list[int]
    prefill_logits: torch.Tensor
    replay_logits: torch.Tensor
    forward_s: float
    replay_s: float
    replay_steps: int
    decode_s: float
    decode_steps: int


class ServeEngine:
    """R logical replicas sharing one set of weights (single process).

    ``device`` is where the model runs (``cuda`` unless the caller asks for
    the CPU).  ``params`` are used as given (a test hands in converted
    reference weights); otherwise the weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` on the device."""

    def __init__(self, cfg: ModelConfig, n_replicas: int = 2,
                 policy: DispatchPolicy = DispatchPolicy.MAX_COMPUTE_UTIL,
                 cache_policy: EvictionPolicy = EvictionPolicy.LRU,
                 replica_cache_bytes: int = 1 << 26,
                 max_seq: int = 256, seed: int = 0,
                 device: str | torch.device = "cuda",
                 params: Optional[dict] = None) -> None:
        self.cfg = cfg
        self.max_seq = max_seq
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(self.device).manual_seed(seed)
            params = init_params(cfg, gen, self.device)
        self.params = params
        self.router = PrefixAwareRouter(
            n_replicas, policy, cache_policy, replica_cache_bytes,
            kv_bytes_per_token=max(kv_bytes_per_token(cfg), 1),
            block=16, slots_per_replica=8)
        self._fwd = make_forward(cfg)
        self._step = make_serve_step(cfg)
        self.prefill_tokens = 0
        self.reused_tokens = 0
        self.waves: list[WaveRecord] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- greedy generation for a batch of requests ------------------------
    @torch.inference_mode()
    def generate(self, requests: Sequence[Request]) -> list[Request]:
        for r in requests:
            route = self.router.route(r.prompt)
            r.replica = route.replica
            r.reused_tokens = route.reused_prefix_tokens
            self.reused_tokens += route.reused_prefix_tokens
            # prefill cost is only the non-reused suffix (the paper's
            # cache-hit economics: bytes NOT refetched == tokens NOT recomputed)
            self.prefill_tokens += max(len(r.prompt) - route.reused_prefix_tokens, 0)
        # batch all requests together (single-process simplification)
        B = len(requests)
        S = self.max_seq
        toks_np = np.zeros((B, S), np.int64)
        lens = [len(r.prompt) for r in requests]
        for i, r in enumerate(requests):
            toks_np[i, : lens[i]] = r.prompt
        toks = torch.from_numpy(toks_np).to(self.device)
        rows = torch.arange(B, device=self.device)
        last = torch.tensor([n - 1 for n in lens], device=self.device)
        t0 = time.perf_counter()
        logits, _ = self._fwd(self.params, {"tokens": toks})
        prefill_logits = logits[rows, last]
        self._sync()
        t1 = time.perf_counter()
        cache = init_cache(self.cfg, B, S, device=self.device)
        # prefill the cache by replaying tokens through serve_step (keeps
        # one decode path -- checked against the forward's logits)
        replay_logits = torch.zeros_like(prefill_logits)
        pos_logits = None
        for t in range(max(lens)):
            pos_logits, cache = self._step(self.params, cache,
                                           {"token": toks[:, t: t + 1],
                                            "pos": t})
            ending = [i for i, n in enumerate(lens) if n == t + 1]
            if ending:
                replay_logits[ending] = pos_logits[ending, -1]
        self._sync()
        t2 = time.perf_counter()
        # greedy decode
        cur = torch.argmax(pos_logits[:, -1], dim=-1)
        max_new = max(r.max_new_tokens for r in requests)
        steps = 0
        for j in range(max_new):
            cur_host = cur.tolist()
            for i, r in enumerate(requests):
                if j < r.max_new_tokens:
                    r.output.append(cur_host[i])
            pos = max(lens) + j
            if pos >= S:
                break
            lg, cache = self._step(self.params, cache,
                                   {"token": cur[:, None], "pos": pos})
            cur = torch.argmax(lg[:, -1], dim=-1)
            steps += 1
        self._sync()
        t3 = time.perf_counter()
        self.waves.append(WaveRecord(
            tokens=toks, lens=lens, prefill_logits=prefill_logits,
            replay_logits=replay_logits, forward_s=t1 - t0,
            replay_s=t2 - t1, replay_steps=max(lens), decode_s=t3 - t2,
            decode_steps=steps))
        for r in requests:
            self.router.complete(r.prompt, RouteResult(
                replica=r.replica, reused_prefix_tokens=r.reused_tokens,
                reused_bytes=0))
        return list(requests)
