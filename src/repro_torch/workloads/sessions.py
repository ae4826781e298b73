"""Multi-turn chat sessions as diffusion workloads (the serving binding).

A serving request is a task whose inputs are the block-aligned prefix-chain
oids of its prompt (repro_torch.serve.kvcache) -- a correlated k-input join, so
the trace schema has carried it since v2.  A *session* is the correlation
structure that makes KV diffusion interesting:

  * every turn re-reads the session's system prompt pages (Zipf-shared
    across sessions: a handful of hot system prompts dominate, exactly the
    paper's hot-object skew);
  * turn j+1's prompt extends turn j's verbatim, so its chain is turn j's
    chain plus ``turn_blocks`` new pages -- the monotone prefix property
    the tests lock;
  * turns are spaced ``think_time_s`` apart on the session's own clock
    while sessions arrive open-loop (diurnal by default), which is what
    drives the DRP's grow-AND-shrink story.

Sizing: one chain oid == one KV *page* of ``block * kv_bytes_per_token``
bytes (see repro_torch.serve.router's sizing note); ``model=`` derives
kv_bytes_per_token from a real ModelConfig via
``repro_torch.serve.kvcache.kv_bytes_per_token(get_config(model))``.

``SESSIONS`` / :func:`build_sessions` mirror the DAGS registry so
``WorkloadSpec.sessions = {"kind": "chat", ...}`` and ``mk_workload
--sessions`` share one construction path.

A copy of the reference's ``repro.workloads.sessions``: the same binding
and seed give the same requests, pages and arrival times in both packages.
"""
from __future__ import annotations

import random
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.objects import DataObject
from repro_torch.serve.kvcache import prefix_chain

from .arrivals import ARRIVALS
from .workload import TaskEvent, Workload

#: default open-loop demand: a compressed day, ~10x peak/trough swing
DEFAULT_ARRIVALS = {"kind": "DiurnalArrivals", "peak_rate": 2.0,
                    "trough_rate": 0.2, "day_s": 240.0}

_VOCAB = 32_000


@dataclass
class SessionModel:
    """Deterministic generator of multi-turn session workloads.

    Every token, arrival time and Zipf draw is a pure function of ``seed``
    (string-seeded ``random.Random`` streams, PYTHONHASHSEED-independent),
    so two ``generate()`` calls are bit-identical -- the property trace
    record/replay and the bench canaries rely on.
    """

    name: str = "sess"
    n_sessions: int = 64
    turns_per_session: int = 3
    n_system_prompts: int = 8
    zipf_s: float = 1.1              # Zipf skew over system prompts
    system_prompt_blocks: int = 4    # blocks in each system prompt
    turn_blocks: int = 2             # new blocks appended per turn
    block: int = 64                  # tokens per KV page
    model: Optional[str] = None      # arch id -> kv_bytes_per_token(cfg)
    kv_bytes_per_token: int = 4096   # used when model is None
    think_time_s: float = 4.0        # gap between a session's turns
    turn_seconds: float = 0.05       # compute per turn (decode proxy)
    arrivals: dict = field(default_factory=lambda: dict(DEFAULT_ARRIVALS))
    seed: int = 0

    def __post_init__(self) -> None:
        if self.n_sessions < 1:
            raise ValueError("sessions: need n_sessions >= 1")
        if self.turns_per_session < 1:
            raise ValueError("sessions: need turns_per_session >= 1")
        if self.n_system_prompts < 1:
            raise ValueError("sessions: need n_system_prompts >= 1")
        if self.system_prompt_blocks < 1 or self.turn_blocks < 1:
            raise ValueError("sessions: need >= 1 block per prompt and turn")
        if self.block < 1:
            raise ValueError("sessions: need block >= 1")
        if self.zipf_s < 0:
            raise ValueError("sessions: need zipf_s >= 0")
        kind = self.arrivals.get("kind")
        if kind not in ARRIVALS:
            raise ValueError(f"sessions: unknown arrivals kind {kind!r} "
                             f"(known: {sorted(ARRIVALS)})")

    # ------------------------------------------------------------------
    @property
    def kv_bpt(self) -> int:
        if self.model is not None:
            from repro_torch.configs import get_config
            from repro_torch.serve.kvcache import kv_bytes_per_token
            return max(kv_bytes_per_token(get_config(self.model)), 1)
        return self.kv_bytes_per_token

    @property
    def page_bytes(self) -> int:
        return self.block * self.kv_bpt

    def _system_prompt(self, p: int) -> list[int]:
        rng = random.Random(f"{self.seed}:sys:{p}")
        n = self.system_prompt_blocks * self.block
        return [rng.randrange(_VOCAB) for _ in range(n)]

    def _conversation(self, sid: int) -> list[int]:
        rng = random.Random(f"{self.seed}:conv:{sid}")
        n = self.turns_per_session * self.turn_blocks * self.block
        return [rng.randrange(_VOCAB) for _ in range(n)]

    def _zipf_cdf(self) -> list[float]:
        weights = [1.0 / (r ** self.zipf_s)
                   for r in range(1, self.n_system_prompts + 1)]
        total = sum(weights)
        acc, cdf = 0.0, []
        for w in weights:
            acc += w / total
            cdf.append(acc)
        cdf[-1] = 1.0
        return cdf

    # ------------------------------------------------------------------
    def generate(self) -> Workload:
        binding = self.arrivals
        proc = ARRIVALS[binding["kind"]](
            **{k: v for k, v in binding.items() if k != "kind"})
        starts = list(proc.times(self.n_sessions, self.seed))
        cdf = self._zipf_cdf()
        zrng = random.Random(f"{self.seed}:zipf")
        sys_prompts = [self._system_prompt(p)
                       for p in range(self.n_system_prompts)]

        page = self.page_bytes
        objects: dict[str, DataObject] = {}
        events: list[tuple[tuple, TaskEvent]] = []
        for sid, start in enumerate(starts):
            p = bisect_left(cdf, zrng.random())
            full = sys_prompts[p] + self._conversation(sid)
            # ONE chain over the session's final prompt; turn j's prompt is
            # a block-aligned prefix of it, so turn j's chain is exactly the
            # first (system_prompt_blocks + j*turn_blocks) entries.
            chain = prefix_chain(full, self.block)
            for oid in chain:
                if oid not in objects:
                    objects[oid] = DataObject(oid, page)
            for j in range(1, self.turns_per_session + 1):
                n_pages = self.system_prompt_blocks + j * self.turn_blocks
                events.append((
                    (start + (j - 1) * self.think_time_s, sid, j),
                    TaskEvent(
                        t=start + (j - 1) * self.think_time_s,
                        tid=f"{self.name}-s{sid}.t{j}",
                        inputs=tuple(chain[:n_pages]),
                        compute_seconds=self.turn_seconds)))
        events.sort(key=lambda e: e[0])
        return Workload(name=self.name,
                        objects=list(objects.values()),
                        events=[ev for _, ev in events],
                        spec=self.spec())

    def spec(self) -> dict:
        """Round-trippable binding: build_sessions(spec()) regenerates the
        identical workload."""
        return {
            "kind": "chat", "name": self.name,
            "n_sessions": self.n_sessions,
            "turns_per_session": self.turns_per_session,
            "n_system_prompts": self.n_system_prompts,
            "zipf_s": self.zipf_s,
            "system_prompt_blocks": self.system_prompt_blocks,
            "turn_blocks": self.turn_blocks,
            "block": self.block,
            "model": self.model,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "think_time_s": self.think_time_s,
            "turn_seconds": self.turn_seconds,
            "arrivals": dict(self.arrivals),
            "seed": self.seed,
        }


def chat_sessions(name: str = "sess", **kw) -> Workload:
    """Functional entry point (the SESSIONS registry target)."""
    return SessionModel(name=name, **kw).generate()


#: registry for the experiment-spec binding (WorkloadSpec.sessions =
#: {"kind": "chat", ...}), mirroring DAGS / ARRIVALS / POPULARITY
SESSIONS = {"chat": chat_sessions}


def build_sessions(binding: dict, **overrides) -> Workload:
    """Materialise a ``{"kind": ..., ...kwargs}`` session binding;
    ``overrides`` win (the spec's workload name, typically)."""
    kind = binding.get("kind")
    if kind not in SESSIONS:
        raise ValueError(
            f"unknown sessions kind {kind!r} (known: {sorted(SESSIONS)})")
    kw = {k: v for k, v in binding.items() if k != "kind"}
    kw.update(overrides)
    return SESSIONS[kind](**kw)
