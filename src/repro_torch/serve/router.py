"""Prefix-cache-aware request routing = the paper's data-aware scheduling
applied to serving replicas.

A copy of the reference's ``repro.serve.router`` on the port's ``core``
(cache, index, policies), kept line for line so both route alike; the
reference's Dispatcher-twin regression lock (``serve/diffusion``) waits for
the sessions slice.

Mapping (DESIGN.md §2/§12): replica == executor, cached prefix-KV page ==
cached file, request == task whose inputs are the block-aligned prefixes of
its prompt.  The four dispatch policies transfer verbatim:

  first-available       round-robin-ish, no prefix reuse information
  first-cache-available route anywhere but ship prefix locations (replica
                        may pull KV from a peer replica)
  max-cache-hit         wait for the replica with the longest cached prefix
  max-compute-util      among FREE replicas pick the longest cached prefix
                        (modern prefix-aware load balancing)

Scoring is delegated wholesale to
:func:`repro_torch.core.policies.decide` -- the SAME pure function the
Dispatcher's ``_dispatch_mcu`` reduces to for a single queued task -- so
the router cannot drift from core policy semantics (in the reference,
regression-locked against a real Dispatcher).  Tie-break order matches
``_dispatch_mcu``: cached bytes descending, then overlap fraction, then
queue position.  For ONE prompt the overlap-fraction denominator (the
task's own input byte total) is the same at every replica, so that middle
tie-break is vacuous here and ties fall through to position --
``decide``'s first-max over replicas in registration order, exactly the
dispatcher's ``_exec_order``.

Sizing: each prefix-chain oid is ONE KV *page* of ``block *
kv_bytes_per_token`` bytes (the vLLM paged-KV shape: the page is
content-addressed by the whole prefix up to its block, but stores only that
block's KV).  A replica caching an m-page chain therefore scores exactly
m * page_bytes == the KV bytes a hit actually reuses.  (The previous
cumulative sizing -- page i sized as the whole i-block prefix -- double-
counted shared blocks O(m^2) and skewed every policy toward long chains.)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from repro_torch.core.cache import EvictionPolicy, ExecutorCache
from repro_torch.core.index import LocationIndex
from repro_torch.core.objects import DataObject, Task
from repro_torch.core.policies import DispatchPolicy, decide
from .kvcache import prefix_chain


@dataclass
class ReplicaState:
    rid: str
    cache: ExecutorCache
    busy: int = 0
    slots: int = 4
    served: int = 0

    @property
    def available(self) -> bool:
        return self.busy < self.slots


@dataclass
class RouteResult:
    replica: str
    reused_prefix_tokens: int
    reused_bytes: int
    hints: dict[str, tuple[str, ...]] = field(default_factory=dict)


class PrefixAwareRouter:
    def __init__(
        self,
        n_replicas: int,
        policy: DispatchPolicy = DispatchPolicy.MAX_COMPUTE_UTIL,
        cache_policy: EvictionPolicy = EvictionPolicy.LRU,
        replica_cache_bytes: int = 1 << 30,
        kv_bytes_per_token: int = 1 << 12,
        block: int = 64,
        slots_per_replica: int = 4,
    ) -> None:
        self.policy = policy
        self.block = block
        self.kv_bpt = kv_bytes_per_token
        self.index = LocationIndex()
        self.replicas: dict[str, ReplicaState] = {}
        self.sizes: dict[str, int] = {}
        self._order: list[str] = []
        for i in range(n_replicas):
            rid = f"r{i}"
            self.replicas[rid] = ReplicaState(
                rid, ExecutorCache(replica_cache_bytes, cache_policy, seed=i),
                slots=slots_per_replica)
            self._order.append(rid)

    @property
    def page_bytes(self) -> int:
        """KV bytes of one prefix page (== one chain oid)."""
        return self.block * self.kv_bpt

    # ------------------------------------------------------------------
    def route(self, prompt: Sequence[int]) -> RouteResult:
        """Pick a replica for a prompt; caller must later call
        ``complete`` with the same result."""
        oids = prefix_chain(prompt, self.block)
        for oid in oids:
            self.sizes.setdefault(oid, self.page_bytes)
        task = Task(inputs=tuple(oids))
        avail = [r for r in self._order if self.replicas[r].available]
        busy = [r for r in self._order if not self.replicas[r].available]
        d = decide(self.policy, task, avail, busy, self.index, self.sizes)
        # decide() may return neither an executor nor a wait_for target
        # (every replica saturated under FA/FCA/MCU, or nothing cached and
        # nobody free under MCH).  A serving front-end cannot leave the
        # request unplaced, so fall back to the least-loaded replica
        # (registration order breaks ties) -- NOT r0, which would pile the
        # whole overload onto one replica.
        rid = d.executor or d.wait_for or self._least_busy()
        rep = self.replicas[rid]
        rep.busy += 1
        # longest cached block-prefix ON the chosen replica
        reused = 0
        for i, oid in enumerate(oids):
            if oid in rep.cache:
                rep.cache.get(oid)  # recency touch
                reused = (i + 1) * self.block
            else:
                break
        return RouteResult(replica=rid, reused_prefix_tokens=reused,
                           reused_bytes=reused * self.kv_bpt, hints=d.hints)

    def _least_busy(self) -> str:
        """Overload fallback: fewest in-flight requests, ties by
        registration order (min() keeps the first minimum)."""
        return min(self._order, key=lambda r: self.replicas[r].busy)

    def complete(self, prompt: Sequence[int], result: RouteResult) -> None:
        """Request finished: register the full prefix chain in the
        replica's cache + the central index (loose coherence)."""
        rep = self.replicas[result.replica]
        rep.busy = max(rep.busy - 1, 0)
        rep.served += 1
        for oid in prefix_chain(prompt, self.block):
            evicted = rep.cache.put(DataObject(oid, self.sizes[oid]))
            self.index.insert(oid, rep.rid)
            for ev in evicted:
                self.index.remove(ev, rep.rid)

    # ------------------------------------------------------------------
    def reference_scores(self, prompt: Sequence[int]) -> dict[str, int]:
        """Brute-force replica -> cached-input-bytes for ``prompt``,
        rebuilt from fresh index lookups -- the router-side analogue of
        ``Dispatcher.reference_scores()`` and the oracle the regression
        lock compares against."""
        scores = {rid: 0 for rid in self._order}
        for oid in dict.fromkeys(prefix_chain(prompt, self.block)):
            sz = self.sizes.get(oid, 1)
            for rid in self.index.lookup(oid):
                if rid in scores:
                    scores[rid] += sz
        return scores

    def stats(self) -> dict:
        served = sum(r.served for r in self.replicas.values())
        return {
            "served": served,
            "per_replica": {r.rid: r.served for r in self.replicas.values()},
            "index_entries": len(self.index),
        }
