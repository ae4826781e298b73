"""Dynamic Resource Provisioner (DRP) -- Falkon §3.1.

Watches the dispatcher wait queue and grows/shrinks the executor pool with
tunable allocation policies (the Falkon provisioner exposes the same knobs):

  one-at-a-time   +1 executor per trigger
  additive        +k executors per trigger
  exponential     doubles the request size per consecutive trigger
  all-at-once     jump straight to max_executors

De-allocation: release executors idle longer than ``idle_timeout_s``
(down to ``min_executors``).  The paper's experiments hold the pool fixed
(\"do not investigate the effects of dynamic resource provisioning\"); the
microbenchmarks therefore run with allocation=all-at-once and releases
disabled.  The full grow/shrink cycle is driven end-to-end by the
open-loop sine-wave workloads (``DiffusionSim.submit_workload`` on the
simulated clock; ``experiments.engines._ProvisionerDriver`` on the threaded
runtime, whose released executors give their cached device tensors back).

Counterpart of ``repro.core.provisioner``, decision for decision.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class AllocationPolicy(enum.Enum):
    ONE_AT_A_TIME = "one-at-a-time"
    ADDITIVE = "additive"
    EXPONENTIAL = "exponential"
    ALL_AT_ONCE = "all-at-once"


@dataclass(slots=True)
class ProvisionerActions:
    allocate: int = 0
    release: list[str] = field(default_factory=list)


class DynamicResourceProvisioner:
    def __init__(
        self,
        min_executors: int = 0,
        max_executors: int = 64,
        policy: AllocationPolicy = AllocationPolicy.ALL_AT_ONCE,
        additive_k: int = 8,
        queue_threshold: int = 1,
        idle_timeout_s: float = 60.0,
        trigger_cooldown_s: float = 1.0,
        allocate_quantum: int = 1,
    ) -> None:
        if allocate_quantum < 1:
            raise ValueError("allocate_quantum must be >= 1")
        self.min_executors = min_executors
        self.max_executors = max_executors
        self.policy = policy
        self.additive_k = additive_k
        self.queue_threshold = queue_threshold
        self.idle_timeout_s = idle_timeout_s
        self.trigger_cooldown_s = trigger_cooldown_s
        # executors are acquired/released in multiples of this (the fleet
        # sets it to threads_per_host so grow/shrink moves whole hosts;
        # 1 = the classic per-executor behaviour, bit-identical).
        self.allocate_quantum = allocate_quantum
        self._exp_burst = 1
        self._last_trigger = -float("inf")
        self.n_allocated = 0
        self.n_released = 0
        # optional repro_torch.obs.Recorder; the owning engine installs it
        # so DRP decisions land in the same event stream as the pool
        # transitions they cause (one "provision" event per non-empty step)
        self.recorder = None
        # optional repro_torch.obs.metrics.MetricsRegistry (same install-and-
        # None-guard contract; DESIGN.md §13)
        self.metrics = None

    def step(
        self,
        now: float,
        queue_len: int,
        live_executors: int,
        inflight_allocations: int,
        idle_executors: list[str],
    ) -> ProvisionerActions:
        acts = ProvisionerActions()
        q = self.allocate_quantum
        total = live_executors + inflight_allocations
        # -- grow ---------------------------------------------------------
        if (queue_len >= self.queue_threshold and total < self.max_executors
                and now - self._last_trigger >= self.trigger_cooldown_s):
            # room rounds DOWN to whole quanta (no partial hosts), the
            # policy's request UP (a one-at-a-time trigger on a fleet still
            # buys one whole host).  room == 0 (max not a quantum multiple,
            # remainder too small for a whole host) is NOT a trigger: the
            # policy state (exponential burst, cooldown clock) must not
            # churn on an allocation that can never happen.
            room = ((self.max_executors - total) // q) * q
            if room > 0:
                if self.policy is AllocationPolicy.ONE_AT_A_TIME:
                    want = 1
                elif self.policy is AllocationPolicy.ADDITIVE:
                    want = self.additive_k
                elif self.policy is AllocationPolicy.EXPONENTIAL:
                    want = self._exp_burst
                    self._exp_burst *= 2
                else:  # ALL_AT_ONCE
                    want = room
                want = ((want + q - 1) // q) * q
                acts.allocate = min(want, room)
                self.n_allocated += acts.allocate
                self._last_trigger = now
        elif queue_len < self.queue_threshold:
            self._exp_burst = 1
        # -- shrink --------------------------------------------------------
        if queue_len == 0 and live_executors > self.min_executors:
            releasable = ((live_executors - self.min_executors) // q) * q
            acts.release = idle_executors[:releasable]
            self.n_released += len(acts.release)
        if self.recorder is not None and (acts.allocate or acts.release):
            self.recorder.emit("provision", allocate=acts.allocate,
                               release=len(acts.release), queue=queue_len,
                               live=live_executors)
        m = self.metrics
        if m is not None:
            m.gauge_set("drp.pool_live", live_executors)
            if acts.allocate:
                m.inc("drp.grows")
                m.inc("drp.executors_allocated", acts.allocate)
            if acts.release:
                m.inc("drp.shrinks")
                m.inc("drp.executors_released", len(acts.release))
        return acts

    def snapshot(self) -> dict:
        """JSON-able provisioning outcome for a finished run (consumed by
        the experiment layer's RunReport)."""
        return {
            "policy": self.policy.value,
            "min_executors": self.min_executors,
            "max_executors": self.max_executors,
            "n_allocated": self.n_allocated,
            "n_released": self.n_released,
        }
