"""Real threaded data-diffusion runtime, with executor caches on the card.

Drives the same Dispatcher / policies / ExecutorCache / LocationIndex as the
reference runtime, but executors are worker threads running real Python
callables, and objects carry real payloads held in per-executor in-memory
caches.

Where the card enters (the one departure from the reference):

  * :class:`ObjectStore` -- the persistent-store (GPFS) stand-in -- holds
    host (CPU) tensors; a numpy payload is wrapped with ``torch.from_numpy``.
  * every executor cache entry is a tensor on the runtime's ``device``.
    ``cache_admit`` moves a host tensor with ``.to(device)``, so a store
    read is one real host-to-device copy; a tensor already on the device (a
    task's output, or a payload fetched from a peer's cache) is kept by
    reference, so on one card a peer hit copies nothing.  Evicting an entry
    drops the tensor, which frees its device memory.
  * a task function always receives device tensors: after a miss,
    ``_resolve`` returns the admitted device copy (or, when the cache refuses
    an object larger than its capacity, a device copy made for this task).
  * removing an executor (a failure, or the provisioner releasing it) drops
    its cache in ``remove_executor`` itself, so when that returns the card
    no longer holds a tensor that only this executor held.  A tensor a
    surviving executor also caches (a peer hit shares it by reference) stays.

Byte accounting stays on ``DataObject.size_bytes``, exactly as in the
reference, so the ledger, hit ratios and RunReport fields keep their
meaning.

Streams: every executor thread launches on PyTorch's current (default)
stream of the device, so stream order alone guarantees that a task reading a
tensor another executor's task produced sees the finished values.  Giving
executors streams of their own would need an event on every producer ->
consumer handoff through the cache.

The ``repro_torch.core.channel.Channel`` abstraction marks the two seams
(task dispatch down to each worker, index updates / completions back up)
that become RPCs on a real fleet: every dispatch goes through the worker's
dispatch channel (``ExecutorWorker.dispatch``) and every cache admission
through the runtime's ``update_channel``.

Submission is closed-loop (``submit``) or open-loop (``submit_workload``: a
paced submitter thread replays a ``repro_torch.workloads`` arrival schedule
on the wall clock, optionally time-scaled, or -- with ``barrier_every`` -- in
deterministic batch-synchronous rounds).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from ..device import resolve_device
from .cache import EvictionPolicy, ExecutorCache
from .channel import CallbackChannel, Channel, ChannelClosed, LocalChannel
from .index import IndexUpdate
from .objects import DataObject, Task, TaskState
from .policies import DispatchPolicy
from .scheduler import Dispatcher, Dispatch

#: store payload for shape-only runs (tasks with no ``fn``).  Must NOT be
#: None -- the cache-hit test is ``payload is not None``, so a None payload
#: would turn every cache lookup into a store read.  Byte accounting uses
#: DataObject sizes, never payload length.
SHAPE_ONLY_PAYLOAD = object()


def on_device(payload: Any, device: torch.device) -> Any:
    """``payload`` as a tensor on ``device``: a tensor elsewhere is copied
    there, a tensor already there is returned as is (no copy), and anything
    that is not a tensor (``SHAPE_ONLY_PAYLOAD``, bytes) is left untouched."""
    if isinstance(payload, torch.Tensor) and payload.device != device:
        return payload.to(device)
    return payload


class ObjectStore:
    """Persistent-store stand-in: oid -> payload (immutable after put).

    Payloads live in host memory; numpy arrays are wrapped as CPU tensors
    (``torch.from_numpy`` shares the array's memory)."""

    def __init__(self) -> None:
        self._data: dict[str, Any] = {}
        self._meta: dict[str, DataObject] = {}
        self._lock = threading.Lock()
        self.reads = 0
        self.bytes_read = 0

    def put(self, obj: DataObject, payload: Any) -> None:
        if isinstance(payload, np.ndarray):
            payload = torch.from_numpy(payload)
        with self._lock:
            if obj.oid in self._data:
                raise ValueError(f"object {obj.oid} is immutable (already stored)")
            self._data[obj.oid] = payload
            self._meta[obj.oid] = obj

    def get(self, oid: str) -> tuple[DataObject, Any]:
        with self._lock:
            self.reads += 1
            self.bytes_read += self._meta[oid].size_bytes
            return self._meta[oid], self._data[oid]

    def meta(self, oid: str) -> DataObject:
        return self._meta[oid]

    def items(self) -> list[tuple[DataObject, Any]]:
        """Consistent snapshot of the catalog."""
        with self._lock:
            return [(self._meta[oid], self._data[oid]) for oid in self._data]

    def __contains__(self, oid: str) -> bool:
        return oid in self._data


@dataclass
class _InputLedger:
    """Per-attempt input accounting, merged into the Task under the runtime
    lock once the attempt is known to still count (see _execute)."""

    bytes_local: int = 0
    bytes_cache_to_cache: int = 0
    bytes_store: int = 0
    cache_hits: int = 0
    peer_hits: int = 0
    cache_misses: int = 0

    def merge_into(self, t: Task) -> None:
        t.bytes_local += self.bytes_local
        t.bytes_cache_to_cache += self.bytes_cache_to_cache
        t.bytes_store += self.bytes_store
        t.cache_hits += self.cache_hits
        t.peer_hits += self.peer_hits
        t.cache_misses += self.cache_misses


@dataclass
class DispatchStats:
    """Lightweight counters/timers on the central dispatch loop.

    Mutated only under the runtime lock, surfaced through
    ``RunReport.dispatch_stats``.  ``lock_hold_s`` accumulates time spent
    inside the runtime lock on the pump path -- the quantity the
    central-dispatcher bottleneck (Falkon's ~1k tasks/s wall) is made of.
    The wire and lease counters belong to a multi-process fleet and stay 0
    in process; they are kept so the report schema matches the reference."""

    pump_calls: int = 0
    dispatch_batches: int = 0      # pumps that produced >= 1 dispatch
    dispatches: int = 0
    max_dispatch_batch: int = 0
    updates_applied: int = 0
    lock_hold_s: float = 0.0
    frames_sent: int = 0
    frames_recv: int = 0
    msgs_sent: int = 0
    msgs_recv: int = 0
    leases: int = 0
    claims: int = 0
    claim_conflicts: int = 0

    def as_dict(self) -> dict:
        return {
            "pump_calls": self.pump_calls,
            "dispatch_batches": self.dispatch_batches,
            "dispatches": self.dispatches,
            "max_dispatch_batch": self.max_dispatch_batch,
            "updates_applied": self.updates_applied,
            "lock_hold_s": self.lock_hold_s,
            "frames_sent": self.frames_sent,
            "frames_recv": self.frames_recv,
            "msgs_sent": self.msgs_sent,
            "msgs_recv": self.msgs_recv,
            "leases": self.leases,
            "claims": self.claims,
            "claim_conflicts": self.claim_conflicts,
        }


@dataclass
class RuntimeLedger:
    lock: threading.Lock = field(default_factory=threading.Lock)
    bytes_local: int = 0
    bytes_c2c: int = 0
    bytes_store: int = 0
    local_hits: int = 0
    peer_hits: int = 0
    store_reads: int = 0

    def account(self, kind: str, n: int) -> None:
        with self.lock:
            if kind == "local":
                self.bytes_local += n
                self.local_hits += 1
            elif kind == "c2c":
                self.bytes_c2c += n
                self.peer_hits += 1
            else:
                self.bytes_store += n
                self.store_reads += 1

    def account_attempt(self, acc: "_InputLedger") -> None:
        """Fold one *counted* attempt's per-input ledger in atomically.
        Store-read occurrences are ``cache_misses - peer_hits`` (a miss is
        served either cache-to-cache or from the store)."""
        with self.lock:
            self.bytes_local += acc.bytes_local
            self.bytes_c2c += acc.bytes_cache_to_cache
            self.bytes_store += acc.bytes_store
            self.local_hits += acc.cache_hits
            self.peer_hits += acc.peer_hits
            self.store_reads += acc.cache_misses - acc.peer_hits

    @property
    def global_hit_ratio(self) -> float:
        n = self.local_hits + self.peer_hits + self.store_reads
        return (self.local_hits + self.peer_hits) / n if n else 0.0

    @property
    def local_hit_ratio(self) -> float:
        n = self.local_hits + self.peer_hits + self.store_reads
        return self.local_hits / n if n else 0.0


class CacheExecutorBase:
    """Executor-local payload cache + dispatch inbox Channel: the parts of
    an executor that do not depend on where it runs.  ONE implementation of
    lookup/peek/admit semantics.  Cached payloads are tensors on
    ``device`` (see the module docstring)."""

    def __init__(self, eid: str, cache_capacity: int,
                 policy: EvictionPolicy, seed: int,
                 device: torch.device) -> None:
        self.eid = eid
        self.device = device
        self.cache = ExecutorCache(cache_capacity, policy, seed=seed)
        self.payloads: dict[str, Any] = {}
        self.lock = threading.Lock()
        self.inbox: Channel = LocalChannel()
        self.alive = True

    def stop(self) -> None:
        self.alive = False
        self.inbox.close()

    def drop_cache(self) -> None:
        """Forget every cached payload (the executor was removed).  The cache
        becomes a zero-capacity one, so an attempt still running here admits
        nothing more: it keeps only the references it holds itself."""
        with self.lock:
            self.cache = ExecutorCache(0, self.cache.policy)
            self.payloads.clear()

    # -- cache ops (thread-safe) ---------------------------------------------
    def cache_lookup(self, oid: str) -> Optional[Any]:
        with self.lock:
            if self.cache.get(oid):
                return self.payloads[oid]
        return None

    def cache_peek(self, oid: str) -> Optional[Any]:
        """Peer-side read: no recency update on the *owner's* policy state
        (the paper's peer reads go through GridFTP, not the local app)."""
        with self.lock:
            if oid in self.cache:
                return self.payloads[oid]
        return None

    def cache_admit(self, obj: DataObject,
                    payload: Any) -> tuple[tuple[str, ...], tuple[str, ...]]:
        """Admit one object; returns ``(added, removed)`` oid tuples (the
        payload of an IndexUpdate, transport-agnostic).  The entry is a
        device tensor: a host tensor is copied to the device first, outside
        the lock, so a store read's copy never blocks this cache's readers."""
        payload = on_device(payload, self.device)
        with self.lock:
            evicted = self.cache.put(obj)
            if obj.oid in self.cache:
                self.payloads[obj.oid] = payload
            for oid in evicted:
                self.payloads.pop(oid, None)
            return (obj.oid,), tuple(evicted)


class ExecutorWorker(CacheExecutorBase):
    """A worker thread with a local payload cache.

    Receives work exclusively through its dispatch :class:`Channel`
    (``dispatch()`` is the only way the runtime hands it a task), so the
    executor side of the dispatch seam is already message-shaped."""

    def __init__(self, eid: str, rt: "DiffusionRuntime",
                 cache_capacity: int, policy: EvictionPolicy, seed: int,
                 device: torch.device) -> None:
        super().__init__(eid, cache_capacity, policy, seed, device)
        self.rt = rt
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"executor-{eid}")

    def start(self) -> None:
        self.thread.start()

    def dispatch(self, disp: Dispatch) -> None:
        """Dispatch-seam entry point (dispatcher -> this executor)."""
        try:
            self.inbox.send(disp)
        except ChannelClosed:
            pass   # racing a stop(); the membership guard already dropped us

    def admit_update(self, obj: DataObject, payload: Any) -> IndexUpdate:
        added, removed = self.cache_admit(obj, payload)
        return IndexUpdate(self.eid, added=added, removed=removed)

    # -- task loop --------------------------------------------------------------
    def _run(self) -> None:
        while self.alive:
            try:
                disp = self.inbox.recv()
            except ChannelClosed:
                return
            self.rt._execute(self, disp)


class DiffusionRuntime:
    """In-process multi-executor diffusion runtime on one device.

    ``device`` defaults to ``"cuda"``; the CPU runs only when the caller
    asks for it (``device="cpu"``).  Asking for CUDA where there is none
    raises instead of carrying on on the CPU."""

    def __init__(
        self,
        n_executors: int,
        policy: DispatchPolicy = DispatchPolicy.MAX_COMPUTE_UTIL,
        cache_policy: EvictionPolicy = EvictionPolicy.LRU,
        cache_capacity_bytes: int = 1 << 30,
        store: Optional[ObjectStore] = None,
        seed: int = 0,
        index_update_batch: int = 1,   # >1 demonstrates loose coherence
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.store = store if store is not None else ObjectStore()
        self.dispatcher = Dispatcher(policy)
        self.ledger = RuntimeLedger()
        self.stats = DispatchStats()
        self.workers: dict[str, ExecutorWorker] = {}
        # the update seam: executors send IndexUpdates here; in process the
        # channel is a synchronous callback into the (locked) batcher
        self.update_channel: Channel = CallbackChannel(self._on_update)
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._outstanding = 0
        self._update_buf: list[IndexUpdate] = []
        self._update_batch = max(index_update_batch, 1)
        self._stop_pacing = threading.Event()
        self._seed = seed
        self._next_worker_id = 0
        self._cap = cache_capacity_bytes
        self._cpol = cache_policy
        # attempts that ran on an executor removed while they ran: their
        # outcome is dropped (the dispatcher re-queued the task), so each is
        # one execution of the task function beyond its completed one
        self.dropped_attempts = 0
        # membership log: (seconds since construction, live workers) per
        # change -- the experiment layer's RunReport reads pool history here
        self._t0 = time.monotonic()
        self.pool_log: list[tuple[float, int]] = []
        for i in range(n_executors):
            self.add_executor()
        # collapse the construction ramp into one t=0 sample
        self.pool_log = [(0.0, len(self.workers))]

    # -- membership ----------------------------------------------------------------
    def add_executor(self) -> str:
        with self._lock:
            # monotonic ids: len(workers) would reuse a live eid after a
            # removal and silently overwrite that worker (losing its task)
            wid = self._next_worker_id
            self._next_worker_id += 1
            eid = f"w{wid}"
            w = ExecutorWorker(eid, self,
                               cache_capacity=self._cap,
                               policy=self._cpol,
                               seed=self._seed + wid,
                               device=self.device)
            self.workers[eid] = w
            self.dispatcher.executor_joined(eid, time.monotonic())
            self.pool_log.append((time.monotonic() - self._t0,
                                  len(self.workers)))
        w.start()
        return eid

    def configure_caches(self, capacity_bytes: int, policy: EvictionPolicy) -> None:
        self._cap = capacity_bytes
        self._cpol = policy
        with self._lock:
            self._update_buf = []   # drop updates for caches we just cleared
            for w in self.workers.values():
                w.cache = ExecutorCache(capacity_bytes, policy)
                w.payloads.clear()
                # the index (and the dispatcher's queued-task hint cache)
                # must forget the cleared contents
                self.dispatcher.invalidate_executor(w.eid)

    def remove_executor(self, eid: str, failed: bool = False) -> None:
        with self._lock:
            w = self.workers.pop(eid, None)
            if w is None:
                return
            self.pool_log.append((time.monotonic() - self._t0,
                                  len(self.workers)))
            self._deregister_locked(eid, failed)
        w.stop()
        w.drop_cache()
        self._pump()

    def _deregister_locked(self, eid: str, failed: bool) -> None:
        """Hand a (popped) executor back to the dispatcher, under the lock.
        Terminally-failed in-flight tasks are accounted here or ``wait()``
        leaks."""
        st = self.dispatcher.executors.get(eid)
        running = set(st.running) if st is not None else set()
        self.dispatcher.executor_left(eid, time.monotonic(), failed=failed)
        # in-flight completions from the dead executor are dropped by the
        # membership guard in _finish_attempt.  Re-queued retries keep their
        # outstanding count, but a task whose attempts were exhausted by
        # executor_left is terminally FAILED and will never complete --
        # account it here or wait() leaks forever.
        terminal = sum(
            1 for tid in running
            if (t := self.dispatcher.tasks.get(tid)) is not None
            and t.state is TaskState.FAILED)
        # a producer failed out above may have cascade-failed held
        # dependents (never dispatched): account them here too
        terminal += len(self.dispatcher.drain_dep_failed())
        if terminal:
            self._outstanding -= terminal
            if self._outstanding == 0:
                self._done.notify_all()

    # -- provisioning hooks ------------------------------------------------------
    # The wall-clock DRP driver (repro_torch.experiments._ProvisionerDriver)
    # talks to the pool only through these three methods, in executor units.

    def provision_grow(self, n: int) -> None:
        for _ in range(n):
            self.add_executor()

    def provision_release(self, eids: Iterable[str]) -> None:
        for eid in eids:
            self.remove_executor(eid)

    def provision_idle(self, now: float, idle_for_s: float) -> list[str]:
        """Executors eligible for release (called under ``self._lock``)."""
        return self.dispatcher.idle_executors(now, idle_for_s)

    def exclusive_cache_bytes(self, eids: Iterable[str]) -> int:
        """Bytes of the tensor storages the executors ``eids`` cache and no
        other executor does: what removing them gives back to the device,
        unless something outside the caches also holds those tensors."""
        eids = set(eids)
        with self._lock:
            workers = list(self.workers.values())
        mine: dict[int, int] = {}
        others: set[int] = set()
        for w in workers:
            with w.lock:
                payloads = list(w.payloads.values())
            for p in payloads:
                if not isinstance(p, torch.Tensor):
                    continue
                st = p.untyped_storage()
                if w.eid in eids:
                    mine[st.data_ptr()] = st.nbytes()
                else:
                    others.add(st.data_ptr())
        return sum(n for ptr, n in mine.items() if ptr not in others)

    # -- data -------------------------------------------------------------------------
    def put_object(self, obj: DataObject, payload: Any) -> None:
        self.store.put(obj, payload)
        self.dispatcher.sizes[obj.oid] = obj.size_bytes

    # -- execution -------------------------------------------------------------------
    def submit(self, tasks: Iterable[Task]) -> int:
        ts = list(tasks)
        with self._lock:
            self.dispatcher.submit(ts, time.monotonic())
            self._outstanding += len(ts)
            # a task submitted after its producer terminally failed is
            # failed on arrival; it will never dispatch, account it now
            dead = len(self.dispatcher.drain_dep_failed())
            if dead:
                self._outstanding -= dead
                if self._outstanding == 0:
                    self._done.notify_all()
        self._pump()
        return len(ts)

    def submit_workload(self, wl, *, task_fn: Optional[Callable[..., Any]] = None,
                        payload_factory: Optional[Callable[[DataObject], Any]] = None,
                        time_scale: float = 1.0,
                        block: bool = False,
                        barrier_every: Optional[int] = None) -> threading.Thread:
        """Open-loop submission: a paced submitter thread sleeps each task's
        ``repro_torch.workloads`` arrival gap (wall-clock, scaled by
        ``time_scale``; 0 collapses to as-fast-as-possible) and submits it,
        so demand arrives on its own clock instead of as one pre-staged
        batch.

        ``task_fn`` is attached to tasks that carry no callable (workload
        events describe *shape*, not code); ``payload_factory`` materialises
        store payloads for catalog objects not yet put.  ``wait()`` counts
        tasks only after they arrive, so to drain a paced run: join the
        returned thread, then ``wait()``.  ``shutdown()`` aborts any
        in-flight paced schedule (the thread exits at its next arrival).

        ``barrier_every=B`` replaces pacing with *batch-synchronous replay*:
        events are submitted in chunks of B (one ``submit`` call per chunk,
        so all of a chunk's placement decisions happen against a quiescent
        pool) and the run drains fully between chunks.  With eviction-free
        caches, a fixed pool, and ``B <= pool size`` (a whole chunk
        dispatches in ONE pump against the all-idle pool; a larger B leaves
        a tail whose placement follows racy completion order) this makes
        the scheduling outcome (placement sequence, per-input
        hit/peer/store split, byte ledger) a pure function of the workload
        -- identical across thread interleavings, and identical to the
        reference runtime's, which is what the parity tests run on.
        """
        if time_scale < 0:
            raise ValueError("time_scale must be >= 0")
        if barrier_every is not None and barrier_every < 1:
            raise ValueError("barrier_every must be >= 1")
        if payload_factory is not None:
            for ob in wl.objects:
                if ob.oid not in self.store:
                    self.put_object(ob, payload_factory(ob))
        events = wl.tasks()

        def _prep(task) -> Task:
            if task.fn is None:
                task.fn = task_fn
            return task

        def _pace() -> None:
            t0 = time.monotonic()
            for t_arr, task in events:
                if self._stop_pacing.is_set():
                    return
                _prep(task)
                if time_scale > 0:
                    delay = t_arr * time_scale - (time.monotonic() - t0)
                    # interruptible sleep: shutdown() aborts the schedule
                    if delay > 0 and self._stop_pacing.wait(delay):
                        return
                self.submit((task,))

        def _pace_barriers() -> None:
            for i in range(0, len(events), barrier_every):
                if self._stop_pacing.is_set():
                    return
                self.submit(_prep(task) for _, task in
                            events[i:i + barrier_every])
                if not self.wait(timeout=600.0):
                    return   # wedged; the caller's drain check reports it

        th = threading.Thread(
            target=_pace_barriers if barrier_every is not None else _pace,
            daemon=True, name="workload-submitter")
        th.start()
        if block:
            th.join()
        return th

    def _pump(self) -> None:
        with self._lock:
            t0 = time.perf_counter()
            dispatches = self.dispatcher.next_dispatches(time.monotonic())
            self._note_pump_locked(len(dispatches), time.perf_counter() - t0)
        for d in dispatches:
            w = self.workers.get(d.executor)
            if w is None:
                with self._lock:
                    self.dispatcher.task_finished(d.task, time.monotonic(), ok=False)
                continue
            w.dispatch(d)

    def _resolve(self, acc: "_InputLedger", w: ExecutorWorker, oid: str,
                 hints: dict[str, tuple[str, ...]]) -> Any:
        """Stage one input on ``w``'s device, accounting a per-attempt
        accumulator (joins need the per-task split: a k-input task may hit
        locally on some inputs, peer-fetch others, miss the rest).  Only
        the accumulator -- never the task or the global ledger -- is
        written here because this runs lock-free on the worker thread: if
        the worker is removed mid-execution, executor_left resets and
        re-queues the task, and a zombie attempt must not race its counters
        against the retry's.  _finish_attempt merges the accumulator into
        the task AND the global ledger under the lock, after the membership
        guard drops de-registered workers -- so ledger totals always equal
        the sum of counted attempts."""
        size = self.dispatcher.sizes.get(oid, 0)
        payload = w.cache_lookup(oid)
        if payload is not None:
            acc.cache_hits += 1
            acc.bytes_local += size
            return payload
        acc.cache_misses += 1
        for peer_id in hints.get(oid, ()):
            if peer_id == w.eid:
                continue
            peer = self.workers.get(peer_id)
            if peer is None:
                continue
            payload = peer.cache_peek(oid)
            if payload is not None:
                acc.peer_hits += 1
                acc.bytes_cache_to_cache += size
                obj = self.store.meta(oid) if oid in self.store else DataObject(oid, size)
                self._emit(w.admit_update(obj, payload))
                return payload
        obj, payload = self.store.get(oid)
        acc.bytes_store += obj.size_bytes
        # the one host-to-device copy of a store read; the cache keeps this
        # same tensor (or refuses it, and then only this task uses it)
        payload = on_device(payload, w.device)
        self._emit(w.admit_update(obj, payload))
        return payload

    def _emit(self, upd: IndexUpdate) -> None:
        self.update_channel.send(upd)

    def _on_update(self, upd: IndexUpdate) -> None:
        """Consumer side of the update seam."""
        with self._lock:
            self._update_buf.append(upd)
            self.stats.updates_applied += 1
            if len(self._update_buf) >= self._update_batch:
                self.dispatcher.apply_index_updates(self._update_buf)
                self._update_buf = []

    def _note_pump_locked(self, n_dispatches: int, hold_s: float) -> None:
        st = self.stats
        st.pump_calls += 1
        st.lock_hold_s += hold_s
        if n_dispatches:
            st.dispatch_batches += 1
            st.dispatches += n_dispatches
            if n_dispatches > st.max_dispatch_batch:
                st.max_dispatch_batch = n_dispatches

    def dispatch_stats(self) -> dict:
        """Central-loop counter snapshot for RunReport."""
        with self._lock:
            return self.stats.as_dict()

    def _execute(self, w: ExecutorWorker, disp: Dispatch) -> None:
        t = disp.task
        t.state = TaskState.RUNNING
        t.start_time = time.monotonic()
        ok = True
        acc = _InputLedger()
        try:
            inputs = {oid: self._resolve(acc, w, oid, disp.hints)
                      for oid in t.inputs}
            if t.fn is not None:
                t.result = t.fn(**inputs) if _wants_kwargs(t.fn) else t.fn(inputs)
            for ob in t.outputs:
                # shape-only tasks (no fn) produce no real payload; admit the
                # sentinel so downstream DAG reads still count as cache hits
                # (a None payload would read as a miss on every lookup)
                if t.fn is None:
                    payload = SHAPE_ONLY_PAYLOAD
                else:
                    payload = t.result if len(t.outputs) == 1 else t.result[ob.oid]
                self._emit(w.admit_update(ob, payload))
                self.dispatcher.sizes[ob.oid] = ob.size_bytes
        except Exception as e:  # noqa: BLE001 - task failure is data, not a crash
            ok = False
            t.result = e
        self._finish_attempt(w, t, acc, ok)
        self._pump()

    def _finish_attempt(self, w, t: Task, acc: _InputLedger, ok: bool) -> None:
        """Complete one execution attempt under the lock.  The identity
        check against ``self.workers`` is the membership guard."""
        with self._lock:
            if self.workers.get(w.eid) is not w:
                # this worker was removed mid-execution: executor_left
                # already re-queued (or failed out) the task, so this
                # attempt's outcome must not complete it a second time --
                # that would double-decrement _outstanding and wake wait()
                # early while the retry is still in flight -- and its input
                # ledger must not pollute the retry's counters (acc is
                # dropped here)
                self.dropped_attempts += 1
                return
            acc.merge_into(t)
            self.ledger.account_attempt(acc)
            self.dispatcher.task_finished(t, time.monotonic(), ok=ok)
            # a completion may also release held dependents (they re-enter
            # the queue and stay outstanding) or -- on terminal failure --
            # cascade-fail them; cascaded tasks never dispatch, so account
            # them here.
            terminal = 1 if (ok or t.state is TaskState.FAILED) else 0
            terminal += len(self.dispatcher.drain_dep_failed())
            if terminal:
                self._outstanding -= terminal
                if self._outstanding == 0:
                    self._done.notify_all()

    def wait(self, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._outstanding > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._done.wait(remaining)
        # flush any buffered (loose) index updates at quiescence
        with self._lock:
            if self._update_buf:
                self.dispatcher.apply_index_updates(self._update_buf)
                self._update_buf = []
        return True

    def shutdown(self) -> None:
        self._stop_pacing.set()    # abort any paced submitter threads
        for w in self.workers.values():
            w.stop()


def _wants_kwargs(fn: Callable[..., Any]) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    params = list(sig.parameters.values())
    return not (len(params) == 1 and params[0].kind is params[0].POSITIONAL_OR_KEYWORD
                and params[0].name in ("inputs", "payloads"))
