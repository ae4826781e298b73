"""The Falkon-style dispatcher extended with data-aware scheduling (§3.2).

Engine-agnostic state machine: the discrete-event simulator and the real
threaded runtime both drive this same object, so the policy behaviour that
the paper evaluates (queueing, placement, waiting-on-busy-executor for
max-cache-hit, hint shipping, retries, speculation) is one code path.

Responsibilities:
  * wait queue + per-executor pending queues (max-cache-hit binds tasks to a
    busy executor and waits for it);
  * placement via policies.decide() against the loosely-coherent LocationIndex;
  * executor membership (join/leave/fail) with index invalidation and
    re-queueing of in-flight work  -> fault tolerance;
  * straggler speculation: duplicate the oldest running task when it exceeds
    ``speculation_factor x p95(completed durations)``; first copy wins;
  * byte/hit accounting handoff to metrics.

Scaling note (DESIGN.md §4): max-compute-util placement is *incremental*.
Hints for a queued task are resolved against the index once at enqueue time
and then kept coherent by the ``apply_index_updates`` / ``drop_executor``
hooks; an inverted ``executor -> {queued tid: cached-byte score}`` map makes
"which queued task does this freed executor cache the most of" an O(|tasks
that executor caches data for|) probe instead of an O(window x inputs)
index rescan; and the wait queue is an insertion-ordered map, so removal by
tid is O(1) and leaves nothing behind for later scans to walk.  A placement
round scores each free executor from the smaller side: the window's tasks
looked up in its score map, or its score map filtered by the window, so a
round costs O(window x free executors) however many tasks were dispatched
before it or however many queued tasks an executor's cache matches.

Multi-input (join) scoring (DESIGN.md §6): a task may read k inputs and an
executor may cache any subset of them, so a score is *bytes of this task's
inputs the executor caches* -- partial overlap counts, which is exactly
where data-aware dispatch wins (0808.3535): a 2-of-3-inputs overlap out-
scores a smaller full hit.  Byte-score ties break toward the higher overlap
*fraction* (cached bytes / total input bytes -- equivalently, same cached
bytes over fewer total bytes, i.e. less left to fetch), then toward the
earlier queue position.  ``reference_scores()`` is the retained brute-force
scorer the incremental maps must bit-match (tests/test_join_scoring.py).

DAG tasks (DESIGN.md §11): a task may declare producer ``deps``.  Tasks
with unmet deps are *held* outside the wait queue (so no dispatch path --
window scan, FIFO pop, or host lease -- can ever see them); the producer's
``task_finished`` releases them through the ordinary ``_enqueue`` path.
A released task's placement score covers its inputs PLUS everything its
producers created (``score_oids``), folded into the same cached-byte score
and tie-break chain, so downstream work lands where its inputs were just
written.  Dep-free tasks take the exact pre-DAG code path bit-identically.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from itertools import islice
from typing import Iterable, Iterator, Optional

from .index import IndexUpdate, LocationIndex
from .objects import Task, TaskState
from .policies import Decision, DispatchPolicy, decide


class TaskQueue:
    """FIFO wait queue with O(1) removal-by-tid.

    An insertion-ordered map from tid to task: ``appendleft`` moves the new
    entry to the front, and removal deletes it, so no removed entry is ever
    walked again.  ``pos`` is a stable total order (appendleft counts down,
    append counts up) used for "earliest in queue" tie-breaks without
    walking the queue; queue order is ascending ``pos``.
    """

    def __init__(self) -> None:
        self._q: OrderedDict[str, Task] = OrderedDict()
        self._pos: dict[str, int] = {}
        self._front = 0   # next appendleft pos (counts down)
        self._back = 1    # next append pos (counts up)

    def append(self, t: Task) -> None:
        tid = t.tid
        self._q.pop(tid, None)
        self._q[tid] = t
        self._pos[tid] = self._back
        self._back += 1

    def appendleft(self, t: Task) -> None:
        tid = t.tid
        self._q.pop(tid, None)
        self._q[tid] = t
        self._q.move_to_end(tid, last=False)
        self._pos[tid] = self._front
        self._front -= 1

    def popleft(self) -> Task:
        if not self._q:
            raise IndexError("pop from empty TaskQueue")
        tid, t = self._q.popitem(last=False)
        del self._pos[tid]
        return t

    def remove(self, tid: str) -> bool:
        """Delete the entry for ``tid``; O(1)."""
        if self._q.pop(tid, None) is None:
            return False
        del self._pos[tid]
        return True

    def position(self, tid: str) -> int:
        return self._pos[tid]

    def first_live(self, n: int) -> list[Task]:
        """The first ``n`` queued tasks (at least one while any is queued,
        whatever ``n``).  The port's dispatcher reads ``first_tids``; this
        call is kept for parity with the reference's ``TaskQueue``."""
        return list(islice(self._q.values(), max(n, 1)))

    def first_tids(self, n: int) -> list[str]:
        """The tids of the first ``n`` queued tasks, in queue order."""
        return list(islice(self._q, n))

    def __contains__(self, tid: str) -> bool:
        return tid in self._q

    def __iter__(self) -> Iterator[Task]:
        return iter(list(self._q.values()))

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


@dataclass(slots=True)
class ExecutorState:
    eid: str
    alive: bool = True
    busy: int = 0                 # running task count
    slots: int = 1
    joined_at: float = 0.0
    last_busy_at: float = 0.0
    running: set[str] = field(default_factory=set)

    @property
    def available(self) -> bool:
        return self.alive and self.busy < self.slots


@dataclass(slots=True)
class Dispatch:
    task: Task
    executor: str
    hints: dict[str, tuple[str, ...]]
    speculative_of: Optional[str] = None


class Dispatcher:
    def __init__(
        self,
        policy: DispatchPolicy,
        index: Optional[LocationIndex] = None,
        speculation_factor: float = 0.0,  # 0 disables speculation
        min_completions_for_speculation: int = 10,
    ) -> None:
        self.policy = policy
        self.index = index if index is not None else LocationIndex()
        self.sizes: dict[str, int] = {}
        self.executors: dict[str, ExecutorState] = {}
        self._exec_order: list[str] = []          # arrival order (FIFO choice)
        self.queue: TaskQueue = TaskQueue()
        self.pending: dict[str, deque[Task]] = {} # max-cache-hit waits
        self.tasks: dict[str, Task] = {}
        self.completed: list[Task] = []
        self.failed: list[Task] = []
        self.durations: list[float] = []
        self.speculation_factor = speculation_factor
        self.min_completions_for_speculation = min_completions_for_speculation
        self._speculated: set[str] = set()        # tids with a live twin
        self._twins: dict[str, str] = {}          # twin tid -> original tid
        self._twin_of: dict[str, str] = {}        # original tid -> twin tid
        self.n_decisions = 0
        self.decision_lookups = 0
        # queue and score-map entries max-compute-util placement examined
        self.decision_steps = 0
        # optional repro_torch.obs.Recorder: the owning engine installs it;
        # every emission below is None-guarded so recording-off costs one
        # attribute load per lifecycle transition (never per queue scan).
        self.recorder = None
        # optional repro_torch.obs.metrics.MetricsRegistry, same contract:
        # the owning engine installs it, hooks are None-guarded (DESIGN.md
        # §13).
        self.metrics = None
        # ---- incremental max-compute-util placement state -----------------
        # tid -> oid -> executors known (per the loosely-coherent index) to
        # cache it; resolved once at enqueue, patched by index-update hooks.
        self._hint_cache: dict[str, dict[str, set[str]]] = {}
        # eid -> tid -> bytes of that queued task's inputs this executor
        # caches (the inverted map the freed-executor probe reads).
        self._exec_scores: dict[str, dict[str, int]] = {}
        # oid -> queued tids with oid among their inputs (update fan-out).
        self._oid_waiters: dict[str, set[str]] = {}
        # ---- DAG ready-set (DESIGN.md §11) --------------------------------
        # held tid -> producer tids still outstanding.  Held tasks are in
        # ``tasks`` but never in ``queue``/``pending``, so no dispatch or
        # lease path can reach them until every dep completes.
        self._held: dict[str, set[str]] = {}
        # producer tid -> held dependents in submission order (dict-as-
        # ordered-set: release order is deterministic across engines).
        self._dependents: dict[str, dict[str, None]] = {}
        # dependents terminally failed by a producer's failure, awaiting
        # pickup by the owning engine's accounting (drain_dep_failed).
        self._dep_failed: list[Task] = []
        # every oid some submitted task produces (for the outputs-ignored
        # baseline below; disjoint from the catalog by Workload validation).
        self._produced: set[str] = set()
        # benchmark baseline knob: when False, produced outputs are invisible
        # to placement (no hints resolved, no bytes scored) -- the "outputs-
        # ignored" dispatcher that bench_dags compares against.  Scoring is
        # unaffected either way for workloads whose inputs are all catalog
        # objects, i.e. every dep-free workload.
        self.score_outputs: bool = True

    @property
    def _mcu(self) -> bool:
        return self.policy is DispatchPolicy.MAX_COMPUTE_UTIL

    # ---------------- membership -------------------------------------------
    def executor_joined(self, eid: str, now: float, slots: int = 1) -> None:
        self.executors[eid] = ExecutorState(eid=eid, slots=slots, joined_at=now,
                                            last_busy_at=now)
        if eid not in self._exec_order:
            self._exec_order.append(eid)
        self.pending.setdefault(eid, deque())

    def executor_left(self, eid: str, now: float, failed: bool = False) -> list[Task]:
        """Remove an executor; returns tasks that must be re-dispatched."""
        st = self.executors.get(eid)
        if st is None:
            return []
        st.alive = False
        self._exec_order = [e for e in self._exec_order if e != eid]
        self.index.drop_executor(eid)
        self._drop_executor_hints(eid)
        requeue: list[Task] = []
        for tid in list(st.running):
            t = self.tasks.get(tid)
            if t is not None and t.state not in (TaskState.DONE, TaskState.FAILED):
                t.attempts += 1
                if t.attempts >= t.max_attempts:
                    t.state = TaskState.FAILED
                    self.failed.append(t)
                    self._fail_dependents(t.tid)
                else:
                    t.reset_for_retry()
                    requeue.append(t)
        st.running.clear()
        st.busy = 0
        # re-home pending (max-cache-hit) tasks bound to the dead executor
        for t in self.pending.pop(eid, deque()):
            t.state = TaskState.SUBMITTED
            requeue.append(t)
        del self.executors[eid]
        rec = self.recorder
        for t in requeue:
            if rec is not None:
                rec.emit("task_requeued", tid=t.tid, eid=eid,
                         reason="executor_left")
            self._enqueue(t, front=True)
        return requeue

    # ---------------- submission -------------------------------------------
    def submit(self, tasks: Iterable[Task], now: float) -> int:
        n = 0
        rec = self.recorder
        for t in tasks:
            t.submit_time = now
            t.state = TaskState.SUBMITTED
            self.tasks[t.tid] = t
            for ob in t.outputs:
                self.sizes[ob.oid] = ob.size_bytes
                self._produced.add(ob.oid)
            if rec is not None:
                rec.emit("task_arrived", tid=t.tid)
            n += 1
            if t.deps and self._hold_if_unready(t, rec):
                continue
            t.ready_time = now
            self._enqueue(t)
        if n and self.metrics is not None:
            self.metrics.inc("sched.tasks_submitted", n)
        return n

    # ---------------- DAG ready-set (DESIGN.md §11) -------------------------
    def _hold_if_unready(self, t: Task, rec) -> bool:
        """Hold ``t`` until its producers complete.  Returns True if held
        (or failed because a producer already terminally failed)."""
        unmet: set[str] = set()
        for d in t.deps:
            p = self.tasks.get(d)
            if p is not None and p.state is TaskState.DONE:
                continue
            if p is not None and p.state is TaskState.FAILED:
                t.state = TaskState.FAILED
                self.failed.append(t)
                self._dep_failed.append(t)
                if rec is not None:
                    rec.emit("task_failed", tid=t.tid, reason="dep_failed",
                             dep=d)
                return True
            unmet.add(d)
        if not unmet:
            return False
        self._held[t.tid] = unmet
        for d in unmet:
            self._dependents.setdefault(d, {})[t.tid] = None
        if rec is not None:
            rec.emit("task_held", tid=t.tid, n_deps=len(unmet))
        return True

    def _release_dependents(self, tid: str, now: float) -> None:
        """A producer completed: enqueue every held dependent whose last
        unmet dep this was.  Runs inside ``task_finished``, i.e. after the
        producer's outputs were admitted/indexed by the engine, so the
        released task's enqueue-time hint resolution sees them."""
        deps = self._dependents.pop(tid, None)
        if not deps:
            return
        rec = self.recorder
        for dtid in deps:
            unmet = self._held.get(dtid)
            if unmet is None:
                continue            # stale entry (already failed elsewhere)
            unmet.discard(tid)
            if unmet:
                continue
            del self._held[dtid]
            dt = self.tasks[dtid]
            dt.ready_time = now
            if rec is not None:
                rec.emit("task_ready", tid=dtid)
            self._enqueue(dt)

    def _fail_dependents(self, tid: str) -> None:
        """A producer terminally failed: its held dependents (transitively)
        can never run -- fail them now so engines don't wait forever."""
        rec = self.recorder
        stack = [tid]
        while stack:
            cur = stack.pop()
            for dtid in self._dependents.pop(cur, ()):
                if self._held.pop(dtid, None) is None:
                    continue
                dt = self.tasks[dtid]
                dt.state = TaskState.FAILED
                self.failed.append(dt)
                self._dep_failed.append(dt)
                if rec is not None:
                    rec.emit("task_failed", tid=dtid, reason="dep_failed",
                             dep=cur)
                stack.append(dtid)

    def drain_dep_failed(self) -> list[Task]:
        """Tasks terminally failed by producer failure since the last call
        (never dispatched, so the owning runtime must account them)."""
        out, self._dep_failed = self._dep_failed, []
        return out

    def register_objects(self, objs) -> None:
        for ob in objs:
            self.sizes[ob.oid] = ob.size_bytes

    # ---------------- incremental hint maintenance --------------------------
    def _enqueue(self, t: Task, front: bool = False) -> None:
        if self.recorder is not None:
            self.recorder.emit("task_queued", tid=t.tid, front=front)
        if front:
            self.queue.appendleft(t)
        else:
            self.queue.append(t)
        if self._mcu:
            self._hints_resolve(t)

    def score_oids(self, t: Task) -> tuple[str, ...]:
        """Oids whose cached placement should attract this task: its inputs
        plus -- for DAG tasks -- every output its producers created (the
        producer-placement term; dep-free tasks return ``inputs`` as-is)."""
        if not t.deps:
            return t.inputs
        seen = dict.fromkeys(t.inputs)
        for d in t.deps:
            p = self.tasks.get(d)
            if p is not None:
                for ob in p.outputs:
                    seen.setdefault(ob.oid, None)
        return tuple(seen)

    def _hint_oids(self, t: Task) -> tuple[str, ...]:
        """``score_oids`` minus produced outputs when the outputs-ignored
        baseline is active.  MUST be used symmetrically by resolve/drop."""
        oids = self.score_oids(t)
        if not self.score_outputs:
            oids = tuple(o for o in oids if o not in self._produced)
        return oids

    def _hints_resolve(self, t: Task) -> None:
        """One index resolution at enqueue; hooks keep it coherent after."""
        hints: dict[str, set[str]] = {}
        touched: set[str] = set()
        oids = self._hint_oids(t)
        for oid in oids:
            self._oid_waiters.setdefault(oid, set()).add(t.tid)
            locs = self.index.lookup(oid)
            if locs:
                hints[oid] = set(locs)
                touched |= locs
        self.decision_lookups += len(oids)
        self._hint_cache[t.tid] = hints
        for eid in touched:
            self._rescore(t.tid, eid)

    def _hints_drop(self, t: Task) -> dict[str, set[str]]:
        """Forget a task leaving the wait queue; returns its final hints."""
        hints = self._hint_cache.pop(t.tid, None) or {}
        for oid in self._hint_oids(t):
            waiters = self._oid_waiters.get(oid)
            if waiters is not None:
                waiters.discard(t.tid)
                if not waiters:
                    del self._oid_waiters[oid]
        for eid in {e for locs in hints.values() for e in locs}:
            scores = self._exec_scores.get(eid)
            if scores is not None:
                scores.pop(t.tid, None)
        return hints

    def _rescore(self, tid: str, eid: str) -> None:
        """Recompute one (executor, queued task) cached-byte score exactly."""
        hints = self._hint_cache.get(tid)
        if hints is None:
            return
        score = sum(self.sizes.get(oid, 1)
                    for oid, locs in hints.items() if eid in locs)
        scores = self._exec_scores.setdefault(eid, {})
        if score > 0:
            scores[tid] = score
        else:
            scores.pop(tid, None)

    def _drop_executor_hints(self, eid: str) -> None:
        for tid in self._exec_scores.pop(eid, {}):
            hints = self._hint_cache.get(tid)
            if hints is None:
                continue
            for oid in list(hints):
                hints[oid].discard(eid)
                if not hints[oid]:
                    del hints[oid]

    def _hints_tuple(self, hints: dict[str, set[str]]) -> dict[str, tuple[str, ...]]:
        return {oid: tuple(sorted(locs)) for oid, locs in hints.items() if locs}

    def invalidate_executor(self, eid: str) -> None:
        """Drop every index entry (and its hint-cache shadow) for ``eid``
        without removing the executor -- e.g. its cache was cleared."""
        self.index.drop_executor(eid)
        self._drop_executor_hints(eid)

    # ---------------- index coherence ---------------------------------------
    def apply_index_updates(self, updates: Iterable[IndexUpdate]) -> None:
        if not self._mcu:
            self.index.apply_batch(updates)
            return
        for u in updates:
            self.index.apply(u)
            eid = u.executor
            dirty: set[str] = set()
            for oid in u.added:
                for tid in self._oid_waiters.get(oid, ()):
                    locs = self._hint_cache[tid].setdefault(oid, set())
                    if eid not in locs:
                        locs.add(eid)
                        dirty.add(tid)
            for oid in u.removed:
                for tid in self._oid_waiters.get(oid, ()):
                    hints = self._hint_cache[tid]
                    locs = hints.get(oid)
                    if locs and eid in locs:
                        locs.discard(eid)
                        if not locs:
                            del hints[oid]
                        dirty.add(tid)
            for tid in dirty:
                self._rescore(tid, eid)

    # ---------------- placement --------------------------------------------
    def _avail_busy(self) -> tuple[list[str], list[str]]:
        avail = [e for e in self._exec_order if self.executors[e].available]
        busy = [e for e in self._exec_order
                if self.executors[e].alive and not self.executors[e].available]
        return avail, busy

    #: how deep into the wait queue max-compute-util searches for a task
    #: matching a freed executor's cache.  Falkon's data-aware dispatcher
    #: examines queued tasks to "send tasks to nodes that have cached the
    #: most needed data" (§3.2.1); a bounded window keeps decisions O(W).
    queue_window: int = 256

    def next_dispatches(self, now: float) -> list[Dispatch]:
        """Pop as many placeable tasks as possible (engine applies them)."""
        out: list[Dispatch] = []
        # 1) pending queues of executors that became available
        for eid, dq in self.pending.items():
            st = self.executors.get(eid)
            while dq and st is not None and st.available:
                out.append(self._bind(dq.popleft(), eid, now))
        if not self.queue:
            return out
        if self._mcu:
            out.extend(self._dispatch_mcu(now))
        else:
            out.extend(self._dispatch_fifo(now))
        return out

    def _dispatch_fifo(self, now: float) -> list[Dispatch]:
        """Head-of-queue placement (FA / NA / FCA / MCH semantics)."""
        out: list[Dispatch] = []
        deferred: list[Task] = []
        progressed = True
        while progressed and self.queue:
            progressed = False
            avail, busy = self._avail_busy()
            if not avail and self.policy is not DispatchPolicy.MAX_CACHE_HIT:
                break
            t = self.queue.popleft()
            d = decide(self.policy, t, avail, busy, self.index, self.sizes)
            self.n_decisions += 1
            self.decision_lookups += len(t.inputs) if self.policy.ships_hints else 0
            if d.executor is not None:
                t.location_hints = d.hints
                out.append(self._bind(t, d.executor, now))
                progressed = True
            elif d.wait_for is not None:
                t.state = TaskState.PENDING
                t.location_hints = d.hints
                self.pending.setdefault(d.wait_for, deque()).append(t)
                progressed = True
            else:
                deferred.append(t)
        for t in reversed(deferred):
            self.queue.appendleft(t)
        return out

    def input_bytes_total(self, tid: str) -> int:
        """Total bytes of a task's (distinct) scored oids, late-size aware --
        the overlap-fraction denominator (same size default as _rescore).
        For dep-free tasks this is exactly the distinct-input byte total."""
        ins = self._hint_oids(self.tasks[tid])
        if len(ins) == 1:               # classic single-input fast path
            return self.sizes.get(ins[0], 1)
        return sum(self.sizes.get(oid, 1) for oid in dict.fromkeys(ins))

    def reference_scores(self) -> dict[str, dict[str, int]]:
        """Brute-force reference for the incremental ``_exec_scores`` maps.

        Rebuilds executor -> {queued tid: cached input bytes} from scratch
        with fresh index lookups over every live queued task.  The
        incremental maps must equal this exactly at any quiescent point
        (``scores_match_reference``); kept as the correctness oracle for
        tests/test_join_scoring.py and benchmarks/bench_joins.py, the same
        way transport.py retains its naive flow solver."""
        ref: dict[str, dict[str, int]] = {}
        for t in self.queue:
            for oid in dict.fromkeys(self._hint_oids(t)):
                sz = self.sizes.get(oid, 1)
                for eid in self.index.lookup(oid):
                    if eid in self.executors:
                        scores = ref.setdefault(eid, {})
                        scores[t.tid] = scores.get(t.tid, 0) + sz
        return ref

    def scores_match_reference(self) -> bool:
        """Bit-exact equality of the incremental maps vs reference_scores()."""
        live = {eid: dict(s) for eid, s in self._exec_scores.items() if s}
        return live == self.reference_scores()

    def _dispatch_mcu(self, now: float) -> list[Dispatch]:
        """max-compute-util: for each available executor, pick the queued
        task (within the window) whose inputs it caches the most bytes of --
        read off the inverted score map from its smaller side -- falling
        back to the earliest unclaimed window task when nothing matches.
        Byte ties prefer the higher overlap fraction (= smaller input total
        for equal cached bytes), then the earlier queue position.  The pick
        is the maximum of that total order, so the side it is read from
        cannot change it."""
        out: list[Dispatch] = []
        executors = self.executors
        avail = self._exec_order
        while self.queue:
            # nothing frees an executor in here: each round's free executors
            # are among the last round's
            avail = [e for e in avail if executors[e].available]
            if not avail:
                break
            window = self.queue.first_tids(self.queue_window)
            window_tids: Optional[set[str]] = None   # built on first need
            n_window = len(window)
            self.n_decisions += 1
            steps = n_window
            head = 0                    # window[:head] is all taken
            bound_any = False
            taken: set[str] = set()
            for eid in avail:
                scores = self._exec_scores.get(eid, {})
                if len(scores) > n_window:
                    steps += n_window
                    cands = [(tid, scores[tid]) for tid in window
                             if tid in scores]
                else:
                    steps += len(scores)
                    if window_tids is None:
                        window_tids = set(window)
                    cands = [(tid, score) for tid, score in scores.items()
                             if tid in window_tids]
                best_tid: Optional[str] = None
                best_score, best_pos, best_total = 0, 0, -1
                for tid, score in cands:
                    if score < best_score or tid in taken:
                        continue
                    if score > best_score:
                        best_tid, best_score = tid, score
                        best_pos = self.queue.position(tid)
                        best_total = -1          # lazily filled on first tie
                        continue
                    # equal cached bytes: fraction score/total is larger for
                    # the smaller total (exact int compare, no division);
                    # equal totals fall back to queue order
                    if best_total < 0:
                        best_total = self.input_bytes_total(best_tid)
                    total = self.input_bytes_total(tid)
                    pos = self.queue.position(tid)
                    if total < best_total \
                            or (total == best_total and pos < best_pos):
                        best_tid, best_pos, best_total = tid, pos, total
                if best_tid is None:
                    # nothing cached for this executor: take earliest unclaimed
                    while head < n_window and window[head] in taken:
                        head += 1
                    if head == n_window:
                        break
                    best_tid = window[head]
                t = self.tasks[best_tid]
                taken.add(t.tid)
                self.queue.remove(t.tid)
                t.location_hints = self._hints_tuple(self._hints_drop(t))
                out.append(self._bind(t, eid, now))
                bound_any = True
            self.decision_steps += steps + head
            if not bound_any:
                break
        return out

    # ---------------- hierarchical lease / claim (DESIGN.md §9) --------------
    def lease_next(self) -> Optional[Task]:
        """Pop the head-of-queue live task for leasing to a host-local
        dispatcher.  The task leaves the wait queue (and the incremental
        hint maps, keeping its resolved hints as ``location_hints``) but
        is NOT bound to an executor -- the owning runtime parks it in a
        per-host lease table until a claim arrives or the host dies."""
        if not self.queue:
            return None
        t = self.queue.popleft()
        if self._mcu:
            t.location_hints = self._hints_tuple(self._hints_drop(t))
        t.state = TaskState.PENDING
        if self.recorder is not None:
            self.recorder.emit("task_leased", tid=t.tid)
        return t

    def bind_claim(self, t: Task, eid: str, now: float) -> Dispatch:
        """Reconcile a host's local claim: bind the leased task to the
        claiming executor.  A claim may transiently over-commit ``busy``
        past ``slots`` (the host has already started the attempt);
        ``task_finished`` decrements through the normal path."""
        self.n_decisions += 1
        if self.recorder is not None:
            self.recorder.emit("task_claimed", tid=t.tid, eid=eid)
        return self._bind(t, eid, now)

    def requeue_leased(self, tasks: Iterable[Task]) -> None:
        """Return unclaimed leased tasks (their host died or was removed)
        to the FRONT of the wait queue in their original lease order.
        They were never dispatched, so no attempt is charged."""
        rec = self.recorder
        for t in reversed(list(tasks)):
            t.state = TaskState.SUBMITTED
            if rec is not None:
                rec.emit("task_requeued", tid=t.tid, reason="lease_returned")
            self._enqueue(t, front=True)

    def _bind(self, t: Task, eid: str, now: float) -> Dispatch:
        st = self.executors[eid]
        st.busy += 1
        st.running.add(t.tid)
        st.last_busy_at = now
        t.state = TaskState.DISPATCHED
        t.executor = eid
        t.dispatch_time = now
        if self.recorder is not None:
            self.recorder.emit("task_dispatched", tid=t.tid, eid=eid)
        return Dispatch(task=t, executor=eid, hints=t.location_hints)

    # ---------------- completion -------------------------------------------
    def task_finished(self, t: Task, now: float, ok: bool = True) -> Optional[str]:
        """Returns the tid of a twin to cancel, if this was a speculated task."""
        eid = t.executor
        st = self.executors.get(eid) if eid else None
        if st is not None:
            st.busy = max(st.busy - 1, 0)
            st.running.discard(t.tid)
            st.last_busy_at = now
        cancel: Optional[str] = None
        orig_tid = self._twins.pop(t.tid, None)
        rec = self.recorder
        if ok:
            t.state = TaskState.DONE
            t.end_time = now
            if rec is not None:
                rec.emit("task_done", tid=t.tid, eid=eid)
            self.durations.append(now - t.dispatch_time)
            if orig_tid is not None:
                # a speculative twin won; cancel the original
                cancel = orig_tid
                self._speculated.discard(orig_tid)
                self._twin_of.pop(orig_tid, None)
                orig = self.tasks.get(orig_tid)
                if orig is not None and orig.state not in (TaskState.DONE,):
                    orig.state = TaskState.DONE  # satisfied by twin
                self._release_dependents(orig_tid, now)
            elif t.tid in self._speculated:
                # original won; cancel its twin (reverse map, not an O(n) scan)
                twin_tid = self._twin_of.pop(t.tid, None)
                if twin_tid:
                    cancel = twin_tid
                    del self._twins[twin_tid]
                self._speculated.discard(t.tid)
            self.completed.append(t)
            self._release_dependents(t.tid, now)
            if self.metrics is not None:
                self.metrics.inc("sched.tasks_completed")
        else:
            if orig_tid is not None:
                self._twins[t.tid] = orig_tid  # still a live twin; retry below
            t.attempts += 1
            if t.attempts >= t.max_attempts:
                t.state = TaskState.FAILED
                self.failed.append(t)
                if rec is not None:
                    rec.emit("task_failed", tid=t.tid, eid=eid,
                             attempts=t.attempts)
                if self.metrics is not None:
                    self.metrics.inc("sched.tasks_failed")
                self._fail_dependents(t.tid)
                if orig_tid is not None:
                    self._twins.pop(t.tid, None)
                    self._twin_of.pop(orig_tid, None)
                    self._speculated.discard(orig_tid)
            else:
                t.reset_for_retry()
                if rec is not None:
                    rec.emit("task_requeued", tid=t.tid, eid=eid,
                             reason="retry")
                self._enqueue(t, front=True)
        if cancel is not None and cancel in self.queue:
            # the losing copy never left the wait queue: dequeue it now so it
            # is not pointlessly executed (and double-counted) later
            ct = self.tasks.get(cancel)
            self.queue.remove(cancel)
            if ct is not None:
                if self._mcu:
                    self._hints_drop(ct)
                ct.state = TaskState.DONE   # satisfied by the winning copy
        return cancel

    # ---------------- speculation -------------------------------------------
    def speculation_candidates(self, now: float) -> list[Task]:
        if (self.speculation_factor <= 0
                or len(self.durations) < self.min_completions_for_speculation):
            return []
        ds = sorted(self.durations)
        p95 = ds[min(int(0.95 * len(ds)), len(ds) - 1)]
        threshold = self.speculation_factor * max(p95, 1e-9)
        out = []
        for st in self.executors.values():
            for tid in st.running:
                t = self.tasks[tid]
                if (t.state is TaskState.RUNNING or t.state is TaskState.DISPATCHED) \
                        and t.tid not in self._speculated \
                        and t.tid not in self._twins \
                        and now - t.dispatch_time > threshold:
                    out.append(t)
        return out

    def make_twin(self, t: Task, now: float) -> Task:
        twin = Task(inputs=t.inputs, outputs=t.outputs,
                    compute_seconds=t.compute_seconds, fn=t.fn,
                    store_metadata_ops=t.store_metadata_ops, tag=t.tag)
        twin.submit_time = now
        self.tasks[twin.tid] = twin
        self._speculated.add(t.tid)
        self._twins[twin.tid] = t.tid
        self._twin_of[t.tid] = twin.tid
        self._enqueue(twin, front=True)
        return twin

    def twin_of(self, tid: str) -> Optional[str]:
        """tid of the live speculative twin of ``tid``, if any (O(1))."""
        return self._twin_of.get(tid)

    # ---------------- introspection -----------------------------------------
    @property
    def queue_len(self) -> int:
        """Runnable backlog (held dep-waiters are NOT demand: adding
        executors cannot serve them, so the provisioner must not see them)."""
        return len(self.queue) + sum(len(q) for q in self.pending.values())

    @property
    def held_len(self) -> int:
        """Tasks held on unmet deps (outside every dispatch path)."""
        return len(self._held)

    def idle_executors(self, now: float, idle_for_s: float) -> list[str]:
        return [
            st.eid for st in self.executors.values()
            if st.alive and st.busy == 0 and now - st.last_busy_at >= idle_for_s
        ]
