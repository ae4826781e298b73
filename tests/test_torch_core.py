"""Scheduling parity between the port and the JAX package's framework-neutral
core: the same catalog, tasks and call sequence must give the same dispatch
sequence and hints (exactly), the same workload events, and -- in the
runtime's deterministic regime -- the same per-task placement, input split
and byte ledger."""
import random
import threading
from collections import OrderedDict, deque
from itertools import count

import numpy as np
import pytest
import torch

from repro.core import objects as jax_objects
from repro.core.index import IndexUpdate as JaxIndexUpdate
from repro.core.policies import DispatchPolicy as JaxPolicy
from repro.core.runtime import DiffusionRuntime as JaxRuntime
from repro.core.scheduler import Dispatcher as JaxDispatcher
from repro.core.scheduler import TaskQueue as JaxTaskQueue
from repro.experiments import WorkloadSpec as JaxWorkloadSpec
from repro.experiments import build_workload as jax_build_workload
from repro.kernels.stacking import ops as jax_st_ops
from repro_torch.core import objects as pt_objects
from repro_torch.core.index import IndexUpdate as PtIndexUpdate
from repro_torch.core.policies import DispatchPolicy as PtPolicy
from repro_torch.core.cache import EvictionPolicy
from repro_torch.core.runtime import CacheExecutorBase, _InputLedger
from repro_torch.core.runtime import DiffusionRuntime as PtRuntime
from repro_torch.core.scheduler import Dispatcher as PtDispatcher
from repro_torch.core.scheduler import TaskQueue as PtTaskQueue
from repro_torch.experiments import WorkloadSpec as PtWorkloadSpec
from repro_torch.experiments import build_workload as pt_build_workload
from repro_torch.kernels.stacking import ops as pt_st_ops

POLICIES = ["first-available", "first-cache-available", "max-cache-hit",
            "max-compute-util", "next-available"]


# --------------------------------------------------------------------------
# Dispatcher: a deterministic, thread-free call sequence
# --------------------------------------------------------------------------

def _task_shapes(seed: int, n_tasks: int, n_objects: int):
    rng = random.Random(seed)
    sizes = {f"o{i}": rng.choice([1_000, 5_000, 20_000])
             for i in range(n_objects)}
    shapes = []
    for i in range(n_tasks):
        k = rng.choice([1, 1, 2, 3])
        shapes.append((f"task{i}", tuple(rng.sample(sorted(sizes), k))))
    return sizes, shapes


def _drive(Dispatcher, Policy, Task, IndexUpdate, policy: str, seed: int):
    """Joins, waves of submissions, completions that admit each task's
    inputs into its executor's cache (and evict one old object), an
    executor leaving and one joining -- all in a fixed order.  Returns the
    trace of every dispatch: (tid, executor, hints) per round."""
    sizes, shapes = _task_shapes(seed, n_tasks=60, n_objects=24)
    d = Dispatcher(Policy(policy))
    clock = iter(float(i) for i in range(10**6))
    for e in ("e0", "e1", "e2", "e3"):
        d.executor_joined(e, next(clock))
    d.register_objects([jax_objects.DataObject(o, s) if Task is
                        jax_objects.Task else pt_objects.DataObject(o, s)
                        for o, s in sizes.items()])
    held: dict[str, list[str]] = {}
    trace = []
    waves = [shapes[i:i + 15] for i in range(0, len(shapes), 15)]
    for w, wave in enumerate(waves):
        d.submit([Task(inputs=ins, tid=tid) for tid, ins in wave],
                 next(clock))
        for rnd in range(40):
            disp = d.next_dispatches(next(clock))
            if not disp:
                break
            trace.append([(x.task.tid, x.executor,
                           tuple(sorted(x.hints.items()))) for x in disp])
            for x in disp:
                cache = held.setdefault(x.executor, [])
                added = tuple(o for o in x.task.inputs if o not in cache)
                cache.extend(added)
                removed = (cache.pop(0),) if len(cache) > 6 else ()
                d.apply_index_updates([IndexUpdate(x.executor, added=added,
                                                   removed=removed)])
                d.task_finished(x.task, next(clock), ok=True)
        if w == 1:
            d.executor_left("e1", next(clock))
        if w == 2:
            d.executor_joined("e4", next(clock))
    trace.append(sorted(t.tid for t in d.completed))
    trace.append(d.scores_match_reference())
    return trace


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", POLICIES)
def test_dispatcher_parity(policy, seed):
    jax_trace = _drive(JaxDispatcher, JaxPolicy, jax_objects.Task,
                       JaxIndexUpdate, policy, seed)
    pt_trace = _drive(PtDispatcher, PtPolicy, pt_objects.Task,
                      PtIndexUpdate, policy, seed)
    assert pt_trace == jax_trace
    assert len(jax_trace[-2]) == 60          # every task completed


def _lru_update(caches, eid, oid, cap):
    """Touch ``oid`` in ``eid``'s LRU cache of ``cap`` files; returns the
    IndexUpdate fields (added, removed)."""
    c = caches[eid]
    if oid in c:
        c.move_to_end(oid)
        return (), ()
    c[oid] = None
    return (oid,), ((c.popitem(last=False)[0],) if len(c) > cap else ())


def _drive_at_scale(pkg, policy: str, seed: int):
    """A locality-10 trace of 2,000 single-file tasks (files of 3, 6 or 12
    MB) queued at once over 64 executors with LRU caches that evict.  Half
    the caches start warm, so max-compute-util's score maps outgrow the
    256-task window before the queue drains below it, and half cold, so the
    first round falls back to the window's earliest unclaimed tasks.  One
    executor finishes at a time; attempt 500 fails and goes back to the
    front of the queue; attempt 700 gets a speculative twin that its
    original's completion cancels while still queued."""
    Dispatcher, Policy, Task, IndexUpdate, DataObject = pkg
    rng = random.Random(seed)
    files = [f"f{i}" for i in range(200)]
    order = [f for f in files for _ in range(10)]
    rng.shuffle(order)
    d = Dispatcher(Policy(policy))
    clock = count()
    caches = {}
    for i in range(64):
        eid = f"e{i}"
        d.executor_joined(eid, float(next(clock)))
        caches[eid] = OrderedDict.fromkeys(rng.sample(files, 30 * (i % 2)))
    d.register_objects([DataObject(f, rng.choice([3, 6, 6, 12]) * 10**6)
                        for f in files])
    d.apply_index_updates([IndexUpdate(e, added=tuple(c), removed=())
                           for e, c in caches.items()])
    d.submit([Task(inputs=(f,), tid=f"t{i}") for i, f in enumerate(order)],
             float(next(clock)))
    trace, running = [], deque()

    def pump():
        out = d.next_dispatches(float(next(clock)))
        trace.extend((x.task.tid, x.executor, tuple(sorted(x.hints.items())))
                     for x in out)
        running.extend(out)

    pump()
    for n in count(1):
        if not running:
            break
        x = running.popleft()
        if n == 500:
            assert d.task_finished(x.task, float(next(clock)), ok=False) \
                is None
            assert d.queue.first_live(1)[0] is x.task
            pump()
            continue
        twin = d.make_twin(x.task, float(next(clock))) if n == 700 else None
        added, removed = _lru_update(caches, x.executor, x.task.inputs[0], 32)
        d.apply_index_updates([IndexUpdate(x.executor, added=added,
                                           removed=removed)])
        cancel = d.task_finished(x.task, float(next(clock)), ok=True)
        if twin is not None:
            assert cancel == twin.tid and twin.tid not in d.queue
        pump()
    trace.append(sorted(t.tid for t in d.completed))
    trace.append(d.scores_match_reference())
    return trace


JAX_PKG = (JaxDispatcher, JaxPolicy, jax_objects.Task, JaxIndexUpdate,
           jax_objects.DataObject)
PT_PKG = (PtDispatcher, PtPolicy, pt_objects.Task, PtIndexUpdate,
          pt_objects.DataObject)


@pytest.mark.parametrize("policy", POLICIES)
def test_dispatcher_parity_at_scale(policy):
    jax_trace = _drive_at_scale(JAX_PKG, policy, seed=3)
    pt_trace = _drive_at_scale(PT_PKG, policy, seed=3)
    assert len(jax_trace[-2]) == 2_000       # every task completed once
    assert len(pt_trace) == len(jax_trace) == 2_001 + 2
    assert pt_trace == jax_trace


def _first_pick(pkg, n_far: int):
    """The first max-compute-util pick of an executor that caches the file
    of the window's last task (t255), the larger file of the first task past
    the window (t256), and ``n_far`` tasks' file further back."""
    Dispatcher, Policy, Task, IndexUpdate, DataObject = pkg
    d = Dispatcher(Policy("max-compute-util"))
    d.executor_joined("e0", 0.0)
    files = {255: "edge", 256: "big", **{i: "far" for i in range(300, 300
                                                                   + n_far)}}
    d.register_objects([DataObject("edge", 6_000_000),
                        DataObject("big", 12_000_000),
                        DataObject("far", 6_000_000)]
                       + [DataObject(f"u{i}", 6_000_000) for i in range(600)])
    d.apply_index_updates([IndexUpdate("e0", added=("edge", "big", "far"),
                                       removed=())])
    d.submit([Task(inputs=(files.get(i, f"u{i}"),), tid=f"t{i}")
              for i in range(600)], 1.0)
    assert len(d._exec_scores["e0"]) == 2 + n_far
    return [x.task.tid for x in d.next_dispatches(2.0)]


@pytest.mark.parametrize("n_far", [0, 300])
def test_mcu_pick_at_window_edge(n_far):
    """Read from the window's side (a score map of 302 entries) or from the
    map's (2 entries), the pick is the window's last task, not the higher
    score just past the window, as in the reference."""
    assert PtDispatcher.queue_window == JaxDispatcher.queue_window == 256
    got = _first_pick(PT_PKG, n_far)
    assert got == ["t255"] == _first_pick(JAX_PKG, n_far)


@pytest.mark.parametrize("seed", range(4))
def test_taskqueue_matches_reference(seed):
    """Random operation sequences: the port's queue answers every call as
    the reference's does (re-appends of queued tids, removals past the
    reference's compaction point, pops of an empty queue included)."""
    rng = random.Random(seed)
    tids = [f"q{i}" for i in range(48)]
    jt = {tid: jax_objects.Task(inputs=("o",), tid=tid) for tid in tids}
    pt = {tid: pt_objects.Task(inputs=("o",), tid=tid) for tid in tids}
    jq, pq = JaxTaskQueue(), PtTaskQueue()

    def same(f):
        try:
            want = ("ok", f(jq, jt))
        except (IndexError, KeyError) as e:
            want = ("raise", type(e))
        try:
            got = ("ok", f(pq, pt))
        except (IndexError, KeyError) as e:
            got = ("raise", type(e))
        assert got == want

    ops = [
        (6, lambda tid, n: lambda q, ts: q.append(ts[tid])),
        (3, lambda tid, n: lambda q, ts: q.appendleft(ts[tid])),
        (4, lambda tid, n: lambda q, ts: q.remove(tid)),
        (2, lambda tid, n: lambda q, ts: q.popleft().tid),
        (2, lambda tid, n: lambda q, ts: [t.tid for t in q.first_live(n)]),
        (2, lambda tid, n: lambda q, ts: q.position(tid)),
        (2, lambda tid, n: lambda q, ts: tid in q),
        (1, lambda tid, n: lambda q, ts: [t.tid for t in q]),
    ]
    weights = [w for w, _ in ops]
    for _ in range(4_000):
        (_, make), = rng.choices(ops, weights)
        same(make(rng.choice(tids), rng.randint(-1, 60)))
        same(lambda q, ts: (len(q), bool(q)))
    same(lambda q, ts: [(t.tid, q.position(t.tid)) for t in q])


def test_mcu_placement_cost_does_not_grow():
    """20,000 max-compute-util dispatches of a locality-10 trace queued at
    once, one executor finishing at a time, 64 executors with LRU caches of
    178 files: the queue and score entries placement examines per dispatch
    stay within the window's bound and do not grow as dispatches pile up."""
    rng = random.Random(0)
    order = [f"f{i}" for i in range(2_400) for _ in range(10)]
    rng.shuffle(order)
    d = PtDispatcher(PtPolicy.MAX_COMPUTE_UTIL)
    caches = {}
    for i in range(64):
        d.executor_joined(f"e{i}", 0.0)
        caches[f"e{i}"] = OrderedDict()
    d.register_objects([pt_objects.DataObject(f"f{i}", 6_000_000)
                        for i in range(2_400)])
    d.submit([pt_objects.Task(inputs=(f,), tid=f"t{i}")
              for i, f in enumerate(order)], 0.0)
    bound = 2 * d.queue_window + len(d.executors)
    running = deque(d.next_dispatches(0.0))
    per_dispatch = [d.decision_steps / len(running)] * len(running)
    now = 0.0
    while len(per_dispatch) < 20_000:
        x = running.popleft()
        now += 1.0
        added, removed = _lru_update(caches, x.executor, x.task.inputs[0],
                                     178)
        d.apply_index_updates([PtIndexUpdate(x.executor, added=added,
                                             removed=removed)])
        d.task_finished(x.task, now)
        before = d.decision_steps
        out = d.next_dispatches(now)
        assert out and len(d.queue) > d.queue_window
        steps = (d.decision_steps - before) / len(out)
        assert steps <= bound
        per_dispatch.extend([steps] * len(out))
        running.extend(out)
    first = sum(per_dispatch[:4_000]) / 4_000
    last = sum(per_dispatch[-4_000:]) / 4_000
    assert 0 < last <= 1.25 * first
    assert max(first, last) <= bound
    assert d.scores_match_reference()


def test_decision_steps_in_dispatch_stats():
    rt = PtRuntime(n_executors=2, policy=PtPolicy.MAX_COMPUTE_UTIL,
                   device="cpu")
    try:
        rt.put_object(pt_objects.DataObject("a", 4), np.zeros(4, np.uint8))
        rt.submit([pt_objects.Task(inputs=("a",), fn=lambda inputs: 0)
                   for _ in range(6)])
        assert rt.wait(30)
        st = rt.dispatch_stats()
        assert st["decision_steps"] == rt.dispatcher.decision_steps > 0
    finally:
        rt.shutdown()


# --------------------------------------------------------------------------
# workloads: same spec + seed -> same events
# --------------------------------------------------------------------------

GENERATORS = {
    "poisson-stacking": ({"kind": "PoissonArrivals", "rate_per_s": 50.0},
                         {"kind": "StackingTrace", "locality": 10,
                          "shuffle_seed": 0, "k": 1, "corr": 1.0}),
    "poisson-stacking-k3": ({"kind": "PoissonArrivals", "rate_per_s": 20.0},
                            {"kind": "StackingTrace", "locality": 3,
                             "shuffle_seed": 5, "k": 3, "corr": 0.5}),
    "sine-zipf": ({"kind": "SineWaveArrivals", "mean_rate": 10.0,
                   "amplitude": 8.0, "period_s": 5.0},
                  {"kind": "ZipfPopularity", "alpha": 1.1, "k": 2,
                   "corr": 0.8}),
    "bursty-shifting": ({"kind": "BurstyArrivals", "base_rate": 2.0,
                         "burst_rate": 40.0, "burst_every_s": 3.0,
                         "burst_len_s": 0.5},
                        {"kind": "ShiftingWorkingSet", "working_set": 6,
                         "shift_every": 10, "k": 2, "corr": 0.3}),
    "diurnal-uniform": ({"kind": "DiurnalArrivals", "peak_rate": 30.0,
                         "trough_rate": 1.0, "day_s": 20.0},
                        {"kind": "UniformScan", "stride": 3, "k": 2}),
    "batch-uniform": ({"kind": "BatchArrivals", "at_s": 0.5},
                      {"kind": "UniformScan"}),
}

DAG_BINDINGS = {
    "stacking_pyramid": {"kind": "stacking_pyramid", "n_groups": 5,
                         "group_size": 3, "object_bytes": 320_000,
                         "stack_bytes": 40_000, "mosaic_bytes": 40_000},
    "all_pairs": {"kind": "all_pairs", "n_objects": 4},
    "reduce_tree": {"kind": "reduce_tree", "n_leaves": 7, "fanin": 3},
}


def _events(wl):
    return ([(o.oid, o.size_bytes) for o in wl.objects],
            [(e.t, e.tid, e.inputs, e.outputs, e.compute_seconds,
              e.store_metadata_ops, e.deps) for e in wl.events],
            wl.spec)


@pytest.mark.parametrize("prefix", [None, "img"])
@pytest.mark.parametrize("kind", sorted(GENERATORS))
def test_generated_workload_parity(kind, prefix):
    arr, pop = GENERATORS[kind]
    kw = dict(name="wl", arrivals=arr, popularity=pop, n_tasks=120,
              n_objects=30, object_bytes=320_000, object_prefix=prefix,
              output_bytes=1_000 if prefix else 0, seed=11)
    jax_wl = jax_build_workload(JaxWorkloadSpec(**kw))
    pt_wl = pt_build_workload(PtWorkloadSpec(**kw))
    assert _events(pt_wl) == _events(jax_wl)


@pytest.mark.parametrize("kind", sorted(DAG_BINDINGS))
def test_dag_workload_parity(kind):
    binding = DAG_BINDINGS[kind]
    jax_wl = jax_build_workload(JaxWorkloadSpec(name="dag", dag=binding))
    pt_wl = pt_build_workload(PtWorkloadSpec(name="dag", dag=binding))
    assert _events(pt_wl) == _events(jax_wl)
    assert pt_wl.has_deps() and jax_wl.has_deps()


# --------------------------------------------------------------------------
# runtime: the deterministic regime (barrier_every <= pool, no eviction)
# --------------------------------------------------------------------------

TILES, H, W = 2, 12, 12


def _tiles(oid: str) -> np.ndarray:
    rng = np.random.default_rng([7, int(oid[3:])])
    return rng.normal(500, 100, (TILES, H, W)).astype(np.float32)


def _shift(oids, n):
    rng = np.random.default_rng([8, *[int(o[3:]) for o in oids]])
    return rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)


def _jax_task(inputs):
    tiles = np.concatenate([np.asarray(v) for v in inputs.values()], axis=0)
    n = tiles.shape[0]
    dy, dx = _shift(list(inputs), n)
    return np.asarray(jax_st_ops.stack_rois(tiles, tiles.mean(axis=(1, 2)) *
                                            0.1, np.ones(n, np.float32),
                                            dy, dx))


def _pt_task(inputs):
    tiles = torch.cat(list(inputs.values()), dim=0)
    n = tiles.shape[0]
    dy, dx = _shift(list(inputs), n)
    return pt_st_ops.stack_rois(tiles, tiles.mean(dim=(1, 2)) * 0.1,
                                torch.ones(n), torch.from_numpy(dy),
                                torch.from_numpy(dx))


def _run(rt, wl, task_fn):
    th = rt.submit_workload(wl, task_fn=task_fn,
                            payload_factory=lambda ob: _tiles(ob.oid),
                            barrier_every=4)
    th.join(120)
    assert not th.is_alive() and rt.wait(60)
    d, lg = rt.dispatcher, rt.ledger
    per_task = sorted((t.tid, t.executor, t.cache_hits, t.peer_hits,
                       t.cache_misses, t.bytes_local, t.bytes_cache_to_cache,
                       t.bytes_store) for t in d.completed)
    ledger = (lg.bytes_local, lg.bytes_c2c, lg.bytes_store, lg.local_hits,
              lg.peer_hits, lg.store_reads)
    results = {t.tid: t.result for t in d.completed}
    rt.shutdown()
    return per_task, ledger, results


@pytest.mark.parametrize("k", [1, 2])
def test_runtime_parity_deterministic_regime(k):
    spec = dict(name="rt", arrivals={"kind": "PoissonArrivals",
                                     "rate_per_s": 100.0},
                popularity={"kind": "StackingTrace", "locality": 4,
                            "shuffle_seed": 3, "k": k, "corr": 0.7},
                n_tasks=48, n_objects=12, object_bytes=TILES * H * W * 4,
                object_prefix="img", seed=2)
    jax_out = _run(JaxRuntime(n_executors=4, cache_capacity_bytes=10**9,
                              seed=1),
                   jax_build_workload(JaxWorkloadSpec(**spec)), _jax_task)
    pt_out = _run(PtRuntime(n_executors=4, cache_capacity_bytes=10**9,
                            seed=1, device="cpu"),
                  pt_build_workload(PtWorkloadSpec(**spec)), _pt_task)
    assert pt_out[0] == jax_out[0]        # placement + per-input split
    assert pt_out[1] == jax_out[1]        # the RuntimeLedger
    assert pt_out[1][4] > 0 or k == 1     # joins exercise peer fetches
    assert sorted(pt_out[2]) == sorted(jax_out[2])
    for tid, want in jax_out[2].items():
        got = pt_out[2][tid]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=np.abs(want).max() * 1e-5)


def test_runtime_caches_hold_device_tensors_and_free_on_eviction():
    """Store payloads are host tensors; cache entries are tensors on the
    runtime's device, kept by reference when already there (a peer hit or
    an output), and an eviction drops the entry."""
    from repro_torch.core.objects import DataObject, Task

    rt = PtRuntime(n_executors=2, cache_capacity_bytes=576, seed=0,
                   device="cpu")
    try:
        for i in range(3):
            rt.put_object(DataObject(f"img{i}", 576), _tiles(f"img{i}"))
        _, stored = rt.store.get("img0")
        assert isinstance(stored, torch.Tensor)
        seen = {}

        def fn(inputs):
            seen.update(inputs)
            return 0

        rt.submit([Task(inputs=("img0",), fn=fn, tid="a")])
        assert rt.wait(30)
        w = rt.workers[rt.dispatcher.tasks["a"].executor]
        assert w.payloads["img0"] is seen["img0"] is stored   # no copy on cpu
        rt.submit([Task(inputs=("img1",), fn=fn, tid="b")])
        assert rt.wait(30)
        rt.submit([Task(inputs=("img2",), fn=fn, tid="c")])
        assert rt.wait(30)
        caches = [w.cache for w in rt.workers.values()]
        assert sum(c.stats.evictions for c in caches) >= 1
        for w in rt.workers.values():
            assert set(w.payloads) == set(w.cache.contents())
    finally:
        rt.shutdown()


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        PtRuntime(n_executors=1)


# --------------------------------------------------------------------------
# Executors removed under load (tests/test_workloads.py's regressions)
# --------------------------------------------------------------------------

def test_runtime_survives_executor_removal_mid_workload():
    """An executor removed mid-workload must not double-complete its
    in-flight task (the retry is the only completion that counts), or
    wait() hangs."""
    from repro_torch.workloads import PoissonArrivals, UniformScan, generate
    for trial in range(3):
        wl = generate("fault", PoissonArrivals(500.0), UniformScan(),
                      n_tasks=60, n_objects=6, object_bytes=64, seed=trial)
        rt = PtRuntime(n_executors=3, policy=PtPolicy.MAX_COMPUTE_UTIL,
                       device="cpu")
        th = rt.submit_workload(
            wl, task_fn=lambda inputs: sum(len(v) for v in inputs.values()),
            payload_factory=lambda ob: np.full(64, ord("y"), np.uint8),
            time_scale=0.005)
        rt.remove_executor("w1", failed=True)
        th.join(30.0)
        assert not th.is_alive()
        assert rt.wait(30.0), "wait() hung after mid-run executor removal"
        assert len(rt.dispatcher.completed) + len(rt.dispatcher.failed) == 60
        assert rt._outstanding == 0
        rt.shutdown()


def test_runtime_terminal_failure_on_removed_worker_does_not_leak_wait():
    """A last-attempt task running on a removed worker goes terminally
    FAILED (no retry); wait() must still drain to zero."""
    import time

    rt = PtRuntime(n_executors=1, device="cpu")
    rt.put_object(pt_objects.DataObject("a", 4), np.zeros(4, np.uint8))
    t = pt_objects.Task(inputs=("a",), fn=lambda inputs: time.sleep(0.5) or 1,
                        max_attempts=1)
    rt.submit([t])
    time.sleep(0.1)                          # the task is running on w0
    rt.remove_executor("w0", failed=True)
    assert rt.wait(10.0), "wait() leaked after terminal in-flight failure"
    assert rt._outstanding == 0
    assert len(rt.dispatcher.failed) == 1
    rt.shutdown()


def test_runtime_executor_ids_never_reused():
    """add after remove mints a fresh id: reusing f"w{len(workers)}" would
    overwrite a live worker and lose its task."""
    rt = PtRuntime(n_executors=3, device="cpu")
    rt.remove_executor("w1")
    assert rt.add_executor() == "w3"
    assert sorted(rt.workers) == ["w0", "w2", "w3"]
    rt.shutdown()


def _release_while_running(Runtime, objects, **kw):
    """Two executors; one slow task on one of them, which is released (not
    failed) while the task runs.  Returns (runtime, task) after wait()."""
    import time

    rt = Runtime(n_executors=2, **kw)
    rt.put_object(objects.DataObject("a", 64),
                  np.arange(16, dtype=np.float32))
    t = objects.Task(inputs=("a",),
                     fn=lambda inputs: time.sleep(0.3) or float(
                         inputs["a"].sum()))
    rt.submit([t])
    deadline = time.monotonic() + 10.0
    running = []
    while not running and time.monotonic() < deadline:
        time.sleep(0.01)
        with rt._lock:
            running = [e for e, st in rt.dispatcher.executors.items()
                       if t.tid in st.running]
    assert running, "the task never started"
    rt.remove_executor(running[0])
    assert rt.wait(10.0)
    return rt, t


def test_runtime_release_while_a_task_runs_retries_it_once():
    """An executor released while its task runs: the task is re-queued and
    its retry completes elsewhere; the released attempt's outcome is
    dropped (``dropped_attempts``) and the result is the reference's."""
    import time

    rt, t = _release_while_running(PtRuntime, pt_objects, device="cpu")
    deadline = time.monotonic() + 10.0
    while rt.dropped_attempts < 1 and time.monotonic() < deadline:
        time.sleep(0.01)     # the released attempt runs on to its end
    assert len(rt.dispatcher.completed) == 1
    assert len(rt.dispatcher.failed) == 0
    assert rt.dropped_attempts == 1
    assert rt._outstanding == 0
    jrt, jt = _release_while_running(JaxRuntime, jax_objects)
    assert t.result == jt.result == float(np.arange(16).sum())
    assert t.attempts == jt.attempts
    rt.shutdown()
    jrt.shutdown()


# --------------------------------------------------------------------------
# The executor's one request path, through a minimal subclass
# --------------------------------------------------------------------------

class _StubExecutor(CacheExecutorBase):
    """Peers are a dict (a peer absent from it cannot be reached, one that
    maps to None misses); the store holds one 64-byte object."""

    def __init__(self, peers: dict):
        super().__init__("e1", 1 << 20, EvictionPolicy.LRU, 0,
                         torch.device("cpu"))
        self.peers = peers
        self.calls: list[tuple[str, str]] = []
        self.announced: list[tuple[tuple, tuple]] = []

    def _peer_payload(self, peer_id, oid):
        self.calls.append(("peer", peer_id))
        return self.peers.get(peer_id)

    def _store_read(self, oid):
        self.calls.append(("store", oid))
        return pt_objects.DataObject(oid, 64), torch.full((4,), 3.0)

    def _announce(self, added, removed):
        self.announced.append((added, removed))


@pytest.mark.parametrize("recorded", [False, True])
@pytest.mark.parametrize("source", ["local", "peer", "store"])
def test_the_one_request_path_stages_local_then_hinted_peers_then_store(
        source, recorded):
    """``CacheExecutorBase.attempt``: a local hit first; else the hinted
    peers in hint order, skipping the executor itself and a peer it cannot
    reach; else the store.  Each input is counted in the attempt's
    ``_InputLedger`` and, with a recorder, in one ``input`` event; without
    one the thread never carries a request context."""
    from repro_torch import obs
    from repro_torch.obs import recorder as recorder_mod

    size = 48
    peers = {"p_miss": None, "p_hit": torch.full((4,), 2.0),
             "p_later": torch.full((4,), 5.0)}
    if source == "store":
        peers["p_hit"] = peers["p_later"] = None
    ex = _StubExecutor(peers)
    if source == "local":
        ex.cache_admit(pt_objects.DataObject("x", size), torch.ones(4))
    hints = {"x": ["e1", "p_gone", "p_miss", "p_hit", "p_later"]}
    rec = obs.Recorder() if recorded else None
    seen, out = [], {}

    def fn(inputs):
        seen.append((obs.request(), dict(vars(recorder_mod._REQUEST))))
        return inputs["x"] * 10

    def run():   # a fresh thread: its request context starts unset
        out["r"] = ex.attempt(rec, "t0", fn, [("x", size)],
                              [pt_objects.DataObject("y", 16)], hints)
        out["after"] = obs.request()

    th = threading.Thread(target=run)
    th.start()
    th.join()
    ok, result, acc = out["r"]
    want_x = {"local": 1.0, "peer": 2.0, "store": 3.0}[source]
    assert ok and torch.equal(result, torch.full((4,), want_x * 10))
    assert ex.cache_lookup("y") is result

    peer_calls = [("peer", p) for p in ("p_gone", "p_miss", "p_hit")]
    assert ex.calls == {"local": [], "peer": peer_calls,
                        "store": peer_calls + [("peer", "p_later"),
                                               ("store", "x")]}[source]
    want = {"local": _InputLedger(bytes_local=size, cache_hits=1),
            "peer": _InputLedger(bytes_cache_to_cache=size, peer_hits=1,
                                 cache_misses=1),
            "store": _InputLedger(bytes_store=64, cache_misses=1)}[source]
    assert acc == want
    # the staged input (unless it was local already) and the output are
    # admitted, and each admission is announced
    assert ex.announced == ([] if source == "local" else
                            [(("x",), ())]) + [(("y",), ())]

    assert out["after"] is None
    if not recorded:
        assert seen == [(None, {})]
        return
    assert seen == [((rec, "t0", "e1"), {"ctx": (rec, "t0", "e1")})]
    inputs = [{k: e[k] for k in e if k != "t"} for e in rec.events()
              if e["kind"] == "input"]
    event = {"kind": "input", "tid": "t0", "eid": "e1", "oid": "x",
             "source": source, "bytes": 64 if source == "store" else size}
    if source == "peer":
        event["peer"] = "p_hit"
    assert inputs == [event]
    assert [e["kind"] for e in rec.events()] == ["input", "exec_start",
                                                 "exec_end"]
    spans = {s["kind"]: s for s in rec.spans()}
    assert sorted(spans) == (["fn", "store_copy"] if source == "store"
                             else ["fn"])
    assert spans["fn"]["ok"] is True and spans["fn"]["tid"] == "t0"
    if source == "store":
        assert spans["store_copy"]["bytes"] == 64
        assert spans["store_copy"]["parent"] == "stage"
