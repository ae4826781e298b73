"""Scheduling parity between the port and the JAX package's framework-neutral
core: the same catalog, tasks and call sequence must give the same dispatch
sequence and hints (exactly), the same workload events, and -- in the
runtime's deterministic regime -- the same per-task placement, input split
and byte ledger."""
import random

import numpy as np
import pytest
import torch

from repro.core import objects as jax_objects
from repro.core.index import IndexUpdate as JaxIndexUpdate
from repro.core.policies import DispatchPolicy as JaxPolicy
from repro.core.runtime import DiffusionRuntime as JaxRuntime
from repro.core.scheduler import Dispatcher as JaxDispatcher
from repro.experiments import WorkloadSpec as JaxWorkloadSpec
from repro.experiments import build_workload as jax_build_workload
from repro.kernels.stacking import ops as jax_st_ops
from repro_torch.core import objects as pt_objects
from repro_torch.core.index import IndexUpdate as PtIndexUpdate
from repro_torch.core.policies import DispatchPolicy as PtPolicy
from repro_torch.core.runtime import DiffusionRuntime as PtRuntime
from repro_torch.core.scheduler import Dispatcher as PtDispatcher
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
