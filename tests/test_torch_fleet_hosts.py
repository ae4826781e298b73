"""The port's fleet under failure, whole-host provisioning, hierarchical
dispatch and observability, on the CPU.

Counterparts of ``tests/test_fleet.py``'s SIGKILL, provisioning,
hierarchical-dispatch, dispatch-stats and event-forwarding tests
(``tests/test_torch_fleet.py`` holds the rest):

  * SIGKILLing a host mid-workload re-queues its in-flight tasks through
    ``executor_left``, the run drains with every task accounted, and the
    global byte ledger equals the sum of completed tasks' ledgers;
  * a hierarchical fleet (leases, claims) drains, survives the death of a
    lease holder, and under batch-synchronous replay places exactly as the
    in-process runtime with no lease ever granted;
  * the DRP moves whole hosts (``allocate_quantum``);
  * host-recorded events reach the central recorder before each task's
    ``task_done``, with the same per-task lifecycle as the reference's
    fleet.

Hosts run on ``device="cpu"``.  Every wait and join has a bound, and every
fleet is shut down in a ``finally``.
"""
from __future__ import annotations

import threading
import time

import pytest
import torch

from repro.core import DataObject as JaxDataObject
from repro.core import Task as JaxTask
from repro.fleet import FleetRuntime as JaxFleetRuntime
from repro.obs import Recorder as JaxRecorder
from repro.obs import lifecycle_fingerprints as jax_fingerprints
from repro_torch.core import (AllocationPolicy, DataObject, DiffusionRuntime,
                              DynamicResourceProvisioner, Task)
from repro_torch.experiments import (CacheSpec, ClusterSpec, ExperimentSpec,
                                     RuntimeEngine, WorkloadSpec)
from repro_torch.fleet import FleetRuntime
from repro_torch.obs import Recorder, lifecycle_fingerprints
from repro_torch.workloads import ARRIVALS, POPULARITY, generate

CPU = dict(device="cpu")
SLOW = "repro_torch.fleet.runtime:slow_task"


def _put_all(rt, n_objects=12, size=1000):
    objs = [DataObject(f"o{i}", size) for i in range(n_objects)]
    for ob in objs:
        rt.put_object(ob, torch.full((size,), ord("x"), dtype=torch.uint8))
    return objs


def _conservation(rt):
    """Global ledger must equal the sum over completed tasks -- exactly."""
    lg, d = rt.ledger, rt.dispatcher
    sums = [0] * 6
    for t in d.completed:
        sums[0] += t.bytes_local
        sums[1] += t.bytes_cache_to_cache
        sums[2] += t.bytes_store
        sums[3] += t.cache_hits
        sums[4] += t.peer_hits
        sums[5] += t.cache_misses - t.peer_hits
    assert sums == [lg.bytes_local, lg.bytes_c2c, lg.bytes_store,
                    lg.local_hits, lg.peer_hits, lg.store_reads]


# --------------------------------------------------------------------------
# failure semantics
# --------------------------------------------------------------------------

def test_sigkill_host_mid_workload_drains_and_conserves():
    """SIGKILL a host while its executors hold in-flight tasks: those tasks
    re-queue and run elsewhere, the run drains (no wait() leak),
    membership shrinks by exactly one whole host, and the ledger merge
    stays race-free."""
    rt = FleetRuntime(hosts=3, threads_per_host=2, task_fn_name=SLOW,
                      heartbeat_timeout_s=2.0, **CPU)
    try:
        _put_all(rt, n_objects=16)
        n = 240
        rt.submit(Task(inputs=(f"o{i % 16}",)) for i in range(n))
        time.sleep(0.15)          # let work spread across all hosts
        victim = rt.manager.handles["h1"]
        victim_eids = set(victim.eids)
        rt.manager.kill_host("h1")
        assert rt.wait(60), "wait() leaked after host SIGKILL"
        d = rt.dispatcher
        assert len(d.completed) + len(d.failed) == n
        assert not d.failed       # default max_attempts=3 absorbs one kill
        assert victim_eids.isdisjoint(rt.workers)
        assert len(rt.workers) == 4
        retried = [t for t in d.completed if t.attempts > 0]
        assert all(t.executor in rt.workers for t in retried)
        _conservation(rt)
        assert [n for _, n in rt.pool_log][-1] == 4
        victim.proc.join(10)
        assert victim.proc.exitcode == -9     # the process is gone
    finally:
        rt.shutdown()


def test_sigkill_with_single_attempt_accounts_terminal_failures():
    """max_attempts=1 turns every in-flight task on the killed host into a
    terminal failure at executor_left time; wait() must still drain and
    completed+failed must cover every submitted task."""
    rt = FleetRuntime(hosts=2, threads_per_host=2, task_fn_name=SLOW, **CPU)
    try:
        _put_all(rt)
        n = 160
        tasks = [Task(inputs=(f"o{i % 12}",)) for i in range(n)]
        for t in tasks:
            t.max_attempts = 1
        rt.submit(tasks)
        time.sleep(0.1)
        rt.manager.kill_host("h0")
        assert rt.wait(60), "wait() leaked terminal failures"
        d = rt.dispatcher
        assert len(d.completed) + len(d.failed) == n
        _conservation(rt)
    finally:
        rt.shutdown()


def test_failed_task_fn_is_a_failed_task():
    """A task fn that raises inside a host is a failed attempt, reported
    upstream with its error -- never a result."""
    rt = FleetRuntime(hosts=1, threads_per_host=1,
                      task_fn_name="repro_torch.apps.astro:stack_object",
                      **CPU)
    try:
        _put_all(rt, n_objects=1)         # oids "o0": not stackable files
        t = Task(inputs=("o0",))
        t.max_attempts = 1
        rt.submit([t])
        assert rt.wait(60)
        d = rt.dispatcher
        assert not d.completed and len(d.failed) == 1
        assert "ValueError" in str(d.failed[0].result)
    finally:
        rt.shutdown()


# --------------------------------------------------------------------------
# whole-host provisioning
# --------------------------------------------------------------------------

class TestWholeHostProvisioning:
    def test_allocate_quantum_rounds_requests(self):
        prov = DynamicResourceProvisioner(
            min_executors=0, max_executors=8,
            policy=AllocationPolicy.ONE_AT_A_TIME,
            trigger_cooldown_s=0.0, allocate_quantum=2)
        acts = prov.step(1.0, queue_len=5, live_executors=0,
                         inflight_allocations=0, idle_executors=[])
        assert acts.allocate == 2      # +1 request buys one whole host
        acts = prov.step(2.0, queue_len=5, live_executors=7,
                         inflight_allocations=0, idle_executors=[])
        assert acts.allocate == 0      # no room for a whole host below max

    def test_zero_room_is_not_a_trigger(self):
        prov = DynamicResourceProvisioner(
            min_executors=0, max_executors=10,
            policy=AllocationPolicy.EXPONENTIAL,
            trigger_cooldown_s=0.0, allocate_quantum=4)
        acts = prov.step(1.0, 5, 0, 0, [])
        assert acts.allocate == 4      # burst 1 rounded up to one host
        for t in range(2, 50):
            acts = prov.step(float(t), 5, 8, 0, [])
            assert acts.allocate == 0
        assert prov._exp_burst <= 4    # no unbounded doubling at room==0
        assert prov.n_allocated == 4

    def test_release_truncates_to_whole_quanta(self):
        prov = DynamicResourceProvisioner(
            min_executors=1, max_executors=8, allocate_quantum=2)
        acts = prov.step(100.0, queue_len=0, live_executors=6,
                         inflight_allocations=0,
                         idle_executors=["a", "b", "c", "d", "e"])
        assert acts.release == ["a", "b", "c", "d"]

    def test_quantum_one_is_bit_identical_legacy(self):
        old = DynamicResourceProvisioner(max_executors=8,
                                         policy=AllocationPolicy.ADDITIVE,
                                         additive_k=3, trigger_cooldown_s=0.0)
        acts = old.step(1.0, 5, 4, 0, [])
        assert acts.allocate == 3 and old.n_allocated == 3

    def test_fleet_grows_and_releases_whole_hosts(self):
        rt = FleetRuntime(hosts=1, threads_per_host=2, **CPU)
        try:
            _put_all(rt)
            assert len(rt.workers) == 2
            rt.provision_grow(4)
            assert len(rt.workers) == 6
            assert len(rt.manager.live_handles()) == 3
            rt.submit(Task(inputs=(f"o{i % 12}",)) for i in range(30))
            assert rt.wait(30)
            idle = rt.provision_idle(time.monotonic(), idle_for_s=0.0)
            assert idle and len(idle) % 2 == 0
            keep_host = rt.manager.live_handles()[0].host_id
            victims = [e for e in idle
                       if rt.workers[e].host.host_id != keep_host]
            rt.provision_release(victims[:2])
            assert len(rt.manager.live_handles()) == 2
            assert len(rt.workers) == 4
            rt.submit(Task(inputs=("o0",)) for _ in range(10))
            assert rt.wait(30)
            assert len(rt.dispatcher.completed) == 40
            with pytest.raises(RuntimeError, match="whole hosts"):
                rt.add_executor()
            with pytest.raises(RuntimeError, match="whole hosts"):
                rt.remove_executor("w0")
        finally:
            rt.shutdown()

    def test_fleet_engine_drp_allocates_host_multiples(self):
        spec = ExperimentSpec(
            name="fleet-drp",
            cluster=ClusterSpec(testbed="anl_uc", n_nodes=2),
            cache=CacheSpec(capacity_bytes=10**9),
            policy="max-compute-util",
            provisioner={"policy": "additive", "additive_k": 2,
                         "min_executors": 2, "max_executors": 8,
                         "queue_threshold": 2, "idle_timeout_s": 30.0,
                         "trigger_cooldown_s": 0.0, "period_s": 0.05},
            workload=WorkloadSpec(
                name="drp",
                arrivals={"kind": "PoissonArrivals", "rate_per_s": 400.0},
                popularity={"kind": "ZipfPopularity", "alpha": 1.1, "k": 1,
                            "corr": 1.0},
                n_tasks=300, n_objects=32, object_bytes=10**5, seed=9),
            seed=1, hosts=1, threads_per_host=2)
        spec = ExperimentSpec.from_dict(spec.to_dict())   # exercise strict IO
        eng = RuntimeEngine(**CPU)
        try:
            eng.prepare(spec)
            rep = eng.run(time_scale=0.02, timeout=180.0)
        finally:
            eng.shutdown()
        assert rep.n_completed == 300
        assert rep.n_allocated > 0
        assert rep.n_allocated % 2 == 0        # whole hosts only
        assert rep.peak_executors % 2 == 0
        assert rep.peak_executors > 2
        assert eng.provision_failures == []


# --------------------------------------------------------------------------
# hierarchical dispatch: local claims, lease reclaim, replay parity
# --------------------------------------------------------------------------

class TestHierarchicalDispatch:
    def test_local_dispatch_end_to_end_with_claims(self):
        rt = FleetRuntime(hosts=2, threads_per_host=2, local_dispatch=True,
                          task_fn_name="repro_torch.fleet.runtime:fleet_task",
                          **CPU)
        try:
            _put_all(rt)
            rt.submit(Task(inputs=(f"o{i % 12}",)) for i in range(120))
            assert rt.wait(60)
            d = rt.dispatcher
            assert len(d.completed) == 120 and not d.failed
            st = rt.dispatch_stats()
            assert st["leases"] > 0 and st["claims"] > 0
            assert st["claims"] + st["claim_conflicts"] <= st["leases"]
            _conservation(rt)
        finally:
            rt.shutdown()

    def test_sigkill_host_with_outstanding_leases_drains(self):
        rt = FleetRuntime(hosts=3, threads_per_host=2, local_dispatch=True,
                          task_fn_name=SLOW, heartbeat_timeout_s=2.0, **CPU)
        try:
            _put_all(rt, n_objects=16)
            n = 200
            rt.submit(Task(inputs=(f"o{i % 16}",)) for i in range(n))
            time.sleep(0.15)
            rt.manager.kill_host("h1")
            assert rt.wait(60), "wait() leaked after killing a lease holder"
            d = rt.dispatcher
            assert len(d.completed) == n and not d.failed
            assert rt.dispatch_stats()["leases"] > 0
            _conservation(rt)
        finally:
            rt.shutdown()

    def test_hierarchical_batched_replay_matches_single_process(self):
        """Batch-synchronous replay (B <= pool) on a hierarchical fleet, at
        both wire_batch extremes, is placement-identical to the in-process
        runtime, and leases never engage."""
        wl = generate("hier",
                      ARRIVALS["PoissonArrivals"](rate_per_s=100.0),
                      POPULARITY["ZipfPopularity"](alpha=1.1, k=2, corr=0.8),
                      n_tasks=120, n_objects=32, object_bytes=50_000,
                      seed=11)

        def run(rt):
            try:
                th = rt.submit_workload(wl, payload_factory=lambda ob: b"p",
                                        barrier_every=4)
                th.join(120)
                assert not th.is_alive() and rt.wait(60)
                d = rt.dispatcher
                per_task = sorted((t.tid, t.executor, t.cache_hits,
                                   t.peer_hits, t.cache_misses)
                                  for t in d.completed)
                st = (rt.dispatch_stats() if isinstance(rt, FleetRuntime)
                      else {})
                return per_task, st
            finally:
                rt.shutdown()

        base, _ = run(DiffusionRuntime(n_executors=4,
                                       cache_capacity_bytes=10**12, seed=3,
                                       **CPU))
        for wb in (64, 1):
            per, st = run(FleetRuntime(hosts=2, threads_per_host=2,
                                       cache_capacity_bytes=10**12, seed=3,
                                       local_dispatch=True, wire_batch=wb,
                                       **CPU))
            assert per == base, f"placement drift at wire_batch={wb}"
            assert st["leases"] == 0 and st["claims"] == 0


class TestDispatchStatsConservation:
    """dispatch_stats() takes its live-handle snapshot under the runtime
    lock, so a host retiring concurrently is counted exactly once."""

    COUNTERS = ("frames_sent", "msgs_sent", "frames_recv", "msgs_recv",
                "leases", "claims", "claim_conflicts", "dispatches")

    def test_no_reading_exceeds_final_totals_under_sigkill(self):
        rt = FleetRuntime(hosts=3, threads_per_host=2, local_dispatch=True,
                          task_fn_name=SLOW, heartbeat_timeout_s=2.0, **CPU)
        readings: list[dict] = []
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                readings.append(rt.dispatch_stats())

        th = threading.Thread(target=hammer, daemon=True)
        try:
            _put_all(rt, n_objects=16)
            n = 200
            rt.submit(Task(inputs=(f"o{i % 16}",)) for i in range(n))
            th.start()
            time.sleep(0.15)
            rt.manager.kill_host("h1")   # dies holding leases mid-batch
            assert rt.wait(60), "wait() leaked after SIGKILL"
            assert len(rt.dispatcher.completed) == n
            for h in list(rt.manager.live_handles()):
                rt.manager.kill_host(h.host_id)
            deadline = time.monotonic() + 15
            while rt.manager.live_handles() and time.monotonic() < deadline:
                time.sleep(0.02)
            assert not rt.manager.live_handles(), "hosts never retired"
            stop.set()
            th.join(10)
            final = rt.dispatch_stats()
        finally:
            stop.set()
            rt.shutdown()
        assert readings, "stats hammer never ran"
        for d in readings:
            for k in self.COUNTERS:
                assert d[k] <= final[k], \
                    f"{k} read {d[k]} > final {final[k]}: double-count"
        assert final["leases"] > 0
        assert final["claims"] + final["claim_conflicts"] <= final["leases"]
        assert final["msgs_sent"] >= final["frames_sent"] > 0
        assert final["msgs_recv"] >= final["frames_recv"] > 0

    def test_stats_decompose_into_folded_plus_live(self):
        rt = FleetRuntime(hosts=2, threads_per_host=2,
                          task_fn_name="repro_torch.fleet.runtime:fleet_task",
                          **CPU)
        try:
            _put_all(rt)
            rt.submit(Task(inputs=(f"o{i % 12}",)) for i in range(40))
            assert rt.wait(60)
            with rt._lock:
                expect = rt.stats.as_dict()
                for h in rt.manager.live_handles():
                    expect["frames_sent"] += h.frames_sent
                    expect["msgs_sent"] += h.msgs_sent
                    expect["frames_recv"] += h.frames_recv
                    expect["msgs_recv"] += h.msgs_recv
            got = rt.dispatch_stats()
            for k in ("frames_sent", "msgs_sent", "leases", "claims",
                      "claim_conflicts", "dispatches"):
                assert got[k] == expect[k], k
            assert got["frames_recv"] >= expect["frames_recv"]
            assert got["msgs_recv"] >= expect["msgs_recv"]
        finally:
            rt.shutdown()


# --------------------------------------------------------------------------
# observability across the wire
# --------------------------------------------------------------------------

def _recorded_kinds(FleetRuntime_, DataObject_, Task_, Recorder_,
                    fingerprints, fn_name, payload):
    rec = Recorder_()
    rt = FleetRuntime_(hosts=2, threads_per_host=2, recorder=rec,
                       task_fn_name=fn_name,
                       **({} if FleetRuntime_ is JaxFleetRuntime else CPU))
    try:
        for i in range(12):
            rt.put_object(DataObject_(f"o{i}", 1000), payload)
        n = 40
        rt.submit(Task_(inputs=(f"o{i % 12}",), tid=f"t{i}")
                  for i in range(n))
        assert rt.wait(60)
        assert len(rt.dispatcher.completed) == n
    finally:
        rt.shutdown()
    assert rec.dropped == 0
    fps = fingerprints(rec.events())
    return {tid: (kinds, len(inputs)) for tid, (kinds, _, inputs)
            in fps.items()}


def test_fleet_event_forwarding_reaches_central_ring():
    """Host-recorded exec/input events land in the central recorder, each
    task's exec events before its central task_done; every task's
    lifecycle has the kinds the reference's fleet records."""
    got = _recorded_kinds(FleetRuntime, DataObject, Task, Recorder,
                          lifecycle_fingerprints,
                          "repro_torch.fleet.runtime:fleet_task",
                          torch.zeros(1000, dtype=torch.uint8))
    want = _recorded_kinds(JaxFleetRuntime, JaxDataObject, JaxTask,
                           JaxRecorder, jax_fingerprints,
                           "repro.fleet.runtime:fleet_task", b"x" * 1000)
    assert len(got) == 40
    for tid, (kinds, n_inputs) in got.items():
        assert kinds[0] == "task_arrived" and kinds[-1] == "task_done"
        assert kinds.index("exec_end") < kinds.index("task_done"), tid
        assert n_inputs == 1
        assert sorted(set(kinds)) == sorted(set(want[tid][0])), tid


def test_bind_host_loopback_alias():
    """Bind the whole fleet (central listener, host peer servers) to a
    loopback alias; hosts advertise it in their hello and cache-to-cache
    traffic -- tensors over the socket -- flows through it."""
    rt = FleetRuntime(hosts=2, threads_per_host=1, bind_host="127.0.0.2",
                      task_fn_name="repro_torch.fleet.runtime:fleet_task",
                      **CPU)
    try:
        assert rt.manager.addr[0] == "127.0.0.2"
        for h in rt.manager.live_handles():
            assert h.peer_host == "127.0.0.2"     # advertised, not assumed
        _put_all(rt, n_objects=8)
        rt.submit(Task(inputs=(f"o{i % 8}", f"o{(i + 3) % 8}"))
                  for i in range(60))
        assert rt.wait(60)
        assert len(rt.dispatcher.completed) == 60
        assert rt.ledger.peer_hits > 0            # c2c went over the alias
        _conservation(rt)
    finally:
        rt.shutdown()
