"""The port's fleet end to end on the CPU: host processes, sockets, the
single-process parity contract, the experiment layer's fleet mode, and the
paper's stacking task run inside the hosts -- each against the JAX
package's fleet where the two can be compared.

Counterparts of ``tests/test_fleet.py``'s channel units, end-to-end runs,
trace-replay parity and engine tests (its failure, provisioning,
hierarchical-dispatch and observability tests are in
``tests/test_torch_fleet_hosts.py``), plus:

  * the same recorded Zipf trace replayed batch-synchronously on the
    reference's ``FleetRuntime(2, 2)`` and the port's
    ``FleetRuntime(2, 2, device="cpu")``: identical per-task placement and
    ledger;
  * a 2 x 2 fleet running ``repro_torch.apps.astro:stack_object``: its
    outputs, fetched from the hosts' caches through their peer servers,
    equal the in-process port's exactly (on the CPU both take the
    kernel's plain version);
  * a spawned host holds no ``jax`` or ``repro`` module, and a host that
    cannot get its device fails its spawn at once;
  * ``convert.spec_from_json`` taking a fleet spec at values other than the
    defaults.

Hosts run on ``device="cpu"``.  Every wait and join has a bound, and every
fleet is shut down in a ``finally``.
"""
from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from repro import experiments as jax_exp
from repro.fleet import FleetRuntime as JaxFleetRuntime
from repro.workloads import replay as jax_replay
from repro_torch import convert
from repro_torch.apps import astro
from repro_torch.core import DataObject, DiffusionRuntime, Task
from repro_torch.core.channel import (CallbackChannel, Channel, ChannelClosed,
                                      LocalChannel)
from repro_torch.experiments import (CacheSpec, ClusterSpec, ExperimentSpec,
                                     RuntimeEngine, WorkloadSpec,
                                     run_experiment)
from repro_torch.fleet import FleetRuntime, reports_scheduling_equal
from repro_torch.fleet.host import PeerClient
from repro_torch.fleet.manager import HostManager
from repro_torch.workloads import replay

CPU = dict(device="cpu")


# --------------------------------------------------------------------------
# channel units (the in-process seam implementations)
# --------------------------------------------------------------------------

class TestChannels:
    def test_local_channel_orders_and_closes(self):
        ch = LocalChannel()
        for i in range(5):
            ch.send(i)
        assert [ch.recv() for _ in range(5)] == list(range(5))
        ch.close()
        with pytest.raises(ChannelClosed):
            ch.recv()
        with pytest.raises(ChannelClosed):
            ch.send(99)

    def test_local_channel_drains_before_close_signal(self):
        ch = LocalChannel()
        ch.send("pending")
        ch.close()
        assert ch.recv() == "pending"   # queued work survives the close
        with pytest.raises(ChannelClosed):
            ch.recv()

    def test_local_channel_recv_timeout(self):
        ch = LocalChannel()
        with pytest.raises(TimeoutError):
            ch.recv(timeout=0.01)

    def test_callback_channel_is_synchronous(self):
        seen = []
        ch = CallbackChannel(seen.append)
        ch.send(1)
        assert seen == [1]              # delivered before send returns
        with pytest.raises(ChannelClosed):
            ch.recv()
        ch.close()
        with pytest.raises(ChannelClosed):
            ch.send(2)

    def test_runtime_routes_both_seams_through_channels(self):
        """The dispatch inbox and the update path are Channel objects the
        fleet can substitute."""
        rt = DiffusionRuntime(n_executors=1, **CPU)
        try:
            assert isinstance(rt.update_channel, Channel)
            assert isinstance(next(iter(rt.workers.values())).inbox, Channel)
        finally:
            rt.shutdown()


# --------------------------------------------------------------------------
# fleet end-to-end
# --------------------------------------------------------------------------

def _put_all(rt, n_objects=12, size=1000):
    """Catalog objects whose payloads are CPU tensors of ``size`` bytes:
    they cross the wire as tensors (store broadcasts, peer fetches)."""
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


@pytest.mark.parametrize("codec", ["auto", "json"])
def test_fleet_end_to_end(codec):
    rt = FleetRuntime(hosts=2, threads_per_host=2, codec=codec,
                      task_fn_name="repro_torch.fleet.runtime:fleet_task",
                      **CPU)
    try:
        _put_all(rt)
        rt.submit(Task(inputs=(f"o{i % 12}",)) for i in range(60))
        assert rt.wait(60)
        d = rt.dispatcher
        assert len(d.completed) == 60 and not d.failed
        lg = rt.ledger
        assert lg.local_hits + lg.peer_hits + lg.store_reads == 60
        assert all(t.cache_hits + t.cache_misses == 1 for t in d.completed)
        _conservation(rt)
    finally:
        rt.shutdown()


def _zipf_trace(tmp_path, name, n_tasks, seed):
    """The same k-input Zipf trace recorded by the reference's generator
    (``replay`` of it gives each package its own workload objects)."""
    from repro.workloads import ARRIVALS as JA
    from repro.workloads import POPULARITY as JP
    from repro.workloads import generate as jgenerate
    from repro.workloads import record as jrecord

    wl = jgenerate(name, JA["PoissonArrivals"](rate_per_s=100.0),
                   JP["ZipfPopularity"](alpha=1.1, k=2, corr=0.8),
                   n_tasks=n_tasks, n_objects=32, object_bytes=50_000,
                   seed=seed)
    trace = tmp_path / f"{name}.jsonl"
    jrecord(wl, trace)
    return trace


def _replay_run(rt, wl, payload=b"p"):
    try:
        th = rt.submit_workload(wl, payload_factory=lambda ob: payload,
                                barrier_every=4)
        th.join(120)
        assert not th.is_alive() and rt.wait(60)
        d, lg = rt.dispatcher, rt.ledger
        per_task = sorted((t.tid, t.executor, t.cache_hits, t.peer_hits,
                           t.cache_misses) for t in d.completed)
        agg = (len(d.completed), lg.local_hits, lg.peer_hits,
               lg.store_reads, lg.bytes_local, lg.bytes_c2c, lg.bytes_store)
        return agg, per_task
    finally:
        rt.shutdown()


def test_trace_replay_parity_single_process_vs_fleet(tmp_path):
    """A recorded k-input Zipf trace replayed batch-synchronously on the
    port's in-process runtime, the port's 2-host fleet and the reference's
    2-host fleet: every scheduling-determined quantity (placement
    included) agrees exactly."""
    trace = _zipf_trace(tmp_path, "par", 150, seed=7)
    base = _replay_run(DiffusionRuntime(n_executors=4,
                                        cache_capacity_bytes=10**12, seed=3,
                                        **CPU), replay(trace))
    fleet = _replay_run(FleetRuntime(hosts=2, threads_per_host=2,
                                     cache_capacity_bytes=10**12, seed=3,
                                     **CPU), replay(trace))
    ref = _replay_run(JaxFleetRuntime(hosts=2, threads_per_host=2,
                                      cache_capacity_bytes=10**12, seed=3),
                      jax_replay(trace))
    assert fleet == base
    assert fleet == ref          # identical placement, task by task
    assert fleet[0][2] > 0       # peers served some inputs


def _fleet_spec(pkg, hosts, tph, n_nodes):
    return pkg.ExperimentSpec(
        name="fleet-spec",
        cluster=pkg.ClusterSpec(testbed="anl_uc", n_nodes=n_nodes),
        cache=pkg.CacheSpec(capacity_bytes=10**11),
        policy="max-compute-util",
        workload=pkg.WorkloadSpec(
            name="fs",
            arrivals={"kind": "PoissonArrivals", "rate_per_s": 100.0},
            popularity={"kind": "ZipfPopularity", "alpha": 1.1, "k": 1,
                        "corr": 1.0},
            n_tasks=80, n_objects=24, object_bytes=10**5, seed=5),
        seed=2, hosts=hosts, threads_per_host=tph)


class _Port:
    ExperimentSpec, ClusterSpec, CacheSpec, WorkloadSpec = (
        ExperimentSpec, ClusterSpec, CacheSpec, WorkloadSpec)


def test_engine_fleet_report_parity_and_rejections():
    spec = lambda h, t, n: _fleet_spec(_Port, h, t, n)  # noqa: E731
    r1 = run_experiment(spec(0, 1, 4), engine=RuntimeEngine(**CPU),
                        barrier_every=4, timeout=120.0)
    r2 = run_experiment(spec(2, 2, 4), engine=RuntimeEngine(**CPU),
                        barrier_every=4, timeout=180.0)
    assert reports_scheduling_equal(r1, r2) == {}
    assert r2.n_completed == 80
    # the reference's fleet report agrees on every scheduling field
    jr = jax_exp.run_experiment(_fleet_spec(jax_exp, 2, 2, 4),
                                engine="runtime", barrier_every=4,
                                timeout=180.0)
    assert reports_scheduling_equal(r2, jr) == {}

    with pytest.raises(ValueError, match="sim engine does not support"):
        run_experiment(spec(2, 2, 4), engine="sim")
    with pytest.raises(ValueError, match="layout mismatch"):
        spec(2, 2, 5)
    with pytest.raises(ValueError, match="threads_per_host"):
        spec(0, 2, 4)
    eng = RuntimeEngine(**CPU).prepare(spec(2, 2, 4))
    try:
        assert isinstance(eng.runtime, FleetRuntime)
        with pytest.raises(ValueError, match="task callable"):
            eng.run(task_fn=lambda payloads: None)
    finally:
        eng.shutdown()


def test_engine_fleet_mode_defaults_to_cuda():
    """Without ``device`` the engine's fleet asks for the card: where there
    is none it raises at construction, before any host is spawned (the
    bare ``FleetRuntime`` case is in tests/test_torch_kernels_cuda.py)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError, match="cuda"):
        RuntimeEngine().prepare(_fleet_spec(_Port, 1, 2, 2))


# --------------------------------------------------------------------------
# the paper's task inside the hosts
# --------------------------------------------------------------------------

def test_stacking_on_a_fleet_matches_the_in_process_port(tmp_path):
    """SDSS stacking (``astro.stack_object``) on a 2 x 2 fleet, replayed
    batch-synchronously: the same placements as the in-process port, and
    every task's coadd -- read from the cache of the executor that ran it,
    through its host's peer server -- equal to the in-process result."""
    base = dataclasses.replace(
        astro.flat_spec(objects=24, locality=3, hosts=4),
        workload=dataclasses.replace(
            astro.flat_spec(24, 3, 4).workload,
            output_bytes=astro.H * astro.W * 4))
    fleet_spec = dataclasses.replace(base, hosts=2, threads_per_host=2)

    eng = RuntimeEngine(**CPU).prepare(base)
    try:
        r1 = eng.run(task_fn=astro.stack_object,
                     payload_factory=astro.make_tiles, barrier_every=4,
                     timeout=120.0)
        want = {t.tid: (t.executor, t.result)
                for t in eng.runtime.dispatcher.completed}
    finally:
        eng.shutdown()

    eng = RuntimeEngine(task_fn_name="repro_torch.apps.astro:stack_object",
                        **CPU).prepare(fleet_spec)
    client = None
    try:
        r2 = eng.run(payload_factory=astro.make_tiles, barrier_every=4,
                     timeout=180.0)
        rt = eng.runtime
        assert reports_scheduling_equal(r1, r2) == {}
        assert r2.n_completed == 24 and r2.n_failed == 0
        client = PeerClient(rt.manager.codec)
        for t in rt.dispatcher.completed:
            eid, result = want[t.tid]
            assert t.executor == eid and t.result is None   # stays host-side
            host = rt.workers[eid].host
            got = client.fetch((host.peer_host, host.peer_port), eid,
                               f"{t.tid}.out")
            assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
            assert torch.equal(got, result), t.tid
        # a miss is None, never an error
        assert client.fetch((host.peer_host, host.peer_port), eid,
                            "nope") is None
    finally:
        if client is not None:
            client.close()
        eng.shutdown()


PROBE = '''
import sys

import torch


def probe(inputs):
    """1 for every jax or repro module this process holds, and its device
    inputs' count (a host's task fn, written out by the test)."""
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "repro" or m.startswith("repro.")]
    return torch.tensor([len(bad), len(inputs)], dtype=torch.int64)
'''


def test_spawned_host_holds_no_jax(tmp_path, monkeypatch):
    """A host process imports the port only: a task fn run inside it finds
    no ``jax`` and no ``repro`` module in its interpreter (the test process
    itself holds both)."""
    (tmp_path / "fleet_jax_probe.py").write_text(PROBE)
    monkeypatch.syspath_prepend(str(tmp_path))   # spawn passes sys.path on
    rt = FleetRuntime(hosts=1, threads_per_host=1,
                      task_fn_name="fleet_jax_probe:probe", **CPU)
    client = PeerClient(rt.manager.codec)
    try:
        _put_all(rt, n_objects=1)
        rt.submit([Task(inputs=("o0",), tid="probe",
                        outputs=(DataObject("probe.out", 16),))])
        assert rt.wait(60) and len(rt.dispatcher.completed) == 1
        host = rt.manager.live_handles()[0]
        got = client.fetch((host.peer_host, host.peer_port),
                           host.eids[0], "probe.out")
        assert got.tolist() == [0, 1]
    finally:
        client.close()
        rt.shutdown()


class _NoRuntime:
    """HostManager's runtime stand-in: nothing reaches it before a hello."""
    _lock = None


def test_host_without_its_device_fails_its_spawn():
    """A host asked for a device it cannot get exits before it connects,
    and the manager raises at once with the exit code -- no host ever runs
    on another device than the central's."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: a cuda host would start")
    mgr = HostManager(_NoRuntime(), spawn_timeout_s=60.0, device="cuda")
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="exited with code"):
            mgr.spawn_host()
        assert time.monotonic() - t0 < 30.0
        assert mgr.live_handles() == []
    finally:
        mgr.shutdown()


def test_spec_from_json_takes_a_fleet_spec(tmp_path):
    """A reference fleet spec at values other than the defaults loads as the
    port's spec, field for field."""
    jspec = dataclasses.replace(_fleet_spec(jax_exp, 2, 3, 6), wire_batch=8,
                                local_dispatch=True)
    path = tmp_path / "fleet.json"
    jspec.save(path)
    got = convert.spec_from_json(path)
    assert (got.hosts, got.threads_per_host, got.wire_batch,
            got.local_dispatch) == (2, 3, 8, True)
    assert got.to_dict() == jspec.to_dict()
    assert got == _fleet_spec(_Port, 2, 3, 6).__class__.from_dict(
        jspec.to_dict())
