"""The port's discrete-event simulator against the JAX package's: the same
spec, workload and seed must give the same RunReport (every field but the
spec hash and the host wall clock), the same pool log, flow log and per-task
placement, exactly -- the simulator is float arithmetic in event order, so
any reordered tie-break or RNG draw shows up as a difference."""
import dataclasses

import pytest

from repro.core import transport as jax_transport
from repro.core.objects import make_objects as jax_make_objects
from repro.core.objects import uniform_tasks as jax_uniform_tasks
from repro.core.policies import DispatchPolicy as JaxPolicy
from repro.core.simulator import DiffusionSim as JaxSim
from repro.core.simulator import SimConfig as JaxSimConfig
from repro.core.testbeds import ANL_UC as JAX_ANL_UC
from repro.experiments import ExperimentSpec as JaxExperimentSpec
from repro.experiments import SimEngine as JaxSimEngine
from repro_torch.core import transport as pt_transport
from repro_torch.core.objects import make_objects as pt_make_objects
from repro_torch.core.objects import uniform_tasks as pt_uniform_tasks
from repro_torch.core.policies import DispatchPolicy as PtPolicy
from repro_torch.core.simulator import DiffusionSim as PtSim
from repro_torch.core.simulator import SimConfig as PtSimConfig
from repro_torch.core.testbeds import ANL_UC as PT_ANL_UC
from repro_torch.experiments import (CacheSpec, ClusterSpec, ExperimentSpec,
                                     ProvisionerSpec, SimEngine, WorkloadSpec)

MB = 10**6
DISPATCH = ["first-available", "first-cache-available", "max-cache-hit",
            "max-compute-util"]
ALLOCATION = ["one-at-a-time", "additive", "exponential", "all-at-once"]

ZIPF = WorkloadSpec(
    name="zipf",
    arrivals={"kind": "PoissonArrivals", "rate_per_s": 40.0},
    popularity={"kind": "ZipfPopularity", "alpha": 1.1, "k": 1, "corr": 1.0},
    n_tasks=300, n_objects=40, object_bytes=20 * MB, object_prefix="f",
    compute_seconds=0.1, output_bytes=MB, seed=3)
SINE = WorkloadSpec(
    name="sine",
    arrivals={"kind": "SineWaveArrivals", "mean_rate": 8.0,
              "amplitude": 7.5, "period_s": 30.0, "phase": 0.0},
    popularity={"kind": "ZipfPopularity", "alpha": 1.1, "k": 1, "corr": 1.0},
    n_tasks=300, n_objects=40, object_bytes=20 * MB, object_prefix="f",
    compute_seconds=0.5, seed=1)
ELASTIC = ExperimentSpec(
    name="elastic", workload=SINE,
    cluster=ClusterSpec(n_nodes=1),
    provisioner=ProvisionerSpec(
        policy="exponential", min_executors=1, max_executors=8,
        queue_threshold=2, idle_timeout_s=4.0, trigger_cooldown_s=1.0),
    seed=0)


def _jax_spec(spec: ExperimentSpec) -> JaxExperimentSpec:
    return JaxExperimentSpec.from_dict(spec.to_dict())


def _outcomes(eng):
    """Every completed task's placement and clocks (twins by position:
    their generated tids come from each package's own counter)."""
    return [(t.executor, t.start_time, t.end_time, t.cache_hits, t.peer_hits,
             t.cache_misses, t.attempts)
            for t in eng.result.dispatcher.completed]


def _both(spec: ExperimentSpec):
    jeng = JaxSimEngine().prepare(_jax_spec(spec))
    peng = SimEngine().prepare(spec)
    jrep, prep = jeng.run(), peng.run()
    assert prep.engine == "sim" and prep.schema() == jrep.schema()
    assert prep.diff(jrep, ignore=("spec_sha", "wall_s")) == {}
    assert prep.pool_log == jrep.pool_log
    assert peng.result.flow_log == jeng.result.flow_log
    assert _outcomes(peng) == _outcomes(jeng)
    assert peng.sim.loop.n_fired == jeng.sim.loop.n_fired
    return prep


@pytest.mark.parametrize("policy", DISPATCH)
def test_dispatch_policy_reports_match(policy):
    rep = _both(ExperimentSpec(name="d", workload=ZIPF, policy=policy,
                               cluster=ClusterSpec(n_nodes=6), seed=2))
    assert rep.n_completed == ZIPF.n_tasks


@pytest.mark.parametrize("allocation", ALLOCATION)
def test_provisioner_policy_reports_match(allocation):
    spec = dataclasses.replace(ELASTIC, provisioner=dataclasses.replace(
        ELASTIC.provisioner, policy=allocation, additive_k=3))
    rep = _both(spec)
    assert rep.n_allocated > 0 and rep.n_released > 0
    assert rep.peak_executors > rep.low_executors


@pytest.mark.parametrize("solver", ["incremental", "naive"])
def test_flow_solver_reports_match(solver):
    rep = _both(ExperimentSpec(name="f", workload=ZIPF, flow_solver=solver,
                               cluster=ClusterSpec(n_nodes=4), seed=0))
    assert rep.n_completed == ZIPF.n_tasks


def test_flow_solvers_agree_in_the_port():
    base = ExperimentSpec(name="f", workload=ZIPF,
                          cluster=ClusterSpec(n_nodes=4), seed=0)
    a = SimEngine().prepare(base).run()
    b = SimEngine().prepare(dataclasses.replace(base, flow_solver="naive")) \
        .run()
    assert a.diff(b, ignore=("spec_sha", "wall_s")) == {}


@pytest.mark.parametrize("release", ["discard", "rebalance"])
def test_release_policy_reports_match(release):
    rep = _both(dataclasses.replace(ELASTIC, release_policy=release))
    assert rep.n_released > 0
    if release == "rebalance":
        assert rep.bytes_by_kind.get("c2c", 0) > 0


@pytest.mark.parametrize("factor", [0.0, 0.6])
def test_speculation_reports_match(factor):
    spec = ExperimentSpec(name="s", workload=ZIPF, speculation_factor=factor,
                          policy="first-available",
                          cluster=ClusterSpec(n_nodes=4), seed=1)
    _both(spec)
    eng = SimEngine().prepare(spec)
    eng.run()
    twins = len(eng.sim.dispatcher.tasks) - ZIPF.n_tasks
    assert (twins > 0) == (factor > 0)


@pytest.mark.parametrize("where", ["local", "store", "none"])
def test_write_outputs_to_reports_match(where):
    rep = _both(ExperimentSpec(name="w", workload=ZIPF,
                               write_outputs_to=where,
                               cluster=ClusterSpec(n_nodes=4), seed=0))
    assert ("store_write" in rep.bytes_by_kind) == (where == "store")


@pytest.mark.parametrize("interval", [0.0, 0.5])
def test_loose_index_coherence_reports_match(interval):
    _both(ExperimentSpec(name="i", workload=ZIPF,
                         index_update_interval_s=interval,
                         cluster=ClusterSpec(n_nodes=4), seed=0))


@pytest.mark.parametrize("caching", [True, False])
def test_data_unaware_baseline_matches(caching):
    rep = _both(ExperimentSpec(
        name="c", workload=ZIPF, cluster=ClusterSpec(n_nodes=4, cpus_per_node=2),
        cache=CacheSpec(capacity_bytes=200 * MB, eviction="lfu",
                        enabled=caching), seed=0))
    assert (rep.cache_hit_ratio > 0) == caching


# --------------------------------------------------------------------------
# DiffusionSim driven directly: warm caches, a failed node, a straggler
# --------------------------------------------------------------------------

def _direct(Sim, SimConfig, Policy, testbed, make_objects, uniform_tasks,
            factor: float):
    cfg = SimConfig(testbed=testbed, n_nodes=4,
                    policy=Policy.MAX_COMPUTE_UTIL,
                    cache_capacity_bytes=10**12,
                    speculation_factor=factor,
                    executor_slowdown={"e3": 20.0}, fail_at={"e1": 2.0},
                    seed=5)
    sim = Sim(cfg)
    objs = make_objects("f", 24, 5 * MB)
    sim.add_objects(objs)
    sim.warm_caches(objs, replicas=2)
    sim.submit(uniform_tasks(objs, compute_seconds=0.7))
    r = sim.run()
    return (r.makespan, r.t_first_dispatch, r.t_last_complete,
            r.bytes_by_kind, r.n_completed, r.n_failed, r.local_hits,
            r.peer_hits, r.store_reads, r.flow_log, r.pool_log,
            r.read_throughput(), r.moved_throughput(), r.global_hit_ratio,
            sorted(sim.dispatcher.executors), sim.loop.n_scheduled,
            [(t.executor, t.end_time) for t in r.dispatcher.completed])


@pytest.mark.parametrize("factor", [0.0, 2.0])
def test_direct_sim_with_failure_and_straggler_matches(factor):
    want = _direct(JaxSim, JaxSimConfig, JaxPolicy, JAX_ANL_UC,
                   jax_make_objects, jax_uniform_tasks, factor)
    got = _direct(PtSim, PtSimConfig, PtPolicy, PT_ANL_UC, pt_make_objects,
                  pt_uniform_tasks, factor)
    assert got == want
    assert got[4] == 24 and "e1" not in got[14]


# --------------------------------------------------------------------------
# transport: the fluid-flow clock and the FIFO servers
# --------------------------------------------------------------------------

def _flows(mod, solver: str):
    loop = mod.EventLoop()
    net = mod.FlowNetwork(loop, solver=solver)
    a = mod.BandwidthResource("a", 100.0)
    b = mod.BandwidthResource("b", 40.0)
    done = []
    meta = mod.MetadataService(loop, 0.05)
    cpu = mod.FifoServer(loop, 0.01)
    for i, (size, res, cap) in enumerate([
            (300.0, (a,), None), (120.0, (a, b), None), (0.0, (b,), None),
            (500.0, (b,), 25.0), (80.0, (a, b), 10.0)]):
        loop.at(0.3 * i, lambda t, s=size, r=res, c=cap, i=i: net.start(
            s, r, lambda tt, i=i: done.append((i, tt)), kind=f"k{i % 2}",
            flow_cap=c))
    loop.at(1.0, lambda t: net.cancel(3))
    meta.submit(3, lambda t: done.append(("meta", t)))
    meta.submit(2, lambda t: done.append(("meta2", t)))
    cpu.submit(lambda t: done.append(("cpu", t)))
    cpu.submit(lambda t: done.append(("cpu2", t)), cost_s=0.2)
    end = loop.run()
    return (end, done, net.bytes_by_kind, net.flow_log, loop.n_fired,
            meta.n_ops, cpu.n_served)


@pytest.mark.parametrize("solver", ["incremental", "naive"])
def test_transport_matches_reference(solver):
    got = _flows(pt_transport, solver)
    assert got == _flows(jax_transport, solver)
    assert got[:4] == _flows(pt_transport, "incremental")[:4]


def test_unknown_flow_solver_is_refused():
    with pytest.raises(ValueError, match="solver"):
        pt_transport.FlowNetwork(pt_transport.EventLoop(), solver="maxmin")
