"""Serving over diffusion in the port against the JAX package's: the
session generator (requests, pages, arrival times, page sizes from a real
model's widths), the sessions spec binding, the router-vs-Dispatcher
regression lock, the serve engine's placements, kv_summary, report schema
and lifecycle events under batch-synchronous replay, the sim-twin
divergence, and ``apps/serve_sessions.py --device cpu`` printing what
``examples/serve_sessions.py`` prints -- all exactly the reference's."""
import contextlib
import dataclasses
import importlib.util
import io
import random
from pathlib import Path

import pytest
import torch

from repro import experiments as jax_exp
from repro import obs as jobs
from repro import workloads as jw
from repro.configs import get_config as jax_get_config
from repro.core.policies import DispatchPolicy as JaxPolicy
from repro.serve import PrefixAwareRouter as JaxRouter
from repro.serve import kv_bytes_per_token as jax_kv_bpt
from repro.serve import diffusion as jdiff
from repro_torch import obs as pobs
from repro_torch import workloads as pw
from repro_torch.apps import serve_sessions
from repro_torch.configs import get_config
from repro_torch.core.policies import DispatchPolicy
from repro_torch.experiments import (ExperimentSpec, ObserveSpec, WorkloadSpec,
                                     build_workload, engine_names,
                                     make_engine, run_experiment)
from repro_torch.serve import PrefixAwareRouter, kv_bytes_per_token
from repro_torch.serve import prefix_chain
from repro_torch.serve.diffusion import (SERVE_MAPPING, ServeDiffusionEngine,
                                         check_serve_spec, kv_summary,
                                         pool_trajectory, session_spec,
                                         verify_route)

ROOT = Path(__file__).resolve().parents[1]

FAST = {"kind": "chat", "n_sessions": 16, "turns_per_session": 3,
        "kv_bytes_per_token": 256, "block": 16,
        "think_time_s": 0.0, "turn_seconds": 0.0,
        "arrivals": {"kind": "BatchArrivals", "at_s": 0.0}}


def _jax(spec: ExperimentSpec):
    return jax_exp.ExperimentSpec.from_dict(spec.to_dict())


def _fp(wl) -> tuple:
    return (wl.name, wl.spec,
            tuple((o.oid, o.size_bytes) for o in wl.objects),
            tuple((e.t, e.tid, tuple(e.inputs), e.compute_seconds)
                  for e in wl.events))


# --------------------------------------------------------------------------
# the session generator
# --------------------------------------------------------------------------

SESSION_CASES = {
    "default": {},
    "fast": {k: v for k, v in FAST.items() if k != "kind"},
    "one-prompt": {"n_sessions": 8, "n_system_prompts": 1,
                   "system_prompt_blocks": 3, "seed": 2},
    "skewed": {"n_sessions": 30, "zipf_s": 2.0, "turns_per_session": 4,
               "turn_blocks": 1, "seed": 9},
    "poisson": {"n_sessions": 20, "think_time_s": 1.5,
                "arrivals": {"kind": "PoissonArrivals", "rate_per_s": 2.0},
                "seed": 5},
    "h2o-danube-3-4b": {"n_sessions": 6, "turns_per_session": 4,
                        "model": "h2o-danube-3-4b", "block": 64},
    "whisper-base": {"n_sessions": 3, "model": "whisper-base", "block": 32},
}


@pytest.mark.parametrize("name", sorted(SESSION_CASES))
def test_sessions_equal_the_reference(name):
    kw = SESSION_CASES[name]
    got = pw.SessionModel(**kw)
    want = jw.SessionModel(**kw)
    assert got.page_bytes == want.page_bytes
    assert got.spec() == want.spec()
    assert _fp(got.generate()) == _fp(want.generate())
    assert _fp(pw.build_sessions(got.spec())) == _fp(got.generate())


def test_page_size_from_published_widths():
    """h2o-danube-3-4b: 24 layers x 2 (k, v) x 8 kv heads x 120 x 2 bytes
    a token, a page of 64 tokens."""
    for arch in ("h2o-danube-3-4b", "whisper-base", "falcon-mamba-7b"):
        assert kv_bytes_per_token(get_config(arch)) \
            == jax_kv_bpt(jax_get_config(arch))
    assert kv_bytes_per_token(get_config("h2o-danube-3-4b")) == 92_160
    m = pw.SessionModel(model="h2o-danube-3-4b", block=64)
    assert m.page_bytes == 5_898_240


def test_prefix_chain_monotone_across_turns():
    wl = pw.SessionModel(n_sessions=10, turns_per_session=4,
                         seed=1).generate()
    turns: dict[int, dict[int, tuple]] = {}
    for e in wl.events:
        sid, j = e.tid.rsplit("-s", 1)[1].split(".t")
        turns.setdefault(int(sid), {})[int(j)] = e.inputs
    assert len(turns) == 10
    for per_session in turns.values():
        assert sorted(per_session) == [1, 2, 3, 4]
        for j in range(2, 5):
            prev, cur = per_session[j - 1], per_session[j]
            assert len(cur) > len(prev) and cur[:len(prev)] == prev


@pytest.mark.parametrize("bad", [
    {"n_sessions": 0}, {"turns_per_session": 0}, {"n_system_prompts": 0},
    {"turn_blocks": 0}, {"block": 0}, {"zipf_s": -1.0},
    {"arrivals": {"kind": "NotAProcess"}},
])
def test_bad_session_models_refused_like_the_reference(bad):
    with pytest.raises(ValueError) as want:
        jw.SessionModel(**bad)
    with pytest.raises(ValueError) as got:
        pw.SessionModel(**bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown sessions kind"):
        pw.build_sessions({"kind": "nope"})
    assert pw.SESSIONS.keys() == jw.SESSIONS.keys() == {"chat"}


# --------------------------------------------------------------------------
# the spec binding
# --------------------------------------------------------------------------

def test_build_workload_routes_sessions():
    ws = WorkloadSpec(name="s", sessions=dict(FAST))
    wl = build_workload(ws)
    assert len(wl) == FAST["n_sessions"] * FAST["turns_per_session"]
    assert wl.name == "s"
    assert _fp(wl) == _fp(jax_exp.build_workload(
        jax_exp.WorkloadSpec(name="s", sessions=dict(FAST))))


def test_session_spec_equals_the_reference_and_round_trips():
    spec = session_spec("rt", FAST, n_replicas=3, seed=4,
                        replica_cache_bytes=1 << 20,
                        observe=ObserveSpec(events=True))
    assert ExperimentSpec.from_dict(spec.to_dict()) == spec
    want = jdiff.session_spec("rt", FAST, n_replicas=3, seed=4,
                              replica_cache_bytes=1 << 20,
                              observe=jax_exp.ObserveSpec(events=True))
    d = want.to_dict()
    for k in ("hosts", "threads_per_host", "wire_batch", "local_dispatch"):
        d.pop(k)
    assert spec.to_dict() == d


def test_serve_mapping_is_the_references_in_this_package():
    assert len(SERVE_MAPPING) == len(jdiff.SERVE_MAPPING)
    for got, want in zip(SERVE_MAPPING, jdiff.SERVE_MAPPING):
        assert got[:2] == want[:2]
        assert got[2] == want[2].replace("repro.", "repro_torch.", 1)


# --------------------------------------------------------------------------
# router vs core regression lock
# --------------------------------------------------------------------------

POLICIES = ["max-compute-util", "max-cache-hit", "first-available",
            "first-cache-available"]


def _drive_verified(policy: str, n_prompts=48, seed=0):
    """Route one prompt stream through the port's router (verified against
    its Dispatcher twin) and the reference's, in lockstep."""
    rng = random.Random(seed)
    r = PrefixAwareRouter(4, policy=DispatchPolicy(policy),
                          kv_bytes_per_token=64, block=16,
                          slots_per_replica=2)
    jr = JaxRouter(4, policy=JaxPolicy(policy), kv_bytes_per_token=64,
                   block=16, slots_per_replica=2)
    bases = [[rng.randrange(999) for _ in range(64)] for _ in range(4)]
    inflight, out = [], []
    for _ in range(n_prompts):
        p = bases[rng.randrange(4)] + [rng.randrange(999)
                                       for _ in range(16 * rng.randrange(3))]
        v = verify_route(r, p)
        jv = jdiff.verify_route(jr, p)
        out.append((v, jv))
        inflight.append((p, v["route_result"], jv["route_result"]))
        if len(inflight) > 4:
            pp, rr, jrr = inflight.pop(0)
            r.complete(pp, rr)
            jr.complete(pp, jrr)
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_placement_and_scores_match_dispatcher_and_reference(policy):
    for v, jv in _drive_verified(policy):
        assert v["scores_agree"] and v["placement_agrees"], v
        assert v["prediction"]["incremental_consistent"]
        assert v["prediction"] == jv["prediction"]
        assert v["routed"] == jv["routed"]
        assert v["route_result"].reused_prefix_tokens \
            == jv["route_result"].reused_prefix_tokens


def test_page_sizing_not_cumulative():
    r = PrefixAwareRouter(2, kv_bytes_per_token=64, block=16)
    prompt = list(range(64))          # 4 pages
    res = r.route(prompt)
    r.complete(prompt, res)
    assert r.reference_scores(prompt)[res.replica] == 4 * r.page_bytes
    assert all(r.sizes[oid] == r.page_bytes
               for oid in prefix_chain(prompt, r.block))


# --------------------------------------------------------------------------
# the serve engine against the reference's, batch-synchronous
# --------------------------------------------------------------------------

SCHED_FIELDS = ("n_tasks", "n_completed", "n_failed", "local_hits",
                "peer_hits", "store_reads", "local_hit_ratio",
                "cache_hit_ratio", "full_hit_tasks", "partial_hit_tasks",
                "zero_hit_tasks", "bytes_by_kind", "mean_inputs_per_task",
                "peak_executors", "low_executors", "n_allocated",
                "n_released")

SERVE_CASES = {
    "fast-4": (FAST, 4, "max-compute-util", 1 << 30),
    "fast-3-small-caches": (FAST, 3, "max-compute-util", 40_000),
    "fast-cache-hit": (FAST, 4, "max-cache-hit", 1 << 30),
    "fast-first-available": (FAST, 2, "first-available", 1 << 30),
    "h2o-pages": ({"kind": "chat", "n_sessions": 12, "turns_per_session": 4,
                   "n_system_prompts": 4, "block": 64,
                   "model": "h2o-danube-3-4b", "think_time_s": 0.0,
                   "turn_seconds": 0.0,
                   "arrivals": {"kind": "BatchArrivals", "at_s": 0.0}},
                  4, "max-compute-util", 20 * 5_898_240),
}


def _serve(pkg_diff, spec, **run):
    if pkg_diff is jdiff:
        eng = jdiff.ServeDiffusionEngine()
    else:
        eng = ServeDiffusionEngine(device="cpu")
    try:
        eng.prepare(spec)
        rep = eng.run(barrier_every=1, timeout=120.0, **run)
        placements = {t.tid: t.executor
                      for t in eng.runtime.dispatcher.completed}
        events = eng.recorder.events() if eng.recorder is not None else None
        return rep, placements, events
    finally:
        eng.shutdown()


@pytest.mark.parametrize("name", sorted(SERVE_CASES))
def test_serve_engine_equals_the_reference(name):
    binding, replicas, policy, cache = SERVE_CASES[name]
    spec = session_spec(name, binding, n_replicas=replicas, policy=policy,
                        replica_cache_bytes=cache, seed=1,
                        observe=ObserveSpec(events=True))
    rep, placements, events = _serve(None, spec)
    jrep, jplacements, jevents = _serve(jdiff, _jax(spec))
    assert rep.engine == "serve" and rep.n_failed == 0
    assert rep.n_completed == len(build_workload(spec.workload))
    assert kv_summary(rep) == jdiff.kv_summary(jrep)
    assert placements == jplacements
    assert rep.schema() == jrep.schema()
    for f in SCHED_FIELDS:
        assert getattr(rep, f) == getattr(jrep, f), f
    assert pobs.lifecycle_fingerprints(events) \
        == jobs.lifecycle_fingerprints(jevents)
    assert {"task_arrived", "task_dispatched", "task_done", "exec_start",
            "exec_end", "input"} <= {e["kind"] for e in events}
    s = kv_summary(rep)
    assert s["reused_kv_bytes"] > 0 and 0.0 < s["reused_token_fraction"] < 1
    assert s["n_requests"] == rep.n_completed


def test_stamped_page_tensors_change_nothing():
    """Pages as real ``uint8`` tensors stamped with their index, read by a
    task fn that checks every input, give the shape-only run's kv_summary
    and placements (the card test does the same on cuda)."""
    binding, replicas, policy, cache = SERVE_CASES["fast-3-small-caches"]
    spec = session_spec("stamped", binding, n_replicas=replicas,
                        policy=policy, replica_cache_bytes=cache, seed=1)
    wl = build_workload(spec.workload)
    index = {ob.oid: i for i, ob in enumerate(wl.objects)}
    page = wl.objects[0].size_bytes

    def make_page(ob):
        t = torch.full((ob.size_bytes,), 7, dtype=torch.uint8)
        t[:16] = torch.tensor(list(index[ob.oid].to_bytes(16, "little")),
                              dtype=torch.uint8)
        return t

    checked = []

    def check(inputs):
        for oid, t in inputs.items():
            assert t.device.type == "cpu" and t.numel() == page
            assert int.from_bytes(bytes(t[:16].tolist()), "little") \
                == index[oid]
        checked.append(len(inputs))

    rep, placements, _ = _serve(None, spec, task_fn=check,
                                payload_factory=make_page)
    shape_rep, shape_placements, _ = _serve(None, spec)
    assert kv_summary(rep) == kv_summary(shape_rep)
    assert placements == shape_placements
    assert len(checked) == rep.n_completed == len(wl)
    assert rep.bytes_by_kind["store_read"] > 0


def test_serve_engine_registered_lazily_and_refuses():
    assert "serve" in engine_names()
    assert isinstance(make_engine("serve"), ServeDiffusionEngine)
    dag = ExperimentSpec(name="rej-dag", workload=WorkloadSpec(
        dag={"kind": "all_pairs", "n_objects": 2}))
    with pytest.raises(ValueError) as got:
        check_serve_spec(dag)
    with pytest.raises(ValueError) as want:
        jdiff.check_serve_spec(_jax(dag))
    assert str(got.value) == str(want.value)
    spec = dataclasses.replace(session_spec("rej2", FAST),
                               flow_solver="naive")
    with pytest.raises(ValueError, match="does not support"):
        ServeDiffusionEngine(device="cpu").prepare(spec)


def test_serve_engine_raises_without_a_card_when_asked_for_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_engine("serve").prepare(session_spec("c", FAST))
    with pytest.raises(RuntimeError, match="cuda"):
        serve_sessions.main(["--sessions", "2"])


def test_sim_engine_runs_sessions_binding_like_the_reference():
    spec = session_spec("simside", FAST)
    rep = run_experiment(spec, engine="sim")
    want = jax_exp.run_experiment(_jax(spec), engine="sim")
    assert rep.diff(want, ignore=("spec_sha", "wall_s")) == {}
    assert kv_summary(rep)["reused_kv_bytes"] > 0
    assert pool_trajectory(rep) == jdiff.pool_trajectory(want)


# --------------------------------------------------------------------------
# sim twin: divergence on the serve path
# --------------------------------------------------------------------------

def _serial_sessions(pkg, n_sessions=10, turns=2):
    binding = {"kind": "chat", "n_sessions": n_sessions,
               "turns_per_session": turns, "kv_bytes_per_token": 256,
               "block": 16, "turn_seconds": 0.001,
               "arrivals": {"kind": "PoissonArrivals", "rate_per_s": 2.0}}
    wl = pkg.build_sessions(binding, name="twin")
    events = [dataclasses.replace(e, t=float(i))
              for i, e in enumerate(wl.events)]
    return binding, pkg.Workload("twin", wl.objects, events, spec=None)


def test_serial_replay_divergence(tmp_path):
    binding, serial = _serial_sessions(pw)
    spec = session_spec("twin", binding, n_replicas=4, seed=2,
                        observe=ObserveSpec(events=True))
    eng = ServeDiffusionEngine(device="cpu")
    try:
        eng.prepare(spec, workload=serial)
        rep = eng.run(barrier_every=1, timeout=120)
        outcomes = eng.last_outcomes
    finally:
        eng.shutdown()
    assert rep.n_completed == len(serial)
    p = tmp_path / "twin.jsonl"
    pw.record_v3(serial, p, outcomes)
    predicted = pobs.sim_replay_outcomes(pobs.sim_twin_spec(spec, str(p)),
                                         str(p))
    assert predicted == jobs.sim_replay_outcomes(
        jobs.sim_twin_spec(_jax(spec), str(p)), str(p))
    div = pobs.diff_outcomes(outcomes, predicted)
    assert div["placement_agreement"] >= 0.99
    assert div["n_matched"] == len(serial)


# --------------------------------------------------------------------------
# the app
# --------------------------------------------------------------------------

def _stdout(fn, *args) -> tuple[list[str], object]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return buf.getvalue().splitlines(), rc


@pytest.mark.parametrize("argv", [[], ["--sessions", "24", "--turns", "4",
                                       "--days", "1"]],
                         ids=["defaults", "small"])
def test_serve_sessions_app_prints_the_reference_lines(argv):
    spec = importlib.util.spec_from_file_location(
        "serve_sessions_example", ROOT / "examples" / "serve_sessions.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    want, want_rc = _stdout(ref.main, argv)
    got, rc = _stdout(serve_sessions.main, argv + ["--device", "cpu"])
    assert got == want and rc == want_rc == 0
    assert got[0].startswith("serve: 4 replicas")
