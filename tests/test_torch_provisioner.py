"""The port's dynamic resource provisioner (Falkon §3.1) against the JAX
package's: the same observations must give the same actions, counters and
snapshot, exactly, for every allocation policy and allocation quantum."""
import numpy as np
import pytest

from repro.core import provisioner as jax_prov
from repro_torch.core import provisioner as pt_prov

POLICIES = ["one-at-a-time", "additive", "exponential", "all-at-once"]


def _observations(seed: int, n: int = 200):
    """A seeded sequence of (now, queue_len, live, inflight, idle) that
    passes through deep queues, drained queues and idle pools."""
    rng = np.random.default_rng(seed)
    now = 0.0
    out = []
    for _ in range(n):
        now += float(rng.choice([0.25, 0.5, 1.0, 2.0, 5.0]))
        queue = int(rng.choice([0, 0, 1, 2, 5, 40, 300]))
        live = int(rng.integers(0, 70))
        inflight = int(rng.integers(0, 6))
        idle = [f"e{i}" for i in sorted(rng.choice(
            max(live, 1), size=int(rng.integers(0, max(live, 1) + 1)),
            replace=False))]
        out.append((now, queue, live, inflight, idle))
    return out


def _drive(mod, policy: str, quantum: int, seed: int):
    p = mod.DynamicResourceProvisioner(
        min_executors=2, max_executors=64,
        policy=mod.AllocationPolicy(policy), additive_k=5,
        queue_threshold=2, idle_timeout_s=4.0, trigger_cooldown_s=1.0,
        allocate_quantum=quantum)
    trace = []
    for now, queue, live, inflight, idle in _observations(seed):
        acts = p.step(now, queue, live, inflight, idle)
        trace.append((acts.allocate, list(acts.release), p.n_allocated,
                      p.n_released, p._exp_burst, p._last_trigger))
    return trace, p.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("quantum", [1, 4])
@pytest.mark.parametrize("policy", POLICIES)
def test_step_and_snapshot_match_reference(policy, quantum, seed):
    want = _drive(jax_prov, policy, quantum, seed)
    got = _drive(pt_prov, policy, quantum, seed)
    assert got == want
    trace, snap = got
    assert snap["n_allocated"] > 0 and snap["n_released"] > 0
    assert all(a % quantum == 0 for a, *_ in trace)


def test_rejects_a_quantum_below_one():
    with pytest.raises(ValueError, match="allocate_quantum"):
        pt_prov.DynamicResourceProvisioner(allocate_quantum=0)


# --------------------------------------------------------------------------
# the reference's policy cases (tests/test_provisioner.py), each run on both
# packages: the port must give the reference's actions and pass its checks
# --------------------------------------------------------------------------

def _prov(mod, policy, **kw):
    kw.setdefault("min_executors", 0)
    kw.setdefault("max_executors", 16)
    kw.setdefault("queue_threshold", 1)
    kw.setdefault("idle_timeout_s", 10.0)
    kw.setdefault("trigger_cooldown_s", 1.0)
    return mod.DynamicResourceProvisioner(
        policy=mod.AllocationPolicy(policy), **kw)


def _step(p, now, queue, live, inflight=0, idle=()):
    acts = p.step(now=now, queue_len=queue, live_executors=live,
                  inflight_allocations=inflight, idle_executors=list(idle))
    return acts.allocate, list(acts.release)


def case_one_at_a_time(mod):
    p = _prov(mod, "one-at-a-time")
    got = [_step(p, float(i * 2), 5, i) for i in range(3)]
    assert [a for a, _ in got] == [1, 1, 1] and p.n_allocated == 3
    return got


def case_additive(mod):
    p = _prov(mod, "additive", additive_k=4)
    got = [_step(p, 0.0, 9, 0), _step(p, 5.0, 9, 4)]
    assert [a for a, _ in got] == [4, 4]
    return got


def case_exponential_doubles(mod):
    p = _prov(mod, "exponential", max_executors=64)
    got, live = [], 0
    for i in range(4):
        a, r = _step(p, float(i * 2), 99, live)
        got.append((a, r))
        live += a
    assert [a for a, _ in got] == [1, 2, 4, 8]
    return got


def case_exponential_resets(mod):
    p = _prov(mod, "exponential", max_executors=64)
    got = [_step(p, 0.0, 9, 0), _step(p, 2.0, 9, 1)]
    assert p._exp_burst == 4
    got.append(_step(p, 4.0, 0, 3))
    got.append(_step(p, 6.0, 9, 3))
    assert got[-1][0] == 1
    return got


def case_all_at_once(mod):
    p = _prov(mod, "all-at-once", max_executors=16)
    got = [_step(p, 0.0, 1, 3, inflight=1)]
    assert got[0][0] == 12
    return got


def _case_never_exceeds(policy):
    def case(mod):
        p = _prov(mod, policy, max_executors=8, additive_k=100)
        got = [_step(p, 0.0, 1000, 6, inflight=1),
               _step(p, 5.0, 1000, 8)]
        assert got[0][0] <= 1 and got[1][0] == 0
        return got
    return case


def case_below_threshold(mod):
    p = _prov(mod, "all-at-once", queue_threshold=4)
    got = [_step(p, 0.0, 3, 0)]
    assert got[0][0] == 0 and p.n_allocated == 0
    return got


def case_cooldown(mod):
    p = _prov(mod, "one-at-a-time", trigger_cooldown_s=5.0)
    got = [_step(p, 0.0, 9, 0), _step(p, 2.0, 9, 0, inflight=1),
           _step(p, 5.0, 9, 1)]
    assert [a for a, _ in got] == [1, 0, 1]
    return got


def case_idle_release_to_min(mod):
    p = _prov(mod, "all-at-once", min_executors=2)
    got = [_step(p, 100.0, 0, 5, idle=["e0", "e1", "e2", "e3", "e4"])]
    assert got[0][1] == ["e0", "e1", "e2"] and p.n_released == 3
    return got


def case_no_release_while_queued(mod):
    p = _prov(mod, "all-at-once", min_executors=0)
    got = [_step(p, 100.0, 1, 4, idle=["e0", "e1"])]
    assert got[0][1] == []
    return got


def case_release_limited_to_idle(mod):
    p = _prov(mod, "all-at-once", min_executors=0)
    got = [_step(p, 100.0, 0, 8, idle=["e5"])]
    assert got[0][1] == ["e5"]
    return got


REFERENCE_CASES = {
    "one_at_a_time_allocates_single_executor_per_trigger": case_one_at_a_time,
    "additive_allocates_k_per_trigger": case_additive,
    "exponential_doubles_per_consecutive_trigger": case_exponential_doubles,
    "exponential_burst_resets_when_queue_drains": case_exponential_resets,
    "all_at_once_jumps_to_max": case_all_at_once,
    **{f"never_exceeds_max_executors[{p}]": _case_never_exceeds(p)
       for p in POLICIES},
    "below_threshold_queue_never_triggers": case_below_threshold,
    "trigger_cooldown_suppresses_back_to_back_allocation": case_cooldown,
    "idle_timeout_release_down_to_min": case_idle_release_to_min,
    "no_release_while_queue_nonempty": case_no_release_while_queued,
    "release_limited_to_idle_set": case_release_limited_to_idle,
}


@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_reference_policy_case(case):
    fn = REFERENCE_CASES[case]
    assert fn(pt_prov) == fn(jax_prov)
