"""The readers of the program's request spans (``hostspans.py``) on
synthetic runs, the launch-to-kernel pairing with swapped neighbours and a
kernel launched before the profiler started, None where a run has nothing
to read (a program without the spans among them), and a recorded tiny run
on the CPU whose existing metrics read the same before and after the new
readers ran."""
from __future__ import annotations

import statistics

import pytest

from ddbench import devtrace, harness, hostspans, registry
from ddbench.conftest import seconds_of

SEED = 2**31 + 77
E = 1_800_000_000_000_000_000
#: the recorder's zero on the host's monotonic clock
BASE = 90.0


def _epoch(t: float) -> int:
    return E + round(t * 1e9)


def _run(device=None, done=("a", "b", "c"), late=("z",)):
    """A closed-loop run whose window is [100, 110] monotonic, i.e. [10, 20]
    on the recorder's clock; ``done`` complete in it, ``late`` after it."""
    done_at = {t: 100.0 + i for i, t in enumerate(done)}
    done_at.update({t: 111.0 for t in late})
    ledger = {t: {"start_time": 100.0} for t in done_at}
    return harness.Run(
        cell="stack.l10.saturate", cfg={}, mix={}, seed=1, seconds=10.0,
        trace=True, loop="closed", setup_s=1.0, t_open=100.0, t_close=110.0,
        due={t: 100.0 for t in done_at}, done_at=done_at, failed_at={},
        ledger=ledger, outputs={}, lock_hold_s=0.5, pool=[(0.0, 4)],
        spans=None, device=device)


def _recorded(spans, locks=None):
    return hostspans.Recorded(
        base=BASE, spans=spans, spans_dropped=0,
        anchors=[(0.0, E), (30.0, E + 30 * 10**9)], to_epoch_ns=_epoch,
        locks=locks)


def _device(ops, t0=BASE + 10.0, t1=BASE + 20.0):
    """Card operations given on the recorder's clock (s), stored as the
    profiler gives them: realtime seconds."""
    return devtrace.DeviceTrace(
        t0, t1, [(_epoch(s) * 1e-9, _epoch(e) * 1e-9, name)
                 for s, e, name in ops])


def test_store_copy_ms_mean_reads_the_copies_begun_in_the_window():
    spans = [{"kind": "store_copy", "t": 9.9, "dur": 0.5},
             {"kind": "store_copy", "t": 10.5, "dur": 0.001},
             {"kind": "store_copy", "t": 19.0, "dur": 0.003},
             {"kind": "store_copy", "t": 20.5, "dur": 0.9},
             {"kind": "fn", "t": 11.0, "dur": 0.2, "cpu": 0.0, "tid": "a"}]
    got = hostspans.store_copy_ms_mean(_run(), _recorded(spans))
    assert got == pytest.approx(2.0)


def test_lock_wait_ms_per_task_is_the_windows_wait_per_completion():
    rec = _recorded([], locks={"lock_wait_s": 0.03, "lock_hold_s": 0.2})
    assert hostspans.lock_wait_ms_per_task(_run(), rec) == pytest.approx(10.0)
    assert hostspans.lock_wait_ms_per_task(_run(done=()), rec) is None


def test_fn_cpu_ms_mean_reads_the_windows_requests():
    spans = [{"kind": "fn", "t": 10.1, "dur": 0.1, "cpu": 0.002, "tid": "a"},
             {"kind": "fn", "t": 10.2, "dur": 0.1, "cpu": 0.004, "tid": "b"},
             {"kind": "fn", "t": 20.2, "dur": 0.1, "cpu": 0.5, "tid": "z"},
             {"kind": "launch", "t": 10.2, "dur": 0.0, "tid": "b",
              "kernel": "stack_rois"}]
    assert hostspans.fn_cpu_ms_mean(_run(), _recorded(spans)) \
        == pytest.approx(3.0)


def _launch(t):
    return {"kind": "launch", "t": t, "dur": 1e-5, "kernel": "stack_rois",
            "parent": "fn", "tid": "x"}


def test_coadd_queue_pairs_the_kth_kernel_with_the_kth_launch():
    # launches at 9.99 (before the profiled span: left out), 12, 12.000001,
    # 15, 18 and 25 (after the span); the two launches a microsecond apart
    # reached the card in the other order (kernel 12.0001 is the second's,
    # 12.0003 the first's): pairing by order swaps them, +d and -d, and the
    # mean stays
    launches = [9.99, 12.0, 12.000001, 15.0, 18.0, 25.0]
    kernels = [12.0001, 12.0003, 15.002, 18.0005]
    dev = _device([(k, k + 1e-5, "void stack_rois_kernel<8>(...)")
                   for k in kernels]
                  + [(11.0, 11.0009, "Memcpy HtoD (Pageable -> Device)")])
    rec = _recorded([_launch(t) for t in launches])
    run = _run(device=dev)
    got = hostspans.coadd_queue_ms_mean(run, rec)
    true = [12.0003 - 12.0, 12.0001 - 12.000001, 15.002 - 15.0,
            18.0005 - 18.0]
    # the profiler's realtime seconds hold the nanoseconds to a few tenths
    # of a microsecond
    assert got == pytest.approx(statistics.fmean(true) * 1e3, abs=1e-3)
    assert hostspans.join_slip_ms(run, rec) == 0.0


def test_join_slip_is_the_most_a_kernel_precedes_its_order_launch():
    # the card's clock 3 ms behind for the last two kernels
    launches = [11.0, 12.0, 13.0, 14.0]
    kernels = [11.0001, 12.0001, 12.9971, 13.9971]
    dev = _device([(k, k + 1e-5, "stack_rois") for k in kernels])
    rec = _recorded([_launch(t) for t in launches])
    assert hostspans.join_slip_ms(_run(device=dev), rec) \
        == pytest.approx(2.9, abs=1e-3)
    assert hostspans.pair_launches([0, 10, 20], [5, 30]) == [5, 20]


def test_idle_gc_share_is_the_idle_time_inside_collections():
    # the span [10, 20]: busy [10, 12] and [15, 16]; idle 3 + 4 = 7 s;
    # collections [11, 13] (1 s of it idle) and [16.5, 17] (0.5 s)
    dev = _device([(10.0, 12.0, "Memcpy HtoD"), (15.0, 16.0, "k")])
    spans = [{"kind": "gc", "t": 11.0, "dur": 2.0},
             {"kind": "gc", "t": 16.5, "dur": 0.5},
             {"kind": "fn", "t": 12.5, "dur": 1.0, "cpu": 0.0, "tid": "a"}]
    got = hostspans.idle_gc_share(_run(device=dev), _recorded(spans))
    assert got == pytest.approx(100.0 * 1.5 / 7.0)


def test_anchor_drift_over_the_window():
    rec = _recorded([])
    rec.anchors = [(5.0, E + 5 * 10**9), (12.0, E + 12 * 10**9 + 3000),
                   (21.0, E + 21 * 10**9 + 12_000)]
    assert hostspans.anchor_drift_us(_run(), rec) \
        == {"drift_us": pytest.approx(12.0), "over_s": 16.0, "anchors": 3}


class _ParentRecorder:
    """A recorder of a program without the spans."""

    def events(self):
        return []


class _ParentStats:
    lock_hold_s = 1.0

    def as_dict(self):
        return {"lock_hold_s": 1.0}


def test_the_readers_give_none_where_the_run_has_nothing():
    dev = _device([(10.0, 12.0, "k")])
    for name, read in hostspans.READERS.items():
        assert read(_run(device=dev), None) is None, name
        assert read(_run(), _recorded([])) is None, name
    assert not hostspans.has_spans(_ParentRecorder())
    assert not hostspans.has_spans(None)
    assert hostspans.lock_counters(_ParentStats()) is None
    assert hostspans.gained(None, {"lock_wait_s": 1.0}) is None


def test_the_window_marks_locks_and_anchors_without_the_profiler():
    from repro_torch import obs
    from repro_torch.core.runtime import DispatchStats

    rec = obs.Recorder()

    class Engine:
        recorder = rec

        class runtime:
            stats = DispatchStats()

    holder = hostspans._Holder()
    holder.engine = Engine()
    win = hostspans._window_class(devtrace.Span, holder, profile=False)(
        harness.resolve("cpu"))
    win.__enter__()
    Engine.runtime.stats.lock_wait_s += 0.25
    Engine.runtime.stats.lock_sites["finish"].acquisitions += 3
    win.__exit__(None, None, None)
    assert win.trace is None and holder.engine is None
    locks = hostspans.gained(holder.locks0, holder.locks1)
    assert locks["lock_wait_s"] == 0.25
    assert locks["lock_finish_acquisitions"] == 3
    assert locks["lock_hold_s"] == 0.0
    assert len(rec.anchors) == 3


def test_a_recorded_tiny_run_leaves_the_existing_metrics_as_they_read(
        tiny_bench):
    cell = "stack.l10.saturate"
    wl = registry.cell(tiny_bench, cell)
    cfg = registry.config(tiny_bench, wl["config"])
    mix = registry.traffic(wl["traffic"])
    ref = registry.reference(cfg["reference"])
    saved = harness.RuntimeEngine, devtrace.Span, devtrace.warm_up
    run, rec = hostspans.run_recorded(cell, cfg, mix, ref, SEED,
                                      seconds_of(tiny_bench, cell), 0.0,
                                      device="cpu", profile=False)
    assert (harness.RuntimeEngine, devtrace.Span, devtrace.warm_up) == saved
    assert rec is not None and rec.spans_dropped == 0
    names = [m["name"] for m in tiny_bench["end_to_end"]
             + tiny_bench["per_layer"]
             if cell in m.get("workloads", [cell])]

    def existing():
        return {n: registry.reader(n)(run) for n in names}

    before = existing()
    assert before["fn_ms_mean.saturate"] is not None
    new = {n: read(run, rec) for n, read in hostspans.READERS.items()}
    hostspans.anchor_drift_us(run, rec)
    assert existing() == before
    # on the CPU: no profiled span (no window marks, no card)
    assert new["fn_cpu_ms_mean.saturate"] > 0.0
    assert new["store_copy_ms_mean.saturate"] > 0.0
    assert new["fn_cpu_ms_mean.saturate"] \
        <= before["fn_ms_mean.saturate"] * 1.5
    assert new["lock_wait_ms_per_task.saturate"] is None
    assert new["coadd_queue_ms_mean.saturate"] is None
    assert new["idle_gc_share.saturate"] is None
    kinds = {s["kind"] for s in rec.spans}
    assert {"fn", "store_copy"} <= kinds
    window = set(run.window)
    assert {s["tid"] for s in rec.spans if s["kind"] == "fn"} >= window


@pytest.mark.parametrize("mode", ["off", "rec"])
def test_measure_in_each_mode_is_correct(tiny_bench, mode):
    cell = "stack.l10.saturate"
    out = hostspans.measure(cell, SEED, seconds_of(tiny_bench, cell), mode,
                            device="cpu", bench=tiny_bench)
    assert out["correct"] and out["mode"] == mode
    assert out["metrics"]["tasks_per_s"] > 0
    assert ("fn_cpu_ms_mean.saturate" in out["metrics"]) == (mode == "rec")
