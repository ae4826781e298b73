"""The port's request spans, on the CPU: the recorder's span ring beside the
lifecycle stream, the per-thread request context and each span's parent,
the realtime anchors and ``to_epoch_ns``, the runtime's lock counters at
each of its four lock sites, the collector hook that only a recorder
installs, the Chrome-trace timeline with the card's operations, and the
naming of the card's idle gaps by the host spans open across them."""
import gc
import json
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import DataObject, Task
from repro_torch.core.runtime import LOCK_SITES, DiffusionRuntime
from repro_torch.kernels.stacking import stacking
from repro_torch.obs import recorder as recorder_mod
from repro_torch.obs import timeline

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# the span ring
# --------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [1, 3, 64])
def test_span_ring_is_bounded_and_counts_its_drops(capacity):
    rec = obs.Recorder(capacity=capacity, clock=lambda: 2.0)
    for i in range(10):
        rec.span("fn", float(i), 0.5, tid=f"t{i}", eid="w0", cpu=0.1, ok=True)
    spans = rec.spans()
    assert len(spans) == min(capacity, 10)
    assert rec.spans_emitted == 10 and rec.spans_dropped == 10 - len(spans)
    # the oldest go first
    assert [s["tid"] for s in spans] == [f"t{i}" for i in
                                         range(10 - len(spans), 10)]
    assert spans[-1] == {"kind": "fn", "t": 9.0, "dur": 0.5, "tid": "t9",
                         "eid": "w0", "cpu": 0.1, "ok": True}
    # the lifecycle ring is untouched
    assert rec.events() == [] and (rec.emitted, rec.dropped) == (0, 0)


def test_spans_stay_out_of_the_lifecycle_stream_and_its_sink(tmp_path):
    plain = obs.Recorder(capacity=8, clock=lambda: 1.5)
    spanned = obs.Recorder(capacity=8, clock=lambda: 1.5)
    for rec in (plain, spanned):
        rec.emit("task_arrived", tid="a")
        rec.emit("pump", n=1, queue=0)
    spanned.span("store_copy", 1.0, 0.25, tid="a", bytes=6, parent="stage")
    spanned.span("gc", 1.1, 0.05, generation=2, collected=9)
    assert spanned.events() == plain.events()
    assert len(spanned) == len(plain) == 2
    plain.dump(tmp_path / "plain.jsonl")
    spanned.dump(tmp_path / "spanned.jsonl")
    assert (tmp_path / "plain.jsonl").read_text() \
        == (tmp_path / "spanned.jsonl").read_text()
    header, events = obs.load_events(tmp_path / "spanned.jsonl")
    assert header["n_events"] == 2 and all(e["kind"] in obs.EVENT_KINDS
                                           for e in events)
    assert spanned.drain() == plain.drain()
    assert len(spanned.spans()) == 2
    assert not obs.SPAN_KINDS & obs.EVENT_KINDS
    assert {s["kind"] for s in spanned.spans()} <= obs.SPAN_KINDS


# --------------------------------------------------------------------------
# anchors and the realtime clock
# --------------------------------------------------------------------------

class _FakeTime:
    """``time.monotonic`` and ``time.time_ns`` from scripted values."""

    def __init__(self, mono, ns):
        self.mono, self.ns = list(mono), list(ns)

    def monotonic(self):
        return self.mono.pop(0)

    def time_ns(self):
        return self.ns.pop(0)


def _recorder_on(monkeypatch, fake):
    monkeypatch.setattr(recorder_mod, "time", fake)
    return obs.Recorder(capacity=4)


def test_anchor_keeps_the_tightest_read(monkeypatch):
    # the zero, then five (clock, time_ns, clock) triples: the third is the
    # tightest (about 1 ms wide)
    mono = [100.0,
            100.0, 100.010, 100.02, 100.025, 100.030, 100.031001,
            100.05, 100.06, 100.07, 100.09]
    ns = [5_000, 6_000, 7_000, 8_000, 9_000]
    rec = _recorder_on(monkeypatch, _FakeTime(mono, ns))
    assert rec.base == 100.0
    (t, e), = rec.anchors
    assert e == 7_000 and t == pytest.approx(0.0305005, abs=1e-9)


def _steady(monkeypatch, pairs):
    """A recorder whose anchors are exactly ``pairs`` of (monotonic s,
    epoch ns): each anchor's five reads are all the same pair."""
    mono = [0.0]
    ns = []
    for m, e in pairs:
        mono += [m] * 10
        ns += [e] * 5
    fake = _FakeTime(mono, ns)
    rec = _recorder_on(monkeypatch, fake)
    for _ in pairs[1:]:
        rec.anchor()
    return rec


def test_to_epoch_ns_interpolates_and_follows_a_slew(monkeypatch):
    E = 1_700_000_000_000_000_000
    # realtime runs 100 ppm fast between the second and third anchors
    rec = _steady(monkeypatch, [(0.0, E), (10.0, E + 10_000_000_000),
                                (20.0, E + 20_001_000_000)])
    assert rec.anchors == [(0.0, E), (10.0, E + 10_000_000_000),
                           (20.0, E + 20_001_000_000)]
    assert rec.to_epoch_ns(0.0) == E
    assert rec.to_epoch_ns(5.0) == E + 5_000_000_000
    assert rec.to_epoch_ns(15.0) == E + 15_000_500_000
    assert rec.to_epoch_ns(20.0) == E + 20_001_000_000
    # outside the anchors: the nearest anchor's offset
    assert rec.to_epoch_ns(-1.0) == E - 1_000_000_000
    assert rec.to_epoch_ns(21.0) == E + 21_001_000_000


def test_anchor_every_skips_a_fresh_anchor(monkeypatch):
    E = 10**18
    mono = [0.0] + [0.0] * 10 + [0.5] + [3.0] + [3.0] * 10
    ns = [E] * 5 + [E + 3 * 10**9] * 5
    rec = _recorder_on(monkeypatch, _FakeTime(mono, ns))
    assert rec.anchor(every=1.0) is None          # 0.5 s after the last
    assert rec.anchor(every=1.0) == (3.0, E + 3 * 10**9)
    assert len(rec.anchors) == 2


def test_a_simulated_clock_has_no_anchors():
    rec = obs.Recorder(clock=lambda: 4.0)
    assert rec.base is None and rec.anchors == []
    assert rec.anchor() is None
    with pytest.raises(ValueError, match="no realtime anchors"):
        rec.to_epoch_ns(4.0)
    # a recorder whose clock the simulator swapped afterwards
    swapped = obs.Recorder()
    assert len(swapped.anchors) == 1
    swapped.clock = lambda: 7.0
    assert swapped.anchor() is None
    with pytest.raises(ValueError):
        swapped.to_epoch_ns(1.0)


def test_real_anchors_agree_with_the_realtime_clock():
    import time

    rec = obs.Recorder()
    rec.anchor()
    t = rec.clock()
    now = time.time_ns()
    assert abs(rec.to_epoch_ns(t) - now) < 5_000_000


# --------------------------------------------------------------------------
# the runtime: spans, request context, collector hook, lock counters
# --------------------------------------------------------------------------

def _payload(i):
    return np.full((4, 8, 8), float(i), dtype=np.float32)


def _run(recorder, fn, n_files=6, n_tasks=30, executors=3, batches=3):
    rt = DiffusionRuntime(executors, recorder=recorder, device="cpu")
    try:
        for i in range(n_files):
            rt.put_object(DataObject(f"f{i}", 8 * 8 * 4 * 4), _payload(i))
        per = n_tasks // batches
        for b in range(batches):
            rt.submit([Task(inputs=(f"f{(b * per + j) % n_files}",), fn=fn,
                            tid=f"r{b * per + j}") for j in range(per)])
        assert rt.wait(60.0)
        return rt
    finally:
        rt.shutdown()


def test_request_context_and_each_spans_parent():
    rec = obs.Recorder(capacity=1 << 12)
    seen = []

    def fn(inputs):
        seen.append((obs.request(), threading.current_thread().name))
        return sum(float(x.sum()) for x in inputs.values())

    rt = _run(rec, fn)
    assert len(rt.dispatcher.completed) == 30
    by_tid = {t.tid: t for t in rt.dispatcher.completed}
    for ctx, _ in seen:
        r, tid, eid = ctx
        assert r is rec and by_tid[tid].executor == eid
    spans = rec.spans()
    fns = [s for s in spans if s["kind"] == "fn"]
    assert sorted(s["tid"] for s in fns) == sorted(by_tid)
    for s in fns:
        assert s["eid"] == by_tid[s["tid"]].executor and s["ok"] is True
        assert 0.0 <= s["cpu"] and 0.0 <= s["dur"]
    copies = [s for s in spans if s["kind"] == "store_copy"]
    assert len(copies) == rt.ledger.store_reads
    assert all(s["parent"] == "stage" and s["bytes"] == 8 * 8 * 4 * 4
               and s["tid"] in by_tid for s in copies)
    # each copy lies between its request's dispatch and its exec_start
    starts = {e["tid"]: e["t"] for e in rec.events()
              if e["kind"] == "exec_start"}
    assert all(s["t"] + s["dur"] <= starts[s["tid"]] for s in copies)
    # the context is gone once the attempt is over
    assert obs.request() is None


def test_a_failing_function_is_an_fn_span_that_did_not_return():
    rec = obs.Recorder()

    def fn(inputs):
        raise RuntimeError("planted")

    rt = DiffusionRuntime(1, recorder=rec, device="cpu")
    try:
        rt.put_object(DataObject("f0", 16), _payload(0))
        rt.submit([Task(inputs=("f0",), fn=fn, tid="bad", max_attempts=1)])
        assert rt.wait(30.0)
    finally:
        rt.shutdown()
    fns = [s for s in rec.spans() if s["kind"] == "fn"]
    assert [(s["tid"], s["ok"]) for s in fns] == [("bad", False)]


def test_the_launch_span_is_the_requests(monkeypatch):
    """The kernel wrapper's span, with the C launch and the card's checks
    replaced: inside an attempt it carries the attempt's task id and its
    parent ``fn``; outside one it records nothing."""
    calls = []
    monkeypatch.setattr(stacking, "check_inputs", lambda *a: None)
    monkeypatch.setattr(stacking, "_entry",
                        lambda: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(stacking.torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 7, raising=False)
    rec = obs.Recorder()

    def fn(inputs):
        (x,) = inputs.values()
        n = x.shape[0]
        ones = torch.ones(n)
        return stacking.stack_rois_fwd(x, ones, ones, ones, ones)

    rt = _run(rec, fn, n_tasks=6, batches=1)
    launches = [s for s in rec.spans() if s["kind"] == "launch"]
    assert len(calls) == len(launches) == 6
    assert sorted(s["tid"] for s in launches) \
        == sorted(t.tid for t in rt.dispatcher.completed)
    assert all(s["parent"] == "fn" and s["kernel"] == "stack_rois"
               for s in launches)
    fns = {s["tid"]: s for s in rec.spans() if s["kind"] == "fn"}
    for s in launches:
        f = fns[s["tid"]]
        assert f["t"] <= s["t"] and s["t"] + s["dur"] <= f["t"] + f["dur"]
    x = torch.ones(2, 3, 3)
    stacking.stack_rois_fwd(x, *(torch.ones(2),) * 4)
    assert len(calls) == 7
    assert len([s for s in rec.spans() if s["kind"] == "launch"]) == 6


def test_the_one_call_coadd_is_one_launch_span_and_one_count(monkeypatch):
    """The one-call coadd, with the C entry and the card's checks replaced:
    one call into the library a request, inside a ``launch`` span of the
    attempt; the output is the first H*W floats of its one allocation and
    the scratch follows it; the shifts and the sky fraction reach the entry
    as given; every coadd adds one to the kernel's launches and to the
    one-call counter."""
    calls = []
    monkeypatch.setattr(stacking, "check_coadd_inputs", lambda *a: None)
    monkeypatch.setattr(stacking, "_coadd_entry",
                        lambda: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(stacking.torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 7, raising=False)
    counters = (stacking.launches, stacking.coadd_calls)
    before = [c.value for c in counters]
    rec = obs.Recorder()
    outs = {}

    def fn(inputs):
        (x,) = inputs.values()
        shifts = np.arange(2 * x.shape[0], dtype=np.float32).reshape(2, -1)
        out = stacking.coadd_fwd(x, shifts, 0.25)
        outs[x.data_ptr()] = out
        return out

    rt = _run(rec, fn, n_tasks=6, batches=1)
    launches = [s for s in rec.spans() if s["kind"] == "launch"]
    assert len(calls) == len(launches) == 6
    assert sorted(s["tid"] for s in launches) \
        == sorted(t.tid for t in rt.dispatcher.completed)
    assert all(s["parent"] == "fn" and s["kernel"] == "stack_rois"
               for s in launches)
    for tiles_ptr, shifts, fraction, scratch, out_ptr, n, h, w, mean, _, \
            stream in calls:
        out = outs[tiles_ptr]
        assert out.shape == (h, w) and out.data_ptr() == out_ptr
        assert scratch == out_ptr + 4 * h * w
        assert out.untyped_storage().nbytes() >= 4 * (h * w + 4 * n)
        assert shifts == np.arange(2 * n, dtype=np.float32).tobytes()
        assert (fraction, mean, stream) == (0.25, 1, 7)
    assert [c.value - b for c, b in zip(counters, before)] == [6, 6]
    stacking.coadd_fwd(torch.ones(5, 3, 3), np.ones((2, 5), np.float32), 0.1)
    assert len(calls) == 7
    assert [c.value - b for c, b in zip(counters, before)] == [7, 7]
    assert len([s for s in rec.spans() if s["kind"] == "launch"]) == 6


def test_with_no_recorder_nothing_is_recorded_or_installed():
    hooks_before = list(gc.callbacks)
    seen = []

    def fn(inputs):
        # no request context on this thread, never written
        seen.append((obs.request(), dict(vars(recorder_mod._REQUEST)),
                     list(gc.callbacks)))
        gc.collect(0)
        return 0

    rt = _run(None, fn)
    assert rt.recorder is None and len(seen) == 30
    assert all(ctx is None and local == {} and hooks == hooks_before
               for ctx, local, hooks in seen)
    assert gc.callbacks == hooks_before
    st = rt.stats
    for name in ("submit", "update", "finish"):
        assert st.lock_sites[name].hold_s == 0.0


def test_with_a_recorder_the_collector_hook_lives_until_shutdown():
    hooks_before = list(gc.callbacks)
    rec = obs.Recorder()
    inside = []

    def fn(inputs):
        inside.append(len(gc.callbacks))
        gc.collect(1)
        return 0

    rt = _run(rec, fn, n_tasks=6, batches=2)
    assert inside and all(n == len(hooks_before) + 1 for n in inside)
    assert gc.callbacks == hooks_before
    # a gc.collect() that meets another thread's collection returns at once,
    # with no pause of its own: at least one pause, not one a call
    pauses = [s for s in rec.spans() if s["kind"] == "gc"]
    assert pauses
    assert all(s["dur"] >= 0 and s["generation"] in (0, 1, 2)
               and isinstance(s["collected"], int) for s in pauses)
    # shutdown took a last anchor, after the construction's
    assert len(rec.anchors) >= 2
    rt.shutdown()            # twice is harmless
    assert gc.callbacks == hooks_before


def test_a_collection_inside_the_recorders_lock_does_not_wait_for_it():
    """Any allocation can start a collection, also one under the recorder's
    lock (a snapshot of the rings): the collector hook must not wait for
    that lock, and its span joins the ring afterwards."""
    rec = obs.Recorder()
    rt = DiffusionRuntime(1, recorder=rec, device="cpu")
    threshold = gc.get_threshold()
    done = threading.Event()

    def snapshot():
        for i in range(2000):
            rec.emit("pump", n=i, queue=0)
        gc.set_threshold(1)
        try:
            for _ in range(20):
                rec.events()
                rec.spans()
                _ = rec.anchors
        finally:
            gc.set_threshold(*threshold)
        done.set()

    th = threading.Thread(target=snapshot, daemon=True)
    try:
        th.start()
        th.join(30.0)
        assert done.is_set(), "a collection waited for the recorder's lock"
        pauses = [s for s in rec.spans() if s["kind"] == "gc"]
        assert pauses
        assert rec.spans_emitted == len(rec.spans())
    finally:
        rt.shutdown()


@pytest.mark.parametrize("recorded", [False, True])
def test_lock_counters_at_each_site(recorded):
    rec = obs.Recorder(capacity=1 << 12) if recorded else None
    rt = _run(rec, lambda inputs: 0, n_tasks=30, batches=3)
    st = rt.stats
    sites = st.lock_sites
    assert tuple(sites) == LOCK_SITES
    assert sites["submit"].acquisitions == 3
    assert sites["finish"].acquisitions == 30
    # one index update per cache admit: a store read or a peer fetch
    assert sites["update"].acquisitions \
        == rt.ledger.store_reads + rt.ledger.peer_hits
    assert sites["pump"].acquisitions == st.pump_calls >= 33
    assert st.lock_wait_s == pytest.approx(
        sum(s.wait_s for s in sites.values()), rel=1e-9, abs=1e-12)
    assert all(s.wait_s >= 0.0 for s in sites.values())
    # the pump's hold is lock_hold_s, to the last bit
    assert sites["pump"].hold_s == st.lock_hold_s > 0.0
    other_holds = [sites[n].hold_s for n in ("submit", "update", "finish")]
    if recorded:
        assert all(h > 0.0 for h in other_holds)
    else:
        assert other_holds == [0.0, 0.0, 0.0]
    d = rt.dispatch_stats()
    assert "dispatch_batches" not in d and "max_dispatch_batch" not in d
    assert d["lock_wait_s"] == st.lock_wait_s
    for name in LOCK_SITES:
        for k in ("acquisitions", "wait_s", "hold_s"):
            assert d[f"lock_{name}_{k}"] == getattr(sites[name], k)
    json.dumps(d)


def test_counters_and_spans_lose_nothing_under_thread_switches():
    """More executors than cores, a switch interval of a microsecond: every
    attempt counts one finish and one fn span, every submit one submit."""
    interval = sys.getswitchinterval()
    rec = obs.Recorder(capacity=1 << 14)
    sys.setswitchinterval(1e-6)
    try:
        rt = _run(rec, lambda inputs: 0, n_files=40, n_tasks=400,
                  executors=16, batches=20)
    finally:
        sys.setswitchinterval(interval)
    sites = rt.stats.lock_sites
    assert len(rt.dispatcher.completed) == 400
    assert sites["finish"].acquisitions == 400
    assert sites["submit"].acquisitions == 20
    assert sites["update"].acquisitions \
        == rt.ledger.store_reads + rt.ledger.peer_hits
    assert len([s for s in rec.spans() if s["kind"] == "fn"]) == 400
    assert rec.spans_emitted == len(rec.spans()) and rec.spans_dropped == 0


def test_a_run_with_spans_emits_the_same_lifecycle_kinds():
    rec = obs.Recorder(capacity=1 << 12)
    _run(rec, lambda inputs: 0)
    assert {e["kind"] for e in rec.events()} <= obs.EVENT_KINDS
    fps = obs.lifecycle_fingerprints(rec.events())
    assert len(fps) == 30 and all(
        kinds == ("task_arrived", "task_queued", "task_dispatched",
                  "exec_start", "exec_end", "task_done")
        for kinds, _, _ in fps.values())


# --------------------------------------------------------------------------
# the timeline: Chrome trace with the card, idle gaps named
# --------------------------------------------------------------------------

def _timeline_recorder(monkeypatch):
    E = 1_000_000_000_000_000_000
    return _steady(monkeypatch, [(0.0, E), (10.0, E + 10_000_000_000)]), E


def test_chrome_trace_without_the_new_inputs_is_unchanged():
    events = [{"t": 1.0, "kind": "exec_start", "tid": "a", "eid": "w0"},
              {"t": 1.5, "kind": "exec_end", "tid": "a", "eid": "w0",
               "ok": True}]
    assert obs.chrome_trace(events) \
        == obs.chrome_trace(events, spans=None, device_ops=None) \
        == obs.chrome_trace(events, spans=[], device_ops=[])


def test_chrome_trace_lays_spans_and_card_on_one_clock(monkeypatch):
    rec, E = _timeline_recorder(monkeypatch)
    events = [{"t": 1.0, "kind": "exec_start", "tid": "a", "eid": "w0"},
              {"t": 1.5, "kind": "exec_end", "tid": "a", "eid": "w0",
               "ok": True}]
    spans = [{"kind": "fn", "t": 1.0, "dur": 0.5, "tid": "a", "eid": "w0",
              "cpu": 0.01, "ok": True},
             {"kind": "launch", "t": 1.2, "dur": 0.001, "tid": "a",
              "eid": "w0", "kernel": "stack_rois", "parent": "fn"},
             {"kind": "gc", "t": 2.0, "dur": 0.1, "generation": 2,
              "collected": 3}]
    ops = [(E + 1_202_000_000, E + 1_202_010_000, "stack_rois_kernel")]
    with pytest.raises(ValueError, match="to_epoch_ns"):
        obs.chrome_trace(events, spans=spans, device_ops=ops)
    out = obs.chrome_trace(events, spans=spans, device_ops=ops,
                           to_epoch_ns=rec.to_epoch_ns)
    xs = {(e["cat"], e["name"]): e for e in out["traceEvents"]
          if e["ph"] == "X"}
    assert xs[("task", "a")]["ts"] == 0.0 \
        and xs[("task", "a")]["dur"] == 500_000.0
    assert xs[("span", "launch")]["ts"] == 200_000.0
    assert xs[("span", "launch")]["tid"] == xs[("task", "a")]["tid"]
    kernel = xs[("device", "stack_rois_kernel")]
    assert kernel["pid"] == 1 and kernel["ts"] == 202_000.0 \
        and kernel["dur"] == 10.0
    gc_span = xs[("span", "gc")]
    names = {(e["pid"], e["tid"]): e["args"]["name"]
             for e in out["traceEvents"] if e["ph"] == "M"}
    assert names[(0, gc_span["tid"])] == "host"
    assert names[(1, 0)] == "device"
    assert gc_span["args"] == {"generation": 2, "collected": 3}


def test_idle_gaps_are_named_by_the_host_spans_open_across_them(
        monkeypatch):
    rec, E = _timeline_recorder(monkeypatch)
    ms = 1_000_000
    ops = [(E + 0 * ms, E + 1 * ms, "copy"), (E + 5 * ms, E + 6 * ms, "k"),
           (E + 20 * ms, E + 21 * ms, "k")]
    spans = [{"kind": "gc", "t": 0.0065, "dur": 0.010},
             {"kind": "fn", "t": 0.0, "dur": 0.030, "tid": "a"},
             {"kind": "fn", "t": 0.002, "dur": 0.001, "tid": "b"}]
    gaps = timeline.idle_gaps(ops, E, E + 25 * ms)
    assert gaps == [(E + 1 * ms, E + 5 * ms), (E + 6 * ms, E + 20 * ms),
                    (E + 21 * ms, E + 25 * ms)]
    named = obs.name_idle_gaps(ops, spans, rec.to_epoch_ns, n=2,
                               t0_ns=E, t1_ns=E + 25 * ms)
    assert [g["start_ns"] for g in named] == [E + 6 * ms, E + 1 * ms]
    assert named[0]["dur_s"] == pytest.approx(0.014)
    assert named[0]["name"] == "fn+gc"
    assert named[0]["open"] == [("fn", pytest.approx(0.014), 1),
                                ("gc", pytest.approx(0.010), 1)]
    assert named[1]["name"] == "fn"
    assert named[1]["open"] == [("fn", pytest.approx(0.005), 2)]
    assert timeline.name_idle_gaps(ops, [], rec.to_epoch_ns, n=1)[0][
        "name"] == "none"
