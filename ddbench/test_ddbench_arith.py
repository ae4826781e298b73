"""The benchmark's arithmetic and metric readers on synthetic numbers."""
from __future__ import annotations

import math
import statistics

import pytest

from ddbench import arith, readers
from ddbench.devtrace import DeviceTrace
from ddbench.harness import Run


def test_quantile_interpolates_and_refuses_nothing():
    assert arith.quantile([3.0, 1.0, 2.0], 0.5) == 2.0
    assert arith.quantile(list(range(101)), 0.95) == pytest.approx(95.0)
    assert arith.quantile([0.0, 10.0], 0.25) == pytest.approx(2.5)
    with pytest.raises(ValueError):
        arith.quantile([], 0.5)


def test_spread_is_the_quartile_distance_over_the_median():
    values = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert arith.spread(values) == pytest.approx((q3 - q1) / med)


def test_tasks_in_the_window_count_both_ends():
    assert arith.in_window([0.5, 1.0, 2.0, 3.0, 3.5], 1.0, 3.0) == 3


def test_latency_counts_a_missing_request_beyond_any_limit():
    due = {f"r{i}": 0.0 for i in range(20)}
    done = {f"r{i}": 0.1 * (i + 1) for i in range(19)}   # r19 never came
    lat = arith.latencies_from_due(due, done)
    assert math.isinf(max(lat))
    # 20 requests: the 95th percentile lies between the 19th and the 20th
    assert arith.tail(lat, 0.95, 60.0) == 60.0
    assert arith.tail(lat, 0.5, 60.0) == pytest.approx(1.05)


def test_failures_push_the_tail_out():
    due = {f"r{i}": float(i) for i in range(100)}
    done = {f"r{i}": i + 0.2 for i in range(100)}
    base = arith.tail(arith.latencies_from_due(due, done), 0.95, 60.0)
    for i in range(10):                   # a tenth fail
        done.pop(f"r{i}")
    worse = arith.tail(arith.latencies_from_due(due, done), 0.95, 60.0)
    assert base == pytest.approx(0.2) and worse == 60.0


def test_pool_integral_holds_each_size_until_the_next_sample():
    pool = [(0.0, 1), (1.0, 2), (2.0, 4), (5.0, 1)]
    assert arith.pool_integral(pool, 6.0) == pytest.approx(
        1 * 1 + 2 * 1 + 4 * 3 + 1 * 1)
    assert arith.pool_integral(pool, 1.5) == pytest.approx(1 + 2 * 0.5)
    assert arith.first_reach_of_peak(pool, 10.0) == (2.0, 4)
    assert arith.first_reach_of_peak(pool, 1.5) == (1.0, 2)


def test_busy_union_merges_overlaps_and_gaps_are_named_by_what_ends_them():
    ops = [(0.0, 1.0, "a"), (0.5, 2.0, "b"), (3.0, 4.0, "c"),
           (10.0, 11.0, "d")]
    assert arith.busy_union((s, e) for s, e, _ in ops) == pytest.approx(4.0)
    assert arith.idle_gaps(ops) == [("before d", 6.0), ("before c", 1.0)]


def test_stacking_bound_counts_each_byte_once():
    # 8 tiles of 100 x 100 fp32 read, 4 scalars per tile, one tile written
    assert arith.stacking_bytes(8, 100, 100) == 320_000 + 128 + 40_000
    assert arith.stacking_ops(8, 100, 100) == 810_000
    t, what = arith.stacking_bound(8, 100, 100)
    assert what == "bytes"
    assert t == pytest.approx(360_128 / 3.35e12)


def _run(**kw) -> Run:
    base = dict(cell="c", cfg={"tiles_per_file": 8, "tile_h": 100,
                               "tile_w": 100}, mix={}, seed=1, seconds=10.0,
                trace=False, loop="closed", setup_s=5.0, t_open=100.0,
                t_close=110.0, due={}, done_at={}, failed_at={}, ledger={},
                outputs={}, lock_hold_s=2.0, pool=[(0.0, 4)],
                extra={"grace_s": 60.0})
    base.update(kw)
    return Run(**base)


def _ledger(oid, hits=0, peer=0, misses=1):
    return {"inputs": (oid,), "cache_hits": hits, "peer_hits": peer,
            "cache_misses": misses, "submit_time": 0.0, "dispatch_time": 0.0,
            "start_time": 0.0, "end_time": 0.0}


def test_tasks_per_s_counts_only_completions_inside_the_window():
    done = {"a": 99.0, "b": 100.5, "c": 105.0, "d": 110.0, "e": 111.0}
    run = _run(done_at=done, ledger={k: _ledger(k) for k in done},
               due={k: 100.0 for k in done})
    assert readers.tasks_per_s(run) == pytest.approx(3 / 10.0)
    assert readers.latency_p95_ms(run) is None      # closed loop


def test_latency_p95_reads_from_the_due_time():
    due = {f"r{i}": 100.0 + i * 0.1 for i in range(40)}
    done = {t: d + 0.5 for t, d in due.items()}
    run = _run(loop="open", due=due, done_at=done)
    assert readers.latency_p95_ms(run) == pytest.approx(500.0)
    done.pop("r0")
    done.pop("r1")
    done.pop("r2")                                  # 3 of 40 never came
    assert readers.latency_p95_ms(run) == pytest.approx(60_000.0)


def test_executor_seconds_per_ktask_from_the_pool_log():
    due = {f"r{i}": 100.0 for i in range(2000)}
    done = {t: 104.0 for t in due}
    run = _run(loop="open", due=due, done_at=done,
               pool=[(0.0, 1), (1.0, 4), (3.0, 2)])
    # 1 x 1 + 4 x 2 + 2 x 1 executor-seconds over 2,000 requests
    assert readers.executor_s_per_ktask(run) == pytest.approx(11.0 / 2.0)


def test_store_reads_per_distinct_file_and_hit_ratio():
    led = {"a": _ledger("img1"), "b": _ledger("img1", hits=1, misses=0),
           "c": _ledger("img2", peer=1), "d": _ledger("img3"),
           "e": _ledger("img3")}
    done = {k: 105.0 for k in led}
    run = _run(ledger=led, done_at=done, due={k: 100.0 for k in led})
    # store reads: a, d, e (c came from a peer) over 3 files
    assert readers.store_reads_per_file(run) == pytest.approx(3 / 3)
    assert readers.cache_hit_ratio(run) == pytest.approx(100.0 * 2 / 5)


def test_roofline_and_idle_from_a_device_trace():
    done = {f"r{i}": 101.0 + i * 1e-3 for i in range(1000)}
    ops = [(i * 1e-3, i * 1e-3 + 5e-6, "stack_rois_kernel")
           for i in range(1000)]
    ops += [(i * 1e-3 + 6e-6, i * 1e-3 + 8e-6, "Memcpy HtoD")
            for i in range(1000)]
    dev = DeviceTrace(100.0, 110.0, ops)
    run = _run(done_at=done, device=dev)
    bound, _ = arith.stacking_bound(8, 100, 100)
    assert readers.coadd_roofline(run) == pytest.approx(
        100.0 * 1000 * bound / (1000 * 5e-6))
    assert readers.device_idle(run) == pytest.approx(
        100.0 * (1 - 1000 * 7e-6 / 10.0))
    assert dev.top_ops(1)[0][0] == "stack_rois_kernel"
    assert readers.coadd_roofline(_run()) is None


def test_lock_share_pool_ramp_and_spans():
    run = _run(pool=[(0.0, 1), (1.0, 2), (6.0, 64), (20.0, 8), (25.0, 64)],
               spans={"a": (100.2, 100.5)},
               ledger={"a": dict(_ledger("img1"), start_time=100.1)},
               done_at={"a": 100.6}, due={"a": 100.0})
    assert readers.dispatch_lock_share(run) == pytest.approx(20.0)
    assert readers.pool_ramp_s(run) == 6.0
    assert readers.stage_ms_mean(run) == pytest.approx(100.0)
    assert readers.fn_ms_mean(run) == pytest.approx(300.0)


def test_per_bucket_counts_stamps_from_the_open():
    stamps = [10.0, 10.4, 14.99, 15.0, 29.9, 30.0, 9.99]
    assert arith.per_bucket(stamps, 10.0, 5.0, 4) == [3, 1, 0, 1]
