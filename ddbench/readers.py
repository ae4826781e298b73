"""Readers shared by the metric files under ``metrics/``.

Each takes a :class:`ddbench.harness.Run` and returns a number, or None
where the run holds nothing to read (the harness then leaves the metric out
of the line).  Shares are in percent.
"""
from __future__ import annotations

import statistics

from . import arith


# -- end to end (the host's clock) --------------------------------------------

def tasks_per_s(run):
    """Requests completed in the window over the window's seconds."""
    if run.loop != "closed":
        return None
    return len(run.window) / run.seconds


def latency_p95_ms(run):
    """95th percentile over every request due in the window of its
    completion less its due time; one that failed or never came is beyond
    any limit."""
    if run.loop != "open" or not run.due:
        return None
    lat = arith.latencies_from_due(run.due, run.done_at)
    # a request still missing was waited for at least the grace past the
    # close, so a tail that lands on one is at least that
    return arith.tail(lat, 0.95, run.extra["grace_s"]) * 1e3


def executor_s_per_ktask(run):
    """Executor-seconds from the open to the last completion of the
    window's requests, per 1,000 requests completed."""
    done = sum(1 for tid in run.due if tid in run.done_at)
    if run.loop != "open" or not done:
        return None
    return arith.pool_integral(run.pool, run.drain_s) / (done / 1e3)


def setup_s(run):
    return run.setup_s


# -- per layer ----------------------------------------------------------------

def dispatch_lock_share(run):
    """Share of the window the runtime's dispatch lock was held on the pump
    path (``DispatchStats.lock_hold_s`` gained in the window)."""
    return 100.0 * run.lock_hold_s / run.seconds


def queue_wait_p95_ms(run):
    """95th percentile of dispatch less submission over the window's
    completed requests (the program's ``Task`` stamps)."""
    waits = [run.ledger[t]["dispatch_time"] - run.ledger[t]["submit_time"]
             for t in run.window if t in run.done_at and t in run.ledger]
    return arith.quantile(waits, 0.95) * 1e3 if waits else None


def _window_spans(run):
    if run.spans is None:
        return []
    return [(run.ledger[t]["start_time"], *run.spans[t])
            for t in run.window if t in run.spans]


def stage_ms_mean(run):
    """Mean of the recorder's ``exec_start`` less ``Task.start_time``: the
    staging of a request's inputs (lookup, peer fetch or store copy)."""
    spans = _window_spans(run)
    if not spans:
        return None
    return statistics.fmean(s - t for t, s, _ in spans) * 1e3


def fn_ms_mean(run):
    """Mean of ``exec_end`` less ``exec_start``: the task function."""
    spans = _window_spans(run)
    if not spans:
        return None
    return statistics.fmean(e - s for _, s, e in spans) * 1e3


def _completed_ledgers(run):
    return [run.ledger[t] for t in run.window
            if t in run.done_at and t in run.ledger]


def cache_hit_ratio(run):
    """Inputs served by a cache (local or peer) over inputs read."""
    rows = _completed_ledgers(run)
    reads = sum(r["cache_hits"] + r["cache_misses"] for r in rows)
    if not reads:
        return None
    return 100.0 * sum(r["cache_hits"] + r["peer_hits"] for r in rows) / reads


def store_reads_per_file(run):
    """Store reads over the distinct files the window's requests named: 1.0
    is data diffusion's ideal, the locality a store-only system's."""
    rows = _completed_ledgers(run)
    files = {oid for r in rows for oid in r["inputs"]}
    if not files:
        return None
    return sum(r["cache_misses"] - r["peer_hits"] for r in rows) / len(files)


def pool_ramp_s(run):
    """Seconds from the open until the pool first reached its largest size
    in the window."""
    return arith.first_reach_of_peak(run.pool, run.seconds)[0]


def coadd_roofline(run):
    """Requests completed in the profiled span times the least time one
    coadd could take, over all kernel time on the card in the span."""
    dev = run.device
    if dev is None:
        return None
    kernel_s = dev.kernel_s
    n = arith.in_window(run.done_at.values(), dev.t0, dev.t1)
    if not kernel_s or not n:
        return None
    cfg = run.cfg
    bound, _ = arith.stacking_bound(cfg["tiles_per_file"], cfg["tile_h"],
                                    cfg["tile_w"])
    return 100.0 * n * bound / kernel_s


def device_idle(run):
    """Share of the profiled span with no kernel or copy on the card."""
    dev = run.device
    if dev is None:
        return None
    return 100.0 * (1.0 - dev.busy_s / dev.window_s)
