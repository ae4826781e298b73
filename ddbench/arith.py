"""The yardstick's arithmetic: pure functions on numbers, no torch, no program.

Copied here from sound sources so that a later change to the program cannot
move the ruler it is measured with:

  * ``quantile``: linear interpolation between order statistics, as
    ``repro_torch.workloads.metrics.quantile`` computes it;
  * ``busy_union``: the union of device intervals, as
    ``repro_torch.apps.flat_breakdown._device_time`` computes it;
  * ``stacking_bound``: the least time of one coadd on an H100, as
    ``chip_smoke.stacking_bound`` counts it;
  * ``pool_integral``: executor-seconds from (time, pool size) samples.
"""
from __future__ import annotations

import math
import statistics
from typing import Iterable, Sequence

#: the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def quantile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile of an unsorted sequence (``inf`` entries
    sort last).  Raises on an empty sequence: a tail of nothing is no 0."""
    if not values:
        raise ValueError("quantile of an empty sample")
    s = sorted(values)
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    if s[hi] == s[lo]:
        return s[lo]
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median, with the quartiles ``statistics.quantiles(values, n=4)`` gives."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)


def in_window(stamps: Iterable[float], t_open: float, t_close: float) -> int:
    """How many of ``stamps`` fall in ``[t_open, t_close]``."""
    return sum(1 for t in stamps if t_open <= t <= t_close)


def per_bucket(stamps: Iterable[float], t_open: float, width: float,
               n: int) -> list[int]:
    """How many of ``stamps`` fall in each of ``n`` buckets of ``width``
    seconds from ``t_open`` (a bucket holds its start, not its end)."""
    counts = [0] * n
    for t in stamps:
        k = math.floor((t - t_open) / width)
        if 0 <= k < n:
            counts[k] += 1
    return counts


def latencies_from_due(due: dict, done_at: dict) -> list[float]:
    """Seconds from each request's due time to its completion, over every
    request in ``due`` (tid -> due time).  A request with no completion in
    ``done_at`` (it failed, or never came) reads ``inf``."""
    return [done_at[tid] - t if tid in done_at else math.inf
            for tid, t in due.items()]


def tail(latencies: Sequence[float], q: float,
         floor_for_missing: float) -> float:
    """The ``q`` quantile of ``latencies`` where a missing request (``inf``)
    is beyond any limit; where the quantile itself lands on a missing one,
    the finite ``floor_for_missing`` (what was waited for it) is reported,
    a lower bound of that tail."""
    v = quantile(latencies, q)
    return floor_for_missing if math.isinf(v) else v


def pool_integral(samples: Sequence[tuple[float, int]], t_end: float) -> float:
    """Executor-seconds over ``[samples[0][0], t_end]``: each sampled pool
    size holds until the next sample."""
    if not samples:
        raise ValueError("no pool samples")
    total = 0.0
    for (t, n), (t_next, _) in zip(samples, list(samples[1:]) + [(t_end, 0)]):
        total += n * max(min(t_next, t_end) - t, 0.0)
    return total


def first_reach_of_peak(samples: Sequence[tuple[float, int]],
                        t_close: float) -> tuple[float, int]:
    """(time of the first sample at the pool's largest size in
    ``[samples[0][0], t_close]``, that size)."""
    inside = [(t, n) for t, n in samples if t <= t_close]
    peak = max(n for _, n in inside)
    return next(t for t, n in inside if n == peak), peak


def busy_union(spans: Iterable[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, cur = 0.0, None
    for start, end in sorted(spans):
        if cur is None or start > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy


def idle_gaps(spans: Iterable[tuple[float, float, str]],
              n: int = 10) -> list[tuple[str, float]]:
    """The ``n`` longest gaps between device operations, each named by the
    operation that ended it: ``[("before <name>", length), ...]``."""
    gaps, reach = [], None
    for start, end, name in sorted(spans):
        if reach is not None and start > reach:
            gaps.append((f"before {name}", start - reach))
        reach = end if reach is None else max(reach, end)
    return sorted(gaps, key=lambda g: -g[1])[:n]


def stacking_bytes(n: int, h: int, w: int) -> int:
    """Bytes one coadd of ``n`` fp32 ROIs of ``h`` x ``w`` must move: each
    ROI read once, the four per-ROI scalars (sky, cal, dy, dx) read once,
    the fp32 output written once."""
    return 4 * n * h * w + 4 * 4 * n + 4 * h * w


def stacking_ops(n: int, h: int, w: int) -> int:
    """fp32 operations of one coadd: 10 per ROI pixel (calibrate 2, bilinear
    blend 7, accumulate 1) and the division by ``n`` per output pixel."""
    return 10 * n * h * w + h * w


def stacking_bound(n: int, h: int, w: int) -> tuple[float, str]:
    """Least seconds one coadd could take on the card, and what sets it:
    its bytes over HBM bandwidth or its operations over the fp32 peak
    outside the tensor cores, the larger."""
    t_bytes = stacking_bytes(n, h, w) / HBM_BYTES_PER_S
    t_ops = stacking_ops(n, h, w) / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
