"""The card's activity over the measured window, from ``torch.profiler``.

Only CUDA activity is traced (recording every host op of 64 executor
threads slows them severalfold).  The profiler's raw kineto events are read
directly: ``key_averages()`` over a run's tens of thousands of kernels takes
far longer than the window.  A process's first profiler session stalls every
thread for seconds, so :func:`warm_up` runs one during set-up.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from . import arith

#: device events that move bytes rather than run a kernel
COPY_PREFIXES = ("Memcpy", "Memset")


@dataclass
class DeviceTrace:
    """Device operations (start s, end s, name) of one profiled span, and
    the span's ends on the host's monotonic clock."""

    t0: float
    t1: float
    ops: list[tuple[float, float, str]]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        """Seconds in which any kernel or copy ran on the card."""
        return arith.busy_union((s, e) for s, e, _ in self.ops)

    @property
    def kernel_s(self) -> float:
        """Seconds in which any kernel ran on the card."""
        return arith.busy_union((s, e) for s, e, name in self.ops
                                if not name.startswith(COPY_PREFIXES))

    def top_ops(self, n: int = 10) -> list[list]:
        by_name: dict[str, float] = {}
        for s, e, name in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], secs] for name, secs in top]

    def idle_gaps(self, n: int = 10) -> list[list]:
        return [[name[:120], secs]
                for name, secs in arith.idle_gaps(self.ops, n)]


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def warm_up(device: torch.device) -> None:
    """One short profiled session, so the window's is not a process's first."""
    with _profiler():
        torch.ones(1024, device=device).add_(1.0)
        torch.cuda.synchronize(device)


class Span:
    """``with Span(device) as span:`` profiles the card; afterwards
    ``span.trace`` holds what ran.  The span ends with a synchronise, so
    work launched inside it is in the trace."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.trace: DeviceTrace | None = None

    def __enter__(self) -> "Span":
        self._prof = _profiler().__enter__()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize(self.device)
        t1 = time.monotonic()
        self._prof.__exit__(*exc)
        cuda = torch.autograd.DeviceType.CUDA
        ops = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda or e.is_user_annotation():
                continue
            start = e.start_ns() * 1e-9
            ops.append((start, start + e.duration_ns() * 1e-9, e.name()))
        self.trace = DeviceTrace(self._t0, t1, ops)
