"""Open-loop arrival processes (when tasks *arrive*, not when slots free up).

The paper's microbenchmarks are closed-loop: a fixed batch is submitted at
t=0 and the system drains it.  The elasticity claim (§3.1 / the companion
paper arXiv 0808.3535) is about *open-loop* demand: tasks arrive on their
own clock regardless of system state, the wait queue grows when the pool is
too small, and the DynamicResourceProvisioner reacts.  Every process here is
a deterministic function of its seed: the same ``ArrivalProcess`` + seed
yields bit-identical arrival times, which is what makes trace record/replay
(trace.py) and the regression benchmarks reproducible.

Non-homogeneous processes (sine, bursty, diurnal) are sampled by Lewis &
Shedler thinning against ``max_rate``: propose exponential gaps at the peak
rate, accept a proposal at time t with probability rate(t)/max_rate.  Both
draws come from the same ``random.Random(seed)`` stream, so acceptance
history -- and therefore every arrival time -- is reproducible.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Iterator


class ArrivalProcess:
    """Base: a (possibly time-varying) rate function sampled by thinning."""

    #: subclasses must set the instantaneous-rate ceiling used for thinning
    max_rate: float = 1.0

    def rate(self, t: float) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def times(self, n: int, seed: int) -> Iterator[float]:
        """Yield ``n`` arrival times (non-decreasing), deterministic in seed."""
        if self.max_rate <= 0:
            raise ValueError(f"{type(self).__name__}: max_rate must be > 0")
        rng = random.Random(seed)
        t = 0.0
        emitted = 0
        while emitted < n:
            t += rng.expovariate(self.max_rate)
            if rng.random() * self.max_rate <= self.rate(t):
                yield t
                emitted += 1

    def spec(self) -> dict:
        """JSON-able description for the trace header."""
        d = {k: v for k, v in vars(self).items()
             if not k.startswith("_") and k != "max_rate"}
        d["kind"] = type(self).__name__
        return d


@dataclass(init=False)
class BatchArrivals(ArrivalProcess):
    """Every task arrives at ``at_s`` -- the closed-loop batch the repo's
    microbenchmarks used to hard-code via ``sim.submit(tasks)``."""

    at_s: float

    def __init__(self, at_s: float = 0.0) -> None:
        self.at_s = at_s
        self.max_rate = float("inf")

    def rate(self, t: float) -> float:
        return 0.0

    def times(self, n: int, seed: int) -> Iterator[float]:
        for _ in range(n):
            yield self.at_s


@dataclass(init=False)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson arrivals at ``rate_per_s``."""

    rate_per_s: float

    def __init__(self, rate_per_s: float) -> None:
        if rate_per_s <= 0:
            raise ValueError("rate_per_s must be > 0")
        self.rate_per_s = rate_per_s
        self.max_rate = rate_per_s

    def rate(self, t: float) -> float:
        return self.rate_per_s


@dataclass(init=False)
class SineWaveArrivals(ArrivalProcess):
    """The companion paper's sine-wave ramp (arXiv 0808.3535 §4): demand
    oscillates around ``mean_rate`` with the given amplitude and period, so
    a provisioned pool must grow on the upswing and release on the trough.

    rate(t) = mean_rate + amplitude * sin(2*pi*(t/period) + phase)
    (clamped at 0; amplitude may equal mean_rate for a full-depth trough).
    """

    mean_rate: float
    amplitude: float
    period_s: float
    phase: float

    def __init__(self, mean_rate: float, amplitude: float, period_s: float,
                 phase: float = 0.0) -> None:
        if mean_rate <= 0 or period_s <= 0:
            raise ValueError("mean_rate and period_s must be > 0")
        if not 0 <= amplitude <= mean_rate:
            raise ValueError("need 0 <= amplitude <= mean_rate "
                             "(rates must stay non-negative)")
        self.mean_rate = mean_rate
        self.amplitude = amplitude
        self.period_s = period_s
        self.phase = phase
        self.max_rate = mean_rate + amplitude

    def rate(self, t: float) -> float:
        return max(self.mean_rate + self.amplitude
                   * math.sin(2.0 * math.pi * t / self.period_s + self.phase),
                   0.0)


@dataclass(init=False)
class BurstyArrivals(ArrivalProcess):
    """Flash-crowd shape: a low base rate with periodic rectangular bursts
    (every ``burst_every_s`` seconds the rate jumps to ``burst_rate`` for
    ``burst_len_s``) -- the demand curve that punishes slow allocation
    policies and exercises the provisioner's exponential ramp."""

    base_rate: float
    burst_rate: float
    burst_every_s: float
    burst_len_s: float

    def __init__(self, base_rate: float, burst_rate: float,
                 burst_every_s: float, burst_len_s: float) -> None:
        if base_rate <= 0 or burst_rate < base_rate:
            raise ValueError("need 0 < base_rate <= burst_rate")
        if not 0 < burst_len_s <= burst_every_s:
            raise ValueError("need 0 < burst_len_s <= burst_every_s")
        self.base_rate = base_rate
        self.burst_rate = burst_rate
        self.burst_every_s = burst_every_s
        self.burst_len_s = burst_len_s
        self.max_rate = burst_rate

    def rate(self, t: float) -> float:
        return self.burst_rate if (t % self.burst_every_s) < self.burst_len_s \
            else self.base_rate


@dataclass(init=False)
class DiurnalArrivals(ArrivalProcess):
    """Day/night cycle: cosine between ``trough_rate`` (midnight, t=0) and
    ``peak_rate`` (mid-day).  ``day_s`` compresses the 24 h period into a
    tractable simulation horizon (e.g. day_s=240 squeezes a day into 4 min
    of simulated time)."""

    peak_rate: float
    trough_rate: float
    day_s: float

    def __init__(self, peak_rate: float, trough_rate: float,
                 day_s: float = 86_400.0) -> None:
        if not 0 <= trough_rate <= peak_rate or peak_rate <= 0:
            raise ValueError("need 0 <= trough_rate <= peak_rate, peak > 0")
        self.peak_rate = peak_rate
        self.trough_rate = trough_rate
        self.day_s = day_s
        self.max_rate = peak_rate

    def rate(self, t: float) -> float:
        mid = (self.peak_rate + self.trough_rate) / 2.0
        amp = (self.peak_rate - self.trough_rate) / 2.0
        # peak at mid-day (t = day_s/2), trough at t = 0
        return mid - amp * math.cos(2.0 * math.pi * t / self.day_s)


#: kind -> class, the registry the experiment spec binds by name
ARRIVALS: dict[str, type[ArrivalProcess]] = {
    cls.__name__: cls
    for cls in (BatchArrivals, PoissonArrivals, SineWaveArrivals,
                BurstyArrivals, DiurnalArrivals)
}
