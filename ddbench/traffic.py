"""One traffic generator for every mix; a mix is a data file of parameters.

A mix (``ddbench/workloads/<traffic>.json``) names:

  loop        "closed": the whole trace is queued when the window opens,
              in one submit; "open": requests are due on a schedule of
              ``arrivals``
  locality    how many times each file is named (Table 2's L)
  files       closed loop: files per epoch (every file named ``locality``
              times, in an order shuffled from the seed)
  epochs      closed loop: the trace repeated over fresh file ids, so that
              a faster program cannot drain it inside the window
  arrivals    open loop: {"kind": "constant", "rate_per_s"} or
              {"kind": "sine", "mean_per_s", "amplitude_per_s", "period_s",
              "phase"}
  duration_s  open loop: how long the schedule runs; the files are
              ceil(requests / locality) over the whole schedule
  warmup      {"files", "requests"}: requests run before the window on
              file ids outside the trace, so the trace's files start cold

Arrival times are a pure function of the mix (the i-th request is due when
the cumulative rate reaches i + 1/2), so every seed offers the same work at
the same times; the seed only shuffles which file each request names.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

#: grid step (s) on which the cumulative rate is inverted
_GRID_S = 1e-4


@dataclass(frozen=True)
class Plan:
    """What one run offers: ``due`` (seconds after the window opens) and
    ``files`` (file id per request) for the trace, the ids of the warm-up
    requests, and how many files the catalog holds (trace and warm-up)."""

    loop: str
    due: np.ndarray
    files: np.ndarray
    warmup_files: np.ndarray
    n_files: int

    def __len__(self) -> int:
        return len(self.files)


def seed_words(seed: int) -> int:
    """Any whole number as the 64-bit word numpy's seeding takes."""
    return seed % (1 << 64)


def cumulative(arrivals: dict, t: np.ndarray) -> np.ndarray:
    """Requests due by each time in ``t`` under the arrival rate."""
    kind = arrivals["kind"]
    if kind == "constant":
        return arrivals["rate_per_s"] * t
    if kind == "sine":
        m, a = arrivals["mean_per_s"], arrivals["amplitude_per_s"]
        p, ph = arrivals["period_s"], arrivals.get("phase", 0.0)
        if not 0 <= a <= m:
            raise ValueError("a sine needs 0 <= amplitude <= mean")
        return m * t + a * p / (2 * math.pi) * (
            math.cos(ph) - np.cos(2 * math.pi * t / p + ph))
    raise ValueError(f"unknown arrival kind {kind!r}")


def arrival_times(arrivals: dict, duration_s: float) -> np.ndarray:
    """Due times in ``[0, duration_s)``: request i when the cumulative rate
    reaches ``i + 0.5``."""
    grid = np.arange(0.0, duration_s + _GRID_S, _GRID_S)
    cum = cumulative(arrivals, grid)
    n = int(math.floor(cum[-1] - 0.5)) + 1 if cum[-1] >= 0.5 else 0
    t = np.interp(np.arange(n) + 0.5, cum, grid)
    return t[t < duration_s]


def _shuffled(n_files: int, locality: int, rng) -> np.ndarray:
    seq = np.repeat(np.arange(n_files, dtype=np.int64), locality)
    rng.shuffle(seq)
    return seq


def plan(mix: dict, seed: int, seconds: float) -> Plan:
    """The requests one run offers under ``mix`` for a window of
    ``seconds`` (an open loop offers those due before the window closes)."""
    loc = int(mix["locality"])
    word = seed_words(seed)
    if mix["loop"] == "closed":
        per_epoch = int(mix["files"])
        files = np.concatenate([
            e * per_epoch + _shuffled(per_epoch, loc,
                                      np.random.default_rng([word, e]))
            for e in range(int(mix["epochs"]))])
        due = np.zeros(len(files))
        n_trace = per_epoch * int(mix["epochs"])
    elif mix["loop"] == "open":
        due = arrival_times(mix["arrivals"], float(mix["duration_s"]))
        n_trace = math.ceil(len(due) / loc)
        files = _shuffled(n_trace, loc,
                          np.random.default_rng([word, 0]))[:len(due)]
        keep = due < seconds
        due, files = due[keep], files[keep]
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    w = mix["warmup"]
    warm = n_trace + np.arange(int(w["requests"])) % int(w["files"])
    return Plan(mix["loop"], due, files, warm, n_trace + int(w["files"]))
