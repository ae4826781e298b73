"""Object-popularity models: *which* objects each arriving task reads.

Composable with any arrival process (arrivals.py) via workload.generate().
Each model deterministically maps (task index, seeded rng) -> input oids, so
a (model, seed) pair always produces the same access sequence.

  UniformScan        round-robin over the catalog -- the repo's historical
                     ``uniform_tasks`` microbenchmark shape: with
                     n_tasks = locality * n_objects every object is read
                     exactly ``locality`` times.
  ZipfPopularity     rank-skewed draws (web/cache-trace classic): object of
                     rank r drawn with probability ~ 1/r^alpha.
  ShiftingWorkingSet a hot window over the catalog that slides every
                     ``shift_every`` tasks -- defeats pure-LFU caching and
                     exercises eviction + re-diffusion.
  StackingTrace      the astronomy-stacking shape of §4.3/Table 2: each file
                     is read ``locality`` times total, interleaved in a
                     seeded shuffle (the paper's trace has no temporal
                     clustering by file).

Multi-input ("join") tasks.  The paper's stacking workload (§4.3) reads
*many* image files per request, and 0808.3535's data-aware dispatch argument
hinges on tasks whose input sets partially overlap executor caches.  Every
model therefore takes ``k`` (inputs per task, default 1) and -- where draws
are random -- a ``corr`` knob in [0, 1]:

  corr = 1   the k-1 extra inputs are the primary draw's *neighborhood*
             (Zipf / shifting working set: adjacent ranks; StackingTrace:
             the primary object's stack group of k files), so tasks reading
             nearby primaries share most of their inputs -- the §4.3
             stacked-read shape;
  corr = 0   the extras are independent draws from the same model -- joins
             with little overlap;
  between    each extra input is a neighborhood member with probability
             ``corr``, an independent draw otherwise.

Inputs within one task are always distinct (independent draws that collide
probe linearly to the next free object), and ``k`` is capped at the catalog
(or window) size.  With ``k == 1`` every model consumes *exactly* the same
rng draws as it did before ``k`` existed, so single-input workloads -- and
every committed v1 trace -- are bit-identical.
"""
from __future__ import annotations

import bisect
import itertools
import random
from dataclasses import dataclass


def _probe_distinct(idx: int, chosen: set[int], n: int) -> int:
    """Smallest (idx + j) % n not already chosen -- deterministic dedupe."""
    while idx in chosen:
        idx = (idx + 1) % n
    return idx


def _check_k_corr(k: int, corr: float) -> None:
    if k < 1:
        raise ValueError("k (inputs per task) must be >= 1")
    if not 0.0 <= corr <= 1.0:
        raise ValueError("corr must be in [0, 1]")


class PopularityModel:
    """Base: pick the input objects (by index into the catalog) per task."""

    def pick(self, i: int, rng: random.Random, n_objects: int) -> tuple[int, ...]:
        raise NotImplementedError  # pragma: no cover - abstract

    def spec(self) -> dict:
        d = {k: v for k, v in vars(self).items() if not k.startswith("_")}
        d["kind"] = type(self).__name__
        return d


@dataclass(init=False)
class UniformScan(PopularityModel):
    """Task i reads object (i * stride) % n -- a sequential (or strided)
    scan; locality L falls out of submitting L*n tasks.  With ``k > 1`` each
    task reads the k consecutive strided objects starting there (a sliding
    join window; no rng, so no ``corr`` knob)."""

    stride: int
    k: int

    def __init__(self, stride: int = 1, k: int = 1) -> None:
        if stride < 1:
            raise ValueError("stride must be >= 1")
        _check_k_corr(k, 0.0)
        self.stride = stride
        self.k = k

    def pick(self, i: int, rng: random.Random, n_objects: int) -> tuple[int, ...]:
        if self.k == 1:
            return ((i * self.stride) % n_objects,)
        # strided windows can collide when n divides a stride multiple
        # (e.g. stride=5, n=10): probe to keep the k inputs distinct
        out: list[int] = []
        chosen: set[int] = set()
        for j in range(min(self.k, n_objects)):
            cand = _probe_distinct(((i + j) * self.stride) % n_objects,
                                   chosen, n_objects)
            out.append(cand)
            chosen.add(cand)
        return tuple(out)


@dataclass(init=False)
class ZipfPopularity(PopularityModel):
    """Zipf(alpha) over object rank; rank r (1-based) has weight r^-alpha.
    Object index == rank-1, so low indices are hot.  Extra inputs (``k``)
    are the primary's rank neighborhood (corr) or independent Zipf draws."""

    alpha: float
    k: int
    corr: float

    def __init__(self, alpha: float = 1.0, k: int = 1, corr: float = 1.0) -> None:
        if alpha < 0:
            raise ValueError("alpha must be >= 0")
        _check_k_corr(k, corr)
        self.alpha = alpha
        self.k = k
        self.corr = corr
        self._cdf: list[float] = []
        self._cdf_n = -1

    def _ensure_cdf(self, n: int) -> None:
        if self._cdf_n == n:
            return
        weights = [1.0 / (r ** self.alpha) for r in range(1, n + 1)]
        total = sum(weights)
        acc, cdf = 0.0, []
        for w in weights:
            acc += w / total
            cdf.append(acc)
        cdf[-1] = 1.0
        self._cdf, self._cdf_n = cdf, n

    def _draw(self, rng: random.Random) -> int:
        return bisect.bisect_left(self._cdf, rng.random())

    def pick(self, i: int, rng: random.Random, n_objects: int) -> tuple[int, ...]:
        self._ensure_cdf(n_objects)
        base = self._draw(rng)
        if self.k == 1:
            return (base,)
        out = [base]
        chosen = {base}
        for j in range(1, min(self.k, n_objects)):
            if rng.random() < self.corr:
                cand = (base + j) % n_objects          # co-drawn neighborhood
            else:
                cand = self._draw(rng)                 # independent join leg
            cand = _probe_distinct(cand, chosen, n_objects)
            out.append(cand)
            chosen.add(cand)
        return tuple(out)


@dataclass(init=False)
class ShiftingWorkingSet(PopularityModel):
    """Uniform draws from a hot window of ``working_set`` objects that
    advances by ``shift_by`` every ``shift_every`` tasks (wrapping).  Extra
    inputs stay inside the window: the primary's in-window neighborhood
    (corr) or independent in-window draws."""

    working_set: int
    shift_every: int
    shift_by: int
    k: int
    corr: float

    def __init__(self, working_set: int, shift_every: int,
                 shift_by: int = 1, k: int = 1, corr: float = 1.0) -> None:
        if working_set < 1 or shift_every < 1 or shift_by < 0:
            raise ValueError("working_set/shift_every >= 1, shift_by >= 0")
        _check_k_corr(k, corr)
        self.working_set = working_set
        self.shift_every = shift_every
        self.shift_by = shift_by
        self.k = k
        self.corr = corr

    def pick(self, i: int, rng: random.Random, n_objects: int) -> tuple[int, ...]:
        base = (i // self.shift_every) * self.shift_by
        w = min(self.working_set, n_objects)
        first = rng.randrange(w)
        if self.k == 1:
            return ((base + first) % n_objects,)
        offsets = [first]
        chosen = {first}
        for j in range(1, min(self.k, w)):
            if rng.random() < self.corr:
                cand = (first + j) % w                 # in-window neighborhood
            else:
                cand = rng.randrange(w)                # independent in-window
            cand = _probe_distinct(cand, chosen, w)
            offsets.append(cand)
            chosen.add(cand)
        return tuple((base + o) % n_objects for o in offsets)


@dataclass(init=False)
class StackingTrace(PopularityModel):
    """§4.3 stacking-trace shape: every object is accessed exactly
    ``locality`` times and the full access list is shuffled once with
    ``shuffle_seed`` (temporal order uncorrelated with file id, as in the
    paper's SDSS trace).  Submitting more than locality*n tasks wraps the
    shuffled list.

    With ``k > 1`` the catalog is partitioned into per-object *stack groups*
    of k consecutive files (group(o) = o // k) and each task stacks its
    primary's whole group -- the paper's many-files-per-request reads.  Each
    non-primary group member is used with probability ``corr``, replaced by
    an independent uniform draw otherwise."""

    locality: int
    shuffle_seed: int
    k: int
    corr: float

    def __init__(self, locality: int, shuffle_seed: int = 0,
                 k: int = 1, corr: float = 1.0) -> None:
        if locality < 1:
            raise ValueError("locality must be >= 1")
        _check_k_corr(k, corr)
        self.locality = locality
        self.shuffle_seed = shuffle_seed
        self.k = k
        self.corr = corr
        self._order: list[int] = []
        self._order_n = -1

    def _ensure_order(self, n: int) -> None:
        if self._order_n == n:
            return
        order = list(itertools.chain.from_iterable(
            range(n) for _ in range(self.locality)))
        random.Random(self.shuffle_seed).shuffle(order)
        self._order, self._order_n = order, n

    def pick(self, i: int, rng: random.Random, n_objects: int) -> tuple[int, ...]:
        self._ensure_order(n_objects)
        primary = self._order[i % len(self._order)]
        if self.k == 1:
            return (primary,)
        group_base = (primary // self.k) * self.k
        out = [primary]
        chosen = {primary}
        for j in range(self.k):
            member = group_base + j
            if member == primary:
                continue
            if len(out) >= min(self.k, n_objects):
                break
            # a member past the catalog end (last partial stack group) is
            # replaced by an independent draw, like a corr miss, so tasks
            # keep their full width min(k, n)
            if member < n_objects and rng.random() < self.corr:
                cand = member                          # stack-group co-read
            else:
                cand = rng.randrange(n_objects)        # independent draw
            cand = _probe_distinct(cand, chosen, n_objects)
            out.append(cand)
            chosen.add(cand)
        return tuple(out)


#: kind -> class, the registry the experiment spec binds by name
POPULARITY: dict[str, type[PopularityModel]] = {
    cls.__name__: cls
    for cls in (UniformScan, ZipfPopularity, ShiftingWorkingSet, StackingTrace)
}
