"""Declarative experiment specs: one JSON document describes a whole run.

Counterpart of ``repro.experiments.spec``, trimmed to what the threaded
runtime on the card executes.  :class:`ExperimentSpec` is a frozen
dataclass tree --

  cluster       testbed binding (by name), pool size, CPUs per node
  cache         capacity / eviction policy / enabled
  policy        dispatch policy (the paper's four, by value string)
  workload      EITHER a generator binding (arrival-process + popularity
                specs, ``{"kind": ClassName, ...}`` dicts) OR a DAG binding
  seed          engine seed (cache RNGs)

-- with strict JSON round-tripping: ``from_dict(to_dict(s)) == s`` bit-for-
bit, and unknown fields hard-error at every nesting level (a half-applied
spec silently skews every number downstream of it).  Field names and
defaults are the reference's; the reference's simulator, provisioner,
fleet and observability fields are not part of this spec
(``repro_torch.convert.spec_from_json`` accepts them at their defaults).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import IO, Mapping, Optional, Union

from repro_torch.core.cache import EvictionPolicy
from repro_torch.core.policies import DispatchPolicy
from repro_torch.core.testbeds import TESTBEDS
from repro_torch.workloads import ARRIVALS, DAGS, POPULARITY


# --------------------------------------------------------------------------
# spec tree
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ClusterSpec:
    """Pool shape + testbed binding (by registry name, so specs stay JSON)."""

    testbed: str = "anl_uc"
    n_nodes: int = 16
    cpus_per_node: int = 1     # runtime workers are 1-slot

    def __post_init__(self) -> None:
        if self.testbed not in TESTBEDS:
            raise ValueError(f"unknown testbed {self.testbed!r} "
                             f"(known: {sorted(TESTBEDS)})")
        if self.n_nodes < 0:
            raise ValueError("n_nodes must be >= 0")
        if self.cpus_per_node < 1:
            raise ValueError("cpus_per_node must be >= 1")


@dataclass(frozen=True)
class CacheSpec:
    """Per-executor cache shape.  ``enabled=False`` is the paper's
    data-unaware baseline (every byte from the persistent store)."""

    capacity_bytes: int = 50 * 10**9
    eviction: str = "lru"
    enabled: bool = True

    def __post_init__(self) -> None:
        if self.capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0")
        EvictionPolicy(self.eviction)   # raises on unknown value


@dataclass(frozen=True)
class WorkloadSpec:
    """Workload binding: a generator recipe OR a DAG recipe.

    Generator binding uses ``{"kind": ClassName, ...ctor kwargs}`` dicts
    against the ``ARRIVALS`` / ``POPULARITY`` registries.
    ``object_prefix`` names synthetic catalog objects ``{prefix}{i}``; when
    None the generator's own ``{name}.o{i}`` scheme applies.

    ``dag`` binds a structured-pipeline recipe the same way:
    ``{"kind": "all_pairs" | "reduce_tree" | "stacking_pyramid",
    ...ctor kwargs}`` against the ``DAGS`` registry.  The flat generator
    knobs are meaningless for a DAG -- shape comes from the binding -- so
    non-default values hard-error rather than being dropped.
    """

    name: str = "wl"
    arrivals: Optional[dict] = None
    popularity: Optional[dict] = None
    n_tasks: int = 0
    n_objects: int = 0
    object_bytes: int = 0
    object_prefix: Optional[str] = None
    compute_seconds: float = 0.0
    output_bytes: int = 0
    store_metadata_ops: int = 0
    seed: int = 0
    dag: Optional[dict] = None

    def __post_init__(self) -> None:
        generator = self.arrivals is not None or self.popularity is not None
        if self.dag is not None:
            if generator:
                raise ValueError("workload binds EXACTLY ONE of dag or a "
                                 "generator (arrivals+popularity)")
            dead = [f.name for f in dataclasses.fields(self)
                    if f.name not in ("name", "dag")
                    and getattr(self, f.name) != f.default]
            if dead:
                raise ValueError(
                    f"dag-bound workload: generator field(s) {dead} would be "
                    f"silently ignored (change them in the dag binding)")
            if self.dag.get("kind") not in DAGS:
                raise ValueError(f"unknown dag kind {self.dag.get('kind')!r} "
                                 f"(known: {sorted(DAGS)})")
            return
        if self.arrivals is None or self.popularity is None:
            raise ValueError("workload needs a dag binding or a generator "
                             "binding (arrivals AND popularity)")
        for label, d, registry in (("arrivals", self.arrivals, ARRIVALS),
                                   ("popularity", self.popularity, POPULARITY)):
            kind = d.get("kind")
            if kind not in registry:
                raise ValueError(f"unknown {label} kind {kind!r} "
                                 f"(known: {sorted(registry)})")
        if self.n_tasks <= 0:
            raise ValueError("generator workloads need n_tasks > 0")
        if self.n_objects <= 0:
            raise ValueError("generator workloads need n_objects > 0")


@dataclass(frozen=True)
class ExperimentSpec:
    """The one declarative object the runtime engine executes."""

    name: str
    workload: WorkloadSpec
    cluster: ClusterSpec = field(default_factory=ClusterSpec)
    cache: CacheSpec = field(default_factory=CacheSpec)
    policy: str = "max-compute-util"
    seed: int = 0
    index_update_batch: int = 1             # >1 => loose coherence

    def __post_init__(self) -> None:
        DispatchPolicy(self.policy)         # raises on unknown value
        if self.index_update_batch < 1:
            raise ValueError("index_update_batch must be >= 1")

    # -- serialisation ------------------------------------------------------
    def to_dict(self) -> dict:
        """Plain JSON-able dict (recursive)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "ExperimentSpec":
        """Strict inverse of :meth:`to_dict`: unknown fields hard-error."""
        return _from_dict(cls, d, path="spec")

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    def save(self, path: Union[str, Path]) -> None:
        Path(path).write_text(self.to_json() + "\n")

    @classmethod
    def load(cls, path: Union[str, Path, IO[str]]) -> "ExperimentSpec":
        if hasattr(path, "read"):
            return cls.from_json(path.read())
        return cls.from_json(Path(path).read_text())

    def fingerprint(self) -> str:
        """Stable short content hash (ties a RunReport to its spec)."""
        canon = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(canon.encode()).hexdigest()[:16]


#: nested dataclass types, by (owner, field name)
_SUBSPECS: dict[tuple[type, str], type] = {
    (ExperimentSpec, "workload"): WorkloadSpec,
    (ExperimentSpec, "cluster"): ClusterSpec,
    (ExperimentSpec, "cache"): CacheSpec,
}


def _from_dict(cls: type, d: Mapping, path: str):
    if not isinstance(d, Mapping):
        raise ValueError(f"{path}: expected a mapping, got {type(d).__name__}")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"{path}: unknown field(s) {unknown} "
                         f"(known: {sorted(names)})")
    required = {f.name for f in dataclasses.fields(cls)
                if f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING}  # type: ignore
    missing = sorted(required - set(d))
    if missing:
        raise ValueError(f"{path}: missing required field(s) {missing}")
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = _SUBSPECS.get((cls, f.name))
        if sub is not None and v is not None:
            v = _from_dict(sub, v, f"{path}.{f.name}")
        kw[f.name] = v
    return cls(**kw)
