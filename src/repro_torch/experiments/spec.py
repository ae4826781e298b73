"""Declarative experiment specs: one JSON document describes a whole run.

Counterpart of ``repro.experiments.spec`` for the two engines this package
has: the discrete-event simulator (``DiffusionSim``) and the threaded
runtime on the card (``DiffusionRuntime``).  The same spec runs unmodified
on both and yields reports with one schema.  :class:`ExperimentSpec` is a
frozen dataclass tree --

  cluster       testbed binding (by name), pool size, CPUs per node
  cache         capacity / eviction policy / enabled
  policy        dispatch policy (the paper's four, by value string)
  provisioner   DRP knobs, or None for a fixed pool
  workload      EITHER a generator binding (arrival-process + popularity
                specs, the same ``{"kind": ClassName, ...}`` dicts the
                trace header records) OR a JSONL ``trace_path`` OR a DAG
                binding OR a sessions binding
  seed          engine seed (cache RNGs, peer choice)
  observe       lifecycle-event recording and the telemetry plane
                (``repro_torch.obs``), off by default

-- with strict JSON round-tripping: ``from_dict(to_dict(s)) == s`` bit-for-
bit, and unknown fields hard-error at every nesting level (a half-applied
spec silently skews every number downstream of it).  Field names, defaults
and validation are the reference's; its four fleet fields (``hosts``,
``threads_per_host``, ``wire_batch``, ``local_dispatch``) are not part of
this spec (``repro_torch.convert.spec_from_json`` accepts them at their
defaults).

Alias map.  ``ALIASES`` documents, for every spec field, the engine-side
parameter it binds to, and ``DOCUMENTED_DIVERGENCES`` records where the raw
engine defaults disagree (the spec always passes explicit values, so the
divergence can never leak into a run).  :func:`check_alias_map` verifies
both tables against the live constructor signatures and hard-errors on
drift.
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
from repro_torch.core.provisioner import AllocationPolicy
from repro_torch.core.testbeds import TESTBEDS
from repro_torch.workloads import ARRIVALS, DAGS, POPULARITY, SESSIONS


# --------------------------------------------------------------------------
# spec tree
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ClusterSpec:
    """Pool shape + testbed binding (by registry name, so specs stay JSON)."""

    testbed: str = "anl_uc"
    n_nodes: int = 16          # initial pool (the provisioner grows from here)
    cpus_per_node: int = 1     # simulator only; runtime workers are 1-slot

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

    capacity_bytes: int = 50 * 10**9    # the spec-level default (see ALIASES)
    eviction: str = "lru"
    enabled: bool = True

    def __post_init__(self) -> None:
        if self.capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0")
        EvictionPolicy(self.eviction)   # raises on unknown value


@dataclass(frozen=True)
class ProvisionerSpec:
    """DynamicResourceProvisioner knobs (Falkon §3.1), field-for-field."""

    policy: str = "all-at-once"
    min_executors: int = 0
    max_executors: int = 64
    additive_k: int = 8
    queue_threshold: int = 1
    idle_timeout_s: float = 60.0
    trigger_cooldown_s: float = 1.0
    period_s: float = 1.0               # provisioner tick interval

    def __post_init__(self) -> None:
        AllocationPolicy(self.policy)   # raises on unknown value
        if not 0 <= self.min_executors <= self.max_executors:
            raise ValueError("need 0 <= min_executors <= max_executors")
        if self.period_s <= 0 or self.trigger_cooldown_s < 0:
            raise ValueError("period_s > 0 and trigger_cooldown_s >= 0")


@dataclass(frozen=True)
class WorkloadSpec:
    """Workload binding: a generator recipe, a DAG recipe, a session
    recipe, OR a recorded JSONL trace -- exactly one of the four.

    Generator binding uses the same ``{"kind": ClassName, ...ctor kwargs}``
    dicts that :meth:`ArrivalProcess.spec` / :meth:`PopularityModel.spec`
    emit into trace headers, so a trace header's spec block is itself a
    valid binding.  ``object_prefix`` names synthetic catalog objects
    ``{prefix}{i}`` (matching ``repro_torch.core.make_objects``); when None
    the generator's own ``{name}.o{i}`` scheme applies.

    ``dag`` binds a structured-pipeline recipe the same way:
    ``{"kind": "all_pairs" | "reduce_tree" | "stacking_pyramid",
    ...ctor kwargs}`` against the ``repro_torch.workloads.DAGS`` registry
    (a DAG Workload's own ``spec`` dict is itself a valid binding).  The flat
    generator knobs are meaningless for a DAG -- shape comes from the
    binding -- so non-default values hard-error rather than being dropped.

    ``sessions`` binds a multi-turn serving workload the same way:
    ``{"kind": "chat", ...SessionModel kwargs}`` against the
    ``repro_torch.workloads.SESSIONS`` registry (a session Workload's own
    ``spec`` dict is itself a valid binding).  Same dead-knob rule as
    trace/dag bindings.
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
    trace_path: Optional[str] = None
    dag: Optional[dict] = None
    sessions: Optional[dict] = None

    def __post_init__(self) -> None:
        generator = self.arrivals if self.arrivals is not None \
            else self.popularity
        n_bindings = sum(b is not None for b in (self.trace_path, self.dag,
                                                 self.sessions, generator))
        if n_bindings > 1:
            raise ValueError("workload binds EXACTLY ONE of trace_path, dag, "
                             "sessions, or a generator "
                             "(arrivals+popularity)")
        if (self.trace_path is not None or self.dag is not None
                or self.sessions is not None):
            # flat-generator knobs have no effect on a replayed trace, a
            # DAG recipe, or a session recipe; accepting them would
            # silently drop user intent (e.g. a seed "sweep" that replays
            # the identical trace, or an n_tasks that a DAG's own shape
            # parameters ignore)
            dead = [f.name for f in dataclasses.fields(self)
                    if f.name not in ("name", "trace_path", "dag", "sessions",
                                      "arrivals", "popularity")
                    and getattr(self, f.name) != f.default]
            if dead:
                which = ("trace-bound" if self.trace_path is not None
                         else "dag-bound" if self.dag is not None
                         else "sessions-bound")
                raise ValueError(
                    f"{which} workload: generator field(s) {dead} "
                    f"would be silently ignored (change them in the "
                    f"trace / the dag / the sessions binding instead)")
            if self.dag is not None and self.dag.get("kind") not in DAGS:
                raise ValueError(f"unknown dag kind "
                                 f"{self.dag.get('kind')!r} "
                                 f"(known: {sorted(DAGS)})")
            if self.sessions is not None \
                    and self.sessions.get("kind") not in SESSIONS:
                raise ValueError(f"unknown sessions kind "
                                 f"{self.sessions.get('kind')!r} "
                                 f"(known: {sorted(SESSIONS)})")
            return
        if self.arrivals is None or self.popularity is None:
            raise ValueError("workload needs a trace_path, a dag binding, a "
                             "sessions binding, or a generator binding "
                             "(arrivals AND popularity)")
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
class ObserveSpec:
    """Lifecycle-event recording (repro_torch.obs, DESIGN.md
    §10).  Off by
    default: the engines' hot paths carry only a None-check.  When on, the
    engine installs a bounded `Recorder` (drop-oldest ring of
    ``ring_capacity`` events) and, if ``sink_path`` is set, dumps the ring
    to JSONL after the run."""

    events: bool = False
    sink_path: Optional[str] = None
    ring_capacity: int = 65536
    # live telemetry plane (DESIGN.md §13): periodic registry sampling,
    # optional JSONL time-series sink, optional status endpoint port
    # (0 = pick a free port when metrics are on; the engine exposes the
    # bound address).  Same free-when-off stance as `events`.
    metrics: bool = False
    metrics_interval_s: float = 0.25
    metrics_sink_path: Optional[str] = None
    metrics_port: int = -1      # -1 = no endpoint; >= 0 = bind (0 = any)

    def __post_init__(self) -> None:
        if self.ring_capacity < 1:
            raise ValueError("ring_capacity must be >= 1")
        if self.sink_path is not None and not self.events:
            raise ValueError("observe.sink_path requires observe.events "
                             "(a sink with recording off would silently "
                             "write an empty trace)")
        if self.metrics_interval_s <= 0:
            raise ValueError("metrics_interval_s must be > 0")
        if self.metrics_sink_path is not None and not self.metrics:
            raise ValueError("observe.metrics_sink_path requires "
                             "observe.metrics (a sink with telemetry off "
                             "would silently write an empty series)")
        if self.metrics_port >= 0 and not self.metrics:
            raise ValueError("observe.metrics_port requires observe.metrics "
                             "(an endpoint with telemetry off would serve "
                             "nothing)")


@dataclass(frozen=True)
class ExperimentSpec:
    """The one declarative object either engine executes."""

    name: str
    workload: WorkloadSpec
    cluster: ClusterSpec = field(default_factory=ClusterSpec)
    cache: CacheSpec = field(default_factory=CacheSpec)
    policy: str = "max-compute-util"
    provisioner: Optional[ProvisionerSpec] = None
    seed: int = 0
    # engine-specific knobs (see ALIASES for which engine honours which;
    # the other engine hard-errors on a non-default value instead of
    # silently ignoring it)
    write_outputs_to: str = "local"         # sim: local | store | none
    index_update_interval_s: float = 0.0    # sim: 0 => synchronous
    index_update_batch: int = 1             # runtime: >1 => loose coherence
    release_policy: str = "discard"         # sim: discard | rebalance
    flow_solver: str = "incremental"        # sim: incremental | naive
    speculation_factor: float = 0.0         # sim: straggler twins
    # observability: lifecycle-event recording, engine-neutral
    observe: ObserveSpec = field(default_factory=ObserveSpec)

    def __post_init__(self) -> None:
        DispatchPolicy(self.policy)         # raises on unknown value
        if self.write_outputs_to not in ("local", "store", "none"):
            raise ValueError("write_outputs_to must be local|store|none")
        if self.release_policy not in ("discard", "rebalance"):
            raise ValueError("release_policy must be discard|rebalance")
        if self.flow_solver not in ("incremental", "naive"):
            raise ValueError("flow_solver must be incremental|naive")
        if self.index_update_batch < 1:
            raise ValueError("index_update_batch must be >= 1")

    # -- serialisation ------------------------------------------------------
    def to_dict(self) -> dict:
        """Plain JSON-able dict (recursive; ``provisioner`` may be None)."""
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
    (ExperimentSpec, "provisioner"): ProvisionerSpec,
    (ExperimentSpec, "observe"): ObserveSpec,
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


# --------------------------------------------------------------------------
# dotted-path overrides (the sweep runner's cell expansion)
# --------------------------------------------------------------------------

def with_overrides(spec: ExperimentSpec,
                   overrides: Mapping[str, object]) -> ExperimentSpec:
    """A copy of ``spec`` with dotted-path fields replaced, e.g.
    ``{"provisioner.policy": "exponential", "cache.capacity_bytes": 0}``.
    Paths traverse dataclass fields and dict keys (``workload.arrivals``
    replaces the whole arrival binding).  Validation re-runs on every
    replaced node, so an override that breaks an invariant hard-errors."""
    for p, v in overrides.items():
        segs = p.split(".")
        if not all(segs):
            raise ValueError(f"bad override path {p!r}")
        spec = _set_path(spec, p, segs, v)
    return spec


def _set_path(node, full_path: str, segs: list[str], value):
    head, rest = segs[0], segs[1:]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        if head not in {f.name for f in dataclasses.fields(node)}:
            raise ValueError(f"override path {full_path!r}: "
                             f"{type(node).__name__} has no field {head!r}")
        cur = getattr(node, head)
        sub = _SUBSPECS.get((type(node), head))
        if rest:
            if cur is None:
                raise ValueError(f"override path {full_path!r}: "
                                 f"{head!r} is None in the base spec")
            value = _set_path(cur, full_path, rest, value)
        elif sub is not None and isinstance(value, Mapping):
            # a dict assigned to a sub-spec field parses strictly (a raw
            # dict would skip validation and crash deep in an engine)
            value = _from_dict(sub, value, full_path)
        return dataclasses.replace(node, **{head: value})
    if isinstance(node, dict):
        if head not in node:
            # inserting a new key would silently typo-tolerate (the layer's
            # strictness stance); replace the whole dict to change its keys
            raise ValueError(f"override path {full_path!r}: "
                             f"dict has no key {head!r} "
                             f"(existing: {sorted(node)})")
        out = dict(node)
        out[head] = _set_path(node[head], full_path, rest, value) if rest \
            else value
        return out
    raise ValueError(f"override path {full_path!r}: cannot descend into "
                     f"{type(node).__name__}")


# --------------------------------------------------------------------------
# engine knob alias map (the documented SimConfig <-> DiffusionRuntime
# correspondence; drift-checked against the live signatures)
# --------------------------------------------------------------------------

#: spec path -> (SimConfig field, DiffusionRuntime.__init__ kwarg).  None on
#: one side = that engine has no such knob; a spec setting a non-default
#: value for it must hard-error on that engine (enforced by the engine
#: adapters), never be silently dropped.
ALIASES: dict[str, tuple[Optional[str], Optional[str]]] = {
    "cluster.n_nodes":         ("n_nodes", "n_executors"),
    "cluster.cpus_per_node":   ("cpus_per_node", None),
    "cache.capacity_bytes":    ("cache_capacity_bytes", "cache_capacity_bytes"),
    "cache.eviction":          ("cache_policy", "cache_policy"),
    "cache.enabled":           ("caching_enabled", None),
    "policy":                  ("policy", "policy"),
    "seed":                    ("seed", "seed"),
    "provisioner":             ("provisioner", None),
    "provisioner.period_s":    ("provisioner_period_s", None),
    "write_outputs_to":        ("write_outputs_to", None),
    "index_update_interval_s": ("index_update_interval_s", None),
    "index_update_batch":      (None, "index_update_batch"),
    "release_policy":          ("release_policy", None),
    "flow_solver":             ("flow_solver", None),
    "speculation_factor":      ("speculation_factor", None),
}

#: DiffusionRuntime ctor kwargs that deliberately have no spec field: the
#: persistent store is data, not a knob; the device is where a run happens,
#: not part of the experiment's identity (RuntimeEngine takes it); recorder
#: and metrics are the obs layer's injection points, built by the engine
#: adapters from ``spec.observe``.
RUNTIME_OPERATIONAL_KWARGS = frozenset({"store", "device", "recorder",
                                        "metrics"})

#: raw engine-side default disagreements the spec layer papers over by
#: always passing explicit values.  check_alias_map() verifies these are
#: exactly the divergences that exist: an engine default changing (or the
#: divergence disappearing) hard-errors until this table is updated.
DOCUMENTED_DIVERGENCES: dict[str, dict[str, object]] = {
    # sim was sized for the paper's 50 GB node caches; the in-process
    # runtime defaults to 1 GiB (its caches are device memory).
    "cache.capacity_bytes": {"sim": 50 * 10**9, "runtime": 1 << 30},
}

_MISSING = object()


def _sim_defaults() -> dict[str, object]:
    out = {}
    from repro_torch.core.simulator import SimConfig
    for f in dataclasses.fields(SimConfig):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:   # required, or a factory default: treat as no literal
            out[f.name] = _MISSING
    return out


def _ctor_defaults(cls) -> dict[str, object]:
    import inspect

    sig = inspect.signature(cls.__init__)
    return {n: (p.default if p.default is not inspect.Parameter.empty
                else _MISSING)
            for n, p in sig.parameters.items() if n != "self"}


def _runtime_defaults() -> dict[str, object]:
    from repro_torch.core.runtime import DiffusionRuntime
    return _ctor_defaults(DiffusionRuntime)


_alias_map_checked = False


def check_alias_map() -> None:
    """Verify ALIASES + DOCUMENTED_DIVERGENCES against the live engine
    signatures; raise RuntimeError on any drift.  Cheap, cached."""
    global _alias_map_checked
    if _alias_map_checked:
        return
    sim, rt = _sim_defaults(), _runtime_defaults()
    problems: list[str] = []
    for path, (sim_name, rt_name) in ALIASES.items():
        if sim_name is not None and sim_name not in sim:
            problems.append(f"{path}: SimConfig has no field {sim_name!r}")
        if rt_name is not None and rt_name not in rt:
            problems.append(f"{path}: DiffusionRuntime has no kwarg "
                            f"{rt_name!r}")
        if sim_name is None or rt_name is None:
            continue
        s_def, r_def = sim.get(sim_name, _MISSING), rt.get(rt_name, _MISSING)
        if s_def is _MISSING or r_def is _MISSING:
            continue   # required on one side: the spec always passes it
        diverges = s_def != r_def
        documented = path in DOCUMENTED_DIVERGENCES
        if diverges and not documented:
            problems.append(
                f"{path}: engine defaults silently differ "
                f"(sim {sim_name}={s_def!r} vs runtime {rt_name}={r_def!r}); "
                f"document it in DOCUMENTED_DIVERGENCES")
        elif diverges and documented:
            doc = DOCUMENTED_DIVERGENCES[path]
            if doc.get("sim") != s_def or doc.get("runtime") != r_def:
                problems.append(f"{path}: DOCUMENTED_DIVERGENCES is stale "
                                f"({doc} vs sim={s_def!r} runtime={r_def!r})")
        elif not diverges and documented:
            problems.append(f"{path}: documented divergence no longer "
                            f"exists; remove it from DOCUMENTED_DIVERGENCES")
    sim_covered = {s for s, _ in ALIASES.values() if s is not None}
    # testbed/executor_slowdown/fail_at are sim-only experiment machinery;
    # recorder and metrics are the obs layer's injection points on BOTH
    # engines, built by the engine adapters from spec.observe (not knobs a
    # spec aliases).
    missing = set(sim) - sim_covered - {"testbed", "executor_slowdown",
                                        "fail_at", "recorder", "metrics"}
    if missing:
        problems.append(f"SimConfig fields not covered by ALIASES: "
                        f"{sorted(missing)}")
    rt_covered = {r for _, r in ALIASES.values() if r is not None}
    missing_rt = set(rt) - rt_covered - RUNTIME_OPERATIONAL_KWARGS
    if missing_rt:
        problems.append(f"DiffusionRuntime kwargs not covered by ALIASES: "
                        f"{sorted(missing_rt)}")
    if problems:
        raise RuntimeError(
            "experiment spec layer out of sync with engine signatures:\n  "
            + "\n  ".join(problems))
    _alias_map_checked = True
