"""Structured DAG workload generators.

The classic generators (``workload.generate``) emit flat bags: every task is
runnable on arrival and reads only catalog objects.  The paper's flagship
applications are *pipelines* -- astronomy stacking feeds per-group stacks
into a mosaic, all-pairs feeds per-object feature extraction into N^2
comparisons -- where most reads target objects another task PRODUCED.  The
generators here emit those shapes as plain :class:`Workload` values: tasks
carry ``deps`` (producer tids) and inputs may name produced oids, so the
dispatcher's ready-set holds downstream tasks until their producers finish
and its producer-placement scoring can route them at the freshly written
outputs (DESIGN.md §11).

Three shapes, each a pure function of its arguments:

  all_pairs         N extract tasks (catalog object -> feature), then the
                    full N x N comparison grid: each pair task reads two
                    produced features and depends on both extracts.  The
                    canonical "does producer placement matter" workload --
                    every feature is read ~2N times.
  reduce_tree       N leaf tasks over the catalog, then ``fanin``-way
                    reduction levels over produced partials up to a single
                    root.  Deep chains; exercises transitive release (and
                    transitive dep-failure).
  stacking_pyramid  the astronomy §4.3 shape: ``n_groups`` stack tasks,
                    each folding ``group_size`` catalog images into one
                    produced stack, then ONE mosaic task reading every
                    stack.  Two levels, maximal fan-in at the top.

``DAGS`` registers them by kind for the experiment-spec binding
(``WorkloadSpec.dag = {"kind": ..., ...ctor kwargs}``), mirroring the
ARRIVALS / POPULARITY registries; :func:`build_dag` is the dispatch helper
``build_workload`` uses.

Arrivals: tasks arrive in topological generation order, ``dt`` seconds
apart (default 0.0 = everything arrives at t=0 and the ready-set alone
sequences the stages).  Dependents arriving before -- or with -- their
producers is the point: the dispatcher must hold them, not the generator.
"""
from __future__ import annotations

from repro_torch.core.objects import DataObject

from .workload import TaskEvent, Workload


def all_pairs(name: str = "ap", *, n_objects: int = 8,
              object_bytes: int = 10 * 1024**2,
              feature_bytes: int = 1024**2,
              extract_seconds: float = 0.05,
              pair_seconds: float = 0.01,
              dt: float = 0.0, seed: int = 0) -> Workload:
    """N extracts -> N x N pair comparisons over the produced features.

    Pair task (i, j) reads features f_i and f_j (the diagonal reads just
    f_i) and depends on both extracts, so no pair is runnable until its
    producers finish and every feature byte it reads was placed by the
    scheduler's own output admission.
    """
    if n_objects < 1:
        raise ValueError("all_pairs needs n_objects >= 1")
    objects = [DataObject(f"{name}.o{i}", object_bytes)
               for i in range(n_objects)]
    feat = [f"{name}.f{i}" for i in range(n_objects)]
    events: list[TaskEvent] = []
    t = 0.0
    for i in range(n_objects):
        events.append(TaskEvent(
            t=t, tid=f"{name}-ext{i}",
            inputs=(objects[i].oid,),
            outputs=((feat[i], feature_bytes),),
            compute_seconds=extract_seconds))
        t += dt
    for i in range(n_objects):
        for j in range(n_objects):
            inputs = (feat[i],) if i == j else (feat[i], feat[j])
            deps = (f"{name}-ext{i}",) if i == j \
                else (f"{name}-ext{i}", f"{name}-ext{j}")
            events.append(TaskEvent(
                t=t, tid=f"{name}-p{i}x{j}",
                inputs=inputs,
                compute_seconds=pair_seconds,
                deps=deps))
            t += dt
    spec = {"kind": "all_pairs", "name": name, "n_objects": n_objects,
            "object_bytes": object_bytes, "feature_bytes": feature_bytes,
            "extract_seconds": extract_seconds, "pair_seconds": pair_seconds,
            "dt": dt, "seed": seed}
    return Workload(name, objects, events, spec)


def reduce_tree(name: str = "rt", *, n_leaves: int = 8, fanin: int = 2,
                object_bytes: int = 10 * 1024**2,
                partial_bytes: int = 1024**2,
                leaf_seconds: float = 0.05,
                reduce_seconds: float = 0.02,
                dt: float = 0.0, seed: int = 0) -> Workload:
    """``fanin``-way reduction tree: N leaves over the catalog, then
    levels of reduce tasks over produced partials, down to one root."""
    if n_leaves < 1:
        raise ValueError("reduce_tree needs n_leaves >= 1")
    if fanin < 2:
        raise ValueError("reduce_tree needs fanin >= 2")
    objects = [DataObject(f"{name}.o{i}", object_bytes)
               for i in range(n_leaves)]
    events: list[TaskEvent] = []
    t = 0.0
    # level 0: leaves read the catalog, produce partials
    level: list[tuple[str, str]] = []          # (tid, produced oid)
    for i in range(n_leaves):
        tid, oid = f"{name}-l{i}", f"{name}.r0.{i}"
        events.append(TaskEvent(
            t=t, tid=tid, inputs=(objects[i].oid,),
            outputs=((oid, partial_bytes),),
            compute_seconds=leaf_seconds))
        level.append((tid, oid))
        t += dt
    depth = 1
    while len(level) > 1:
        nxt: list[tuple[str, str]] = []
        for k in range(0, len(level), fanin):
            children = level[k:k + fanin]
            tid, oid = f"{name}-r{depth}.{k // fanin}", \
                f"{name}.r{depth}.{k // fanin}"
            events.append(TaskEvent(
                t=t, tid=tid,
                inputs=tuple(o for _, o in children),
                outputs=((oid, partial_bytes),),
                compute_seconds=reduce_seconds,
                deps=tuple(c for c, _ in children)))
            nxt.append((tid, oid))
            t += dt
        level = nxt
        depth += 1
    spec = {"kind": "reduce_tree", "name": name, "n_leaves": n_leaves,
            "fanin": fanin, "object_bytes": object_bytes,
            "partial_bytes": partial_bytes, "leaf_seconds": leaf_seconds,
            "reduce_seconds": reduce_seconds, "dt": dt, "seed": seed}
    return Workload(name, objects, events, spec)


def stacking_pyramid(name: str = "sp", *, n_groups: int = 4,
                     group_size: int = 4,
                     object_bytes: int = 10 * 1024**2,
                     stack_bytes: int = 10 * 1024**2,
                     mosaic_bytes: int = 20 * 1024**2,
                     stack_seconds: float = 0.05,
                     mosaic_seconds: float = 0.1,
                     dt: float = 0.0, seed: int = 0) -> Workload:
    """Two-level astronomy shape: per-group stacks, then one mosaic that
    reads every produced stack (maximal fan-in at the top)."""
    if n_groups < 1 or group_size < 1:
        raise ValueError("stacking_pyramid needs n_groups, group_size >= 1")
    objects = [DataObject(f"{name}.g{g}.o{k}", object_bytes)
               for g in range(n_groups) for k in range(group_size)]
    events: list[TaskEvent] = []
    t = 0.0
    stacks: list[tuple[str, str]] = []
    for g in range(n_groups):
        tid, oid = f"{name}-stack{g}", f"{name}.stack{g}"
        events.append(TaskEvent(
            t=t, tid=tid,
            inputs=tuple(f"{name}.g{g}.o{k}" for k in range(group_size)),
            outputs=((oid, stack_bytes),),
            compute_seconds=stack_seconds))
        stacks.append((tid, oid))
        t += dt
    events.append(TaskEvent(
        t=t, tid=f"{name}-mosaic",
        inputs=tuple(o for _, o in stacks),
        outputs=((f"{name}.mosaic", mosaic_bytes),),
        compute_seconds=mosaic_seconds,
        deps=tuple(c for c, _ in stacks)))
    spec = {"kind": "stacking_pyramid", "name": name, "n_groups": n_groups,
            "group_size": group_size, "object_bytes": object_bytes,
            "stack_bytes": stack_bytes, "mosaic_bytes": mosaic_bytes,
            "stack_seconds": stack_seconds, "mosaic_seconds": mosaic_seconds,
            "dt": dt, "seed": seed}
    return Workload(name, objects, events, spec)


#: kind -> generator, mirroring ARRIVALS / POPULARITY: the binding dicts
#: ARE constructor kwargs (and each Workload.spec round-trips as a binding).
DAGS = {
    "all_pairs": all_pairs,
    "reduce_tree": reduce_tree,
    "stacking_pyramid": stacking_pyramid,
}


def build_dag(binding: dict, **overrides) -> Workload:
    """Materialise a ``{"kind": ..., ...kwargs}`` DAG binding (the
    experiment layer's ``WorkloadSpec.dag``).
    ``overrides`` win over the binding (the spec's name, typically)."""
    kind = binding.get("kind")
    if kind not in DAGS:
        raise ValueError(f"unknown dag kind {kind!r} (known: {sorted(DAGS)})")
    kw = {k: v for k, v in binding.items() if k != "kind"}
    kw.update(overrides)
    return DAGS[kind](**kw)
