"""Logical-axis sharding (MaxText-style) for DP/FSDP/TP/EP/SP.

The port of the reference's ``repro.parallel.sharding``, its pure logic
without JAX.  Every parameter and key activation carries a tuple of
*logical* axis names (``param_logical``, ``cache_logical``,
``batch_logical``, ``Optimizer.state_logical``).  A :class:`LogicalRules`
maps logical names to physical mesh axes.  A spec is a tuple with, per
dim, a mesh axis name, a tuple of names, or None (replicated), trailing
Nones dropped: the reference's ``PartitionSpec`` as a tuple.

The port runs on one card, so nothing is sharded: :func:`shard` and
:func:`shard_tree` return their input, and the rules only reckon what a
leaf's sharding would be on a described mesh (``parallel.mesh``).

Default layout (see DESIGN.md §5):
  batch    -> ("pod", "data")      data parallel across pods and hosts
  fsdp     -> ("pod", "data")      ZeRO-3 weight sharding on the largest
                                   non-TP dim of every stacked parameter
  tp       -> ("model",)           tensor parallel: heads / mlp / vocab
  expert   -> ("model",)           expert parallel (when E % model == 0)
  seq      -> ("model",)           sequence parallel for long-context
  (anything unmapped replicates)
"""
from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

Logical = tuple  # of str | None, one per dim
Spec = tuple     # of str | tuple[str, ...] | None, one per dim


@dataclass(frozen=True)
class LogicalRules:
    """logical axis name -> tuple of mesh axes (or () to replicate).  The
    mesh is read only for its ``axis_names`` and ``devices.shape``."""

    rules: dict[str, tuple[str, ...]] = field(default_factory=dict)
    mesh: Optional[Any] = None

    def spec_for(self, logical: Logical) -> Spec:
        phys: list = []
        used: set[str] = set()
        for name in logical:
            if name is None:
                phys.append(None)
                continue
            axes = tuple(a for a in self.rules.get(name, ()) if a not in used)
            used.update(axes)
            if len(axes) == 0:
                phys.append(None)
            elif len(axes) == 1:
                phys.append(axes[0])
            else:
                phys.append(axes)
        while phys and phys[-1] is None:
            phys.pop()
        return tuple(phys)

    def spec_for_shape(self, logical: Logical,
                       shape: tuple[int, ...]) -> Spec:
        """Shape-aware spec: an axis is claimed only if it both (a) is not
        already used by an earlier dim and (b) divides the dim.  Doing the
        dedup and the divisibility check TOGETHER matters: mixtral's
        8-expert dim must not consume the 16-way model axis it cannot use
        (that would leave d_ff unsharded).  This is the single source of
        truth for all shardings."""
        if self.mesh is None:
            return ()
        sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        phys: list = []
        used: set[str] = set()
        for i, name in enumerate(logical):
            if name is None or i >= len(shape):
                phys.append(None)
                continue
            kept: list[str] = []
            denom = 1
            for a in self.rules.get(name, ()):
                if a in used:
                    continue
                if shape[i] % (denom * sizes[a]) == 0:
                    kept.append(a)
                    used.add(a)
                    denom *= sizes[a]
            phys.append(tuple(kept) if len(kept) > 1
                        else (kept[0] if kept else None))
        while phys and phys[-1] is None:
            phys.pop()
        return tuple(phys)

    def sharding_for(self, logical: Logical) -> Optional[Spec]:
        """The spec of ``logical`` on the mesh, or None without one."""
        if self.mesh is None:
            return None
        return self.spec_for(logical)


def make_rules(
    mesh: Optional[Any] = None,
    *,
    fsdp: bool = True,
    expert_parallel: bool = True,
    sequence_parallel: bool = False,
    extra: Optional[dict[str, tuple[str, ...]]] = None,
) -> LogicalRules:
    """Build the default rule set for a mesh with axes from
    {("data","model") | ("pod","data","model")} (``parallel.mesh``
    describes these).  With mesh=None returns no-op rules."""
    if mesh is None:
        return LogicalRules({}, None)
    axes = mesh.axis_names
    dp: tuple[str, ...] = tuple(a for a in ("pod", "data") if a in axes)
    tp: tuple[str, ...] = ("model",) if "model" in axes else ()
    rules: dict[str, tuple[str, ...]] = {
        "batch": dp,
        "fsdp": dp if fsdp else (),
        "tp": tp,
        # "prefer TP, fall back to ZeRO": params whose natural shard dim is
        # the TP one (mamba's d_inner) still get sharded when tp is off
        "tp_fsdp": tp + (dp if fsdp else ()),
        "expert": tp if expert_parallel else (),
        "seq": tp if sequence_parallel else (),
        "kv_seq": tp if sequence_parallel else (),
    }
    if extra:
        rules.update(extra)
    return LogicalRules(rules, mesh)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def map_logical(fn: Callable, logical_tree, *trees):
    """``fn(logical, *leaves)`` over a tree of logical tuples (dicts,
    NamedTuples and tuples of them), with the leaves of ``trees`` at the
    same places."""
    if _is_logical(logical_tree):
        return fn(logical_tree, *trees)
    if isinstance(logical_tree, dict):
        return {k: map_logical(fn, v, *(t[k] for t in trees))
                for k, v in logical_tree.items()}
    if isinstance(logical_tree, tuple):
        out = [map_logical(fn, v, *(t[i] for t in trees))
               for i, v in enumerate(logical_tree)]
        return (type(logical_tree)(*out) if hasattr(logical_tree, "_fields")
                else tuple(out))
    raise TypeError(f"not a logical tree: {logical_tree!r}")


def logical_to_spec(rules: LogicalRules, logical_tree):
    """Map a tree of logical-axis tuples to specs."""
    return map_logical(rules.spec_for, logical_tree)


def named_shardings(rules: LogicalRules, logical_tree, abstract_tree):
    """The divisibility-guarded spec of every leaf of ``abstract_tree``
    (tensors, or anything with a ``shape``) on the rules' mesh.  On one
    card (no mesh) each leaf stays whole where it is, and the tree comes
    back unchanged."""
    if rules.mesh is None:
        return abstract_tree
    return map_logical(
        lambda lg, ab: rules.spec_for_shape(lg, tuple(ab.shape)),
        logical_tree, abstract_tree)


def shard_tree(tree, rules: Optional[LogicalRules], logical_tree):
    """The reference's per-leaf sharding constraint over a tree.  One card
    holds every leaf whole: the tree comes back unchanged."""
    return tree


def shard(x, rules: Optional[LogicalRules], *logical: Optional[str]):
    """The reference's sharding constraint on ``x``.  One card holds ``x``
    whole: it comes back unchanged."""
    return x


def takes_rules(fn: Callable) -> Callable:
    """Checks the ``rules`` argument of a model entry point on each call.
    The entry points take it at the reference's position, before
    arguments such as ``seq_chunk`` or ``image_embeds``; nothing reads it
    on one card, so a value passed in its place (``make_loss_fn(cfg,
    64)``) would otherwise be dropped without a word.  Anything but None
    or a :class:`LogicalRules` raises ``TypeError``."""
    at = list(inspect.signature(fn).parameters).index("rules")

    @functools.wraps(fn)
    def checked(*args, **kwargs):
        rules = args[at] if len(args) > at else kwargs.get("rules")
        if rules is not None and not isinstance(rules, LogicalRules):
            raise TypeError(f"{fn.__name__}: rules must be a LogicalRules "
                            f"or None, not {type(rules).__name__}")
        return fn(*args, **kwargs)
    return checked
