"""Regression lock: a Dispatcher twin must predict the router's choices.

``dispatcher_twin`` rebuilds a REAL `repro_torch.core.scheduler.Dispatcher`
from the router's observable state (replica order, busy counts, a fresh
copy of the location index, the page sizes) and submits the prompt as the
Task the session workload would emit.  Two independent reconstructions then have to
agree with the router:

  scores     the twin's brute-force ``Dispatcher.reference_scores()``
             (executor -> cached input bytes for the queued probe) must
             equal ``PrefixAwareRouter.reference_scores(prompt)`` entry
             for entry -- the satellite's literal lock;
  placement  ``decide()`` over the twin's reconstructed avail/busy/index
             must name the replica the router routes to.  decide() is the
             single-task reduction of the dispatcher's fifo path and of
             ``_dispatch_mcu``'s scoring (bytes desc, then overlap
             fraction -- vacuous for one prompt, see router.py -- then
             queue position).  NB `_dispatch_mcu` itself is executor-
             centric: with NO backlog it hands a lone task to the first
             free executor, because its matching is designed for the
             backlogged regime where each executor picks its best among
             many.  The router serves the task-centric regime, so the
             placement oracle is decide(), not a drained next_dispatches.

Any private drift in the router (stale index entries, size bookkeeping,
availability accounting) breaks one of the two comparisons.

A copy of the reference's ``repro.serve.diffusion.reference`` on the
port's Dispatcher, ``decide`` and router.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.objects import Task
from repro_torch.core.policies import decide
from repro_torch.core.scheduler import Dispatcher

from ..kvcache import prefix_chain
from ..router import PrefixAwareRouter, RouteResult


def dispatcher_twin(router: PrefixAwareRouter) -> Dispatcher:
    """A real Dispatcher mirroring the router's current observable state."""
    d = Dispatcher(router.policy)
    for rid in router._order:
        rep = router.replicas[rid]
        d.executor_joined(rid, now=0.0, slots=rep.slots)
        d.executors[rid].busy = rep.busy
    d.sizes.update(router.sizes)
    for oid in router.sizes:
        for rid in router.index.lookup(oid):
            d.index.insert(oid, rid)
    return d


def dispatcher_prediction(router: PrefixAwareRouter,
                          prompt: Sequence[int]) -> dict:
    """What the core stack says the router must do with ``prompt``."""
    d = dispatcher_twin(router)
    oids = prefix_chain(prompt, router.block)
    for oid in oids:
        d.sizes.setdefault(oid, router.page_bytes)
    probe = Task(inputs=tuple(oids))
    d.submit([probe], now=0.0)
    # brute-force scores for the queued probe (satellite lock target);
    # the incremental maps must already match them at this quiescent point
    ref = d.reference_scores()
    scores = {rid: ref.get(rid, {}).get(probe.tid, 0) for rid in router._order}
    avail = [r for r in router._order if d.executors[r].available]
    busy = [r for r in router._order if not d.executors[r].available]
    dec = decide(router.policy, probe, avail, busy, d.index, d.sizes)
    return {
        "target": dec.executor or dec.wait_for,   # None == unplaceable
        "scores": scores,
        # the incremental _exec_scores maps exist only under MCU; for the
        # fifo policies the brute force is the only scoring there is
        "incremental_consistent": (d.scores_match_reference()
                                   if d._mcu else True),
    }


def verify_route(router: PrefixAwareRouter, prompt: Sequence[int]) -> dict:
    """Predict, then actually route; report both agreements.  Mutates the
    router exactly like a normal ``route()`` call (the caller completes)."""
    pred = dispatcher_prediction(router, prompt)
    router_scores = router.reference_scores(prompt)
    res: RouteResult = router.route(prompt)
    return {
        "prediction": pred,
        "routed": res.replica,
        "route_result": res,
        # target None == every path saturated; the router's least-busy
        # fallback is then serving policy, not core-stack disagreement
        "placement_agrees": (pred["target"] is None
                             or res.replica == pred["target"]),
        "scores_agree": router_scores == pred["scores"],
    }
