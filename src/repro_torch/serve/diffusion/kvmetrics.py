"""KV-reuse economics out of a RunReport.

The report's per-input ledger already IS the KV ledger (engine.py's
mapping); this module only renames and ratios it.  Because every session
page is uniformly sized (``block * kv_bytes_per_token`` -- see
repro_torch.workloads.sessions), the reused-BYTES fraction equals the
reused-TOKEN fraction exactly, which is why `apps/serve_sessions.py`
can print "reused token fraction" straight from byte counters.

A copy of the reference's ``repro.serve.diffusion.kvmetrics``.
"""
from __future__ import annotations


def kv_summary(report) -> dict:
    """Serving headline numbers from any engine's RunReport (sim twin
    reports work too -- the ledger fields are schema-shared)."""
    b = report.bytes_by_kind
    local = float(b.get("local", 0.0))
    peer = float(b.get("c2c", 0.0))
    recomputed = float(b.get("store_read", 0.0))
    reused = local + peer
    total = reused + recomputed
    return {
        "reused_kv_bytes": reused,
        "local_kv_bytes": local,
        "peer_kv_bytes": peer,
        "recomputed_kv_bytes": recomputed,
        # uniform pages => byte fraction == token fraction
        "reused_token_fraction": reused / total if total else 0.0,
        "full_reuse_requests": report.full_hit_tasks,
        "partial_reuse_requests": report.partial_hit_tasks,
        "cold_requests": report.zero_hit_tasks,
        "n_requests": report.n_completed,
    }


def pool_trajectory(report, max_points: int = 16) -> list[tuple[float, int]]:
    """Replica-pool (t, live) samples, evenly thinned to ``max_points``
    (first and last always kept) -- the DRP grow/shrink story in one line."""
    log = [(float(t), int(n)) for t, n in report.pool_log]
    if len(log) <= max_points:
        return log
    step = (len(log) - 1) / (max_points - 1)
    idx = sorted({round(i * step) for i in range(max_points)})
    return [log[i] for i in idx]


def format_pool(report, max_points: int = 16) -> str:
    """Deterministic one-line rendering: ``t:live`` pairs, 1 decimal."""
    pts = pool_trajectory(report, max_points)
    if not pts:
        return "(fixed pool)"
    return " ".join(f"{t:.1f}s:{n}" for t, n in pts)
