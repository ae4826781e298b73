"""The port's location index timing and P-RLS model (paper §3.2.3, Figure
2) against the JAX package's: ``time_ops`` on both index classes, and
``prls_latency_model`` / ``prls_aggregate_throughput`` at the node counts
the paper's comparison reads.  No ``hypothesis`` needed."""
import pytest

from repro.core import index as jax_index
from repro_torch import core
from repro_torch.core import (LocationIndex, ShardedIndex,
                              prls_aggregate_throughput, prls_latency_model)

NODES = (1, 15, 1_000, 32_000, 1_000_000)


def _counts(ix) -> tuple[int, int, int]:
    return ix.n_inserts, ix.n_lookups, ix.n_removes


@pytest.mark.parametrize("make", [LocationIndex, lambda: ShardedIndex(4)],
                         ids=["central", "sharded4"])
def test_time_ops_times_and_leaves_the_index_empty(make):
    ix = make()
    ix.insert("keep", "e1")
    before = _counts(ix)
    n = 3_000
    t = ix.time_ops(n)
    assert set(t) == {"insert_s", "lookup_s"}
    assert t["insert_s"] > 0 and t["lookup_s"] > 0
    # n inserts, n lookups, n removes: 3n ops, the bench keys all gone
    after = _counts(ix)
    assert [a - b for a, b in zip(after, before)] == [n, n, n]
    assert sum(after) - sum(before) == 3 * n
    assert len(ix) == 1 and ix.lookup("keep") == frozenset({"e1"})
    assert ix.holdings("e0") == frozenset()


def test_time_ops_is_microseconds_scale():
    """The reference's bound (tests/test_index_and_policies.py): the
    central index's ops are µs-scale on the host."""
    t = LocationIndex().time_ops(50_000)
    assert t["insert_s"] < 25e-6
    assert t["lookup_s"] < 25e-6


def test_sharded_time_ops_keeps_the_counter_contract():
    """tests/test_incremental_structs.py's contract on the port: the
    sharded counters aggregate exactly as the central index's, and
    ``time_ops`` reports positive latencies."""
    si, li = ShardedIndex(n_shards=4), LocationIndex()
    for i in range(100):
        si.insert(f"o{i}", f"e{i % 3}")
        li.insert(f"o{i}", f"e{i % 3}")
    for i in range(50):
        si.lookup(f"o{i}")
        li.lookup(f"o{i}")
    for i in range(20):
        si.remove(f"o{i}", f"e{i % 3}")
        li.remove(f"o{i}", f"e{i % 3}")
    assert _counts(si) == _counts(li) == (100, 50, 20)
    t = si.time_ops(2000)
    assert t["insert_s"] > 0 and t["lookup_s"] > 0
    assert _counts(si) == (2100, 2050, 2020)


@pytest.mark.parametrize("nodes", NODES)
def test_prls_model_equals_the_reference(nodes):
    assert prls_latency_model(nodes) == jax_index.prls_latency_model(nodes)
    assert (prls_aggregate_throughput(nodes)
            == jax_index.prls_aggregate_throughput(nodes))


def test_prls_model_matches_paper_anchors():
    # ~0.5 ms at 1 node, ~3 ms at 15 nodes, ~15 ms at 1M nodes (§3.2.3)
    assert abs(prls_latency_model(1) - 0.5e-3) < 1e-4
    assert abs(prls_latency_model(15) - 2.5e-3) < 1e-3
    assert abs(prls_latency_model(1_000_000) - 15e-3) < 5e-3
    # paper: >32K P-RLS nodes needed to match ~4.18M lookups/s
    assert prls_aggregate_throughput(32_000) > 2e6
    # a node count below one is read as one, as in the reference
    assert prls_latency_model(0) == prls_latency_model(1) == 0.5e-3


def test_core_exports_the_prls_model_as_the_reference_does():
    from repro import core as jax_core

    for name in ("prls_latency_model", "prls_aggregate_throughput"):
        assert name in core.__all__ and name in jax_core.__all__
        assert getattr(core, name) is getattr(core.index, name)
