"""The port's diffusion data pipeline against the reference's, on the CPU:
the same shards, the same shard schedule and bit-for-bit the same batches;
the second epoch served from the executor caches; a host lost mid-run
costs no batch."""
import numpy as np
import pytest
import torch

from repro.core.policies import DispatchPolicy as JDispatchPolicy
from repro.core.runtime import ObjectStore as JObjectStore
from repro.data.dataset import ShardSpec as JShardSpec
from repro.data.dataset import synthesize as jax_synthesize
from repro.data.pipeline import DiffusionDataPipeline as JPipeline
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro_torch.core.policies import DispatchPolicy
from repro_torch.core.runtime import ObjectStore
from repro_torch.data import (DiffusionDataPipeline, PipelineConfig,
                              ShardSpec, shard_oid, synthesize)

#: tests/test_pipeline_and_train.py's pipeline
CFG = dict(global_batch=4, seq_len=32, n_hosts=3, host_cache_bytes=1 << 24)
SPEC = dict(n_shards=4, tokens_per_shard=4096, vocab_size=256)


def _pair(seed=0, **over):
    cfg = dict(CFG, seed=seed, **over)
    spec = dict(SPEC, seed=seed)
    return (JPipeline(JPipelineConfig(
                policy=JDispatchPolicy.MAX_COMPUTE_UTIL, **cfg),
                JShardSpec(**spec)),
            DiffusionDataPipeline(
                PipelineConfig(policy=DispatchPolicy.MAX_COMPUTE_UTIL, **cfg),
                ShardSpec(**spec), device="cpu"))


def test_shards_are_the_reference_tokens():
    spec, jspec = ShardSpec(3, 1000, 300, seed=5), JShardSpec(3, 1000, 300, 5)
    store, jstore = ObjectStore(), JObjectStore()
    objs, jobjs = synthesize(spec, store), jax_synthesize(jspec, jstore)
    assert [(o.oid, o.size_bytes) for o in objs] == \
        [(o.oid, o.size_bytes) for o in jobjs]
    for o in objs:
        got = store.get(o.oid)[1]
        assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), jstore.get(o.oid)[1])
    assert shard_oid(12) == "shard000012"


@pytest.mark.parametrize("seed", [0, 3])
def test_batches_are_the_reference_batches(seed):
    """Steps 0-7 (two epochs over 4 shards): the same shard each step and
    bit for bit the same (global_batch, seq_len+1) int32 tokens."""
    jp, p = _pair(seed)
    try:
        assert [p.shard_for_step(s) for s in range(20)] == \
            [jp.shard_for_step(s) for s in range(20)]
        got = list(p.batches(0, 8))
        want = list(jp.batches(0, 8))
    finally:
        jp.close()
        p.close()
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(8))
    for (_, b), (_, jb) in zip(got, want):
        assert b.shape == (4, 33) and b.dtype == torch.int32
        assert b.device == torch.device("cpu")
        np.testing.assert_array_equal(b.numpy(), jb)


def test_batch_wraps_round_the_shard_as_the_reference():
    """A batch that covers the whole shard: the start index is the
    reference's and the slice wraps to the shard's start."""
    jp, p = _pair(seed=2, global_batch=4, seq_len=1023)
    try:
        for step in (0, 5):
            np.testing.assert_array_equal(p.fetch_step(step).numpy(),
                                          jp.fetch_step(step))
    finally:
        jp.close()
        p.close()


def test_second_epoch_hits_caches():
    """The paper's locality economics in the training pipeline: epoch 2
    re-reads come from executor caches, not the store; the ledger has the
    reference's six keys."""
    jp, p = _pair()
    try:
        for _ in p.batches(0, 8):      # 2 epochs over 4 shards
            pass
        s = p.stats()
    finally:
        jp.close()
        p.close()
    assert set(s) == set(jp.stats())
    assert s["store_reads"] <= 4 + 1          # ~one cold read per shard
    assert s["global_hit_ratio"] >= 0.4       # epoch 2 fully cached
    assert s["bytes_store"] >= 4 * ShardSpec(**SPEC).shard_bytes


def test_host_failure_mid_run_still_yields_every_batch():
    """Remove a pipeline host mid-run: training continues, no data lost,
    and the batches are still the reference's."""
    jp, p = _pair()
    try:
        got = []
        for i, (_, b) in enumerate(p.batches(0, 6)):
            got.append(b)
            if i == 1:
                p.rt.remove_executor("w0", failed=True)
        want = [b for _, b in jp.batches(0, 6)]
    finally:
        jp.close()
        p.close()
    assert len(got) == 6
    for b, jb in zip(got, want):
        np.testing.assert_array_equal(b.numpy(), jb)


def test_pipeline_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiffusionDataPipeline(PipelineConfig(**CFG), ShardSpec(**SPEC))
