"""Synthetic tokenized shard store: the training-side persistent storage.

Immutable shards of tokenized documents (the FITS files of the training
world).  Shards are numpy arrays registered in a diffusion ObjectStore (a
host tensor each) so the pipeline's fetches flow through the paper's
cache/scheduling machinery and every byte is accounted local /
cache-to-cache / store.

A copy of the reference's ``repro.data.dataset``: the same seeded numpy
draws give the same tokens, so both packages train on the same data.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.objects import DataObject
from repro_torch.core.runtime import ObjectStore


@dataclass(frozen=True)
class ShardSpec:
    n_shards: int
    tokens_per_shard: int
    vocab_size: int
    seed: int = 0

    @property
    def shard_bytes(self) -> int:
        return self.tokens_per_shard * 4


def shard_oid(i: int) -> str:
    return f"shard{i:06d}"


def synthesize(spec: ShardSpec, store: ObjectStore) -> list[DataObject]:
    """Materialize immutable token shards into the store.

    Content is a seeded Zipf-ish sample so losses are non-trivial and
    runs are reproducible."""
    objs = []
    for i in range(spec.n_shards):
        rng = np.random.default_rng(spec.seed * 1_000_003 + i)
        # zipf-like marginal over the vocab, bounded
        z = rng.zipf(1.3, size=spec.tokens_per_shard)
        tokens = (z % (spec.vocab_size - 2)).astype(np.int32) + 2
        obj = DataObject(shard_oid(i), spec.shard_bytes)
        store.put(obj, tokens)
        objs.append(obj)
    return objs
