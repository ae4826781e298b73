"""Prefix/KV cache objects for serving.

The paper's immutable-data assumption holds exactly for prefix caches:
a computed prefix KV is content-addressed by its token hash and never
mutated -- so the diffusion machinery (per-replica ExecutorCache with
Random/FIFO/LRU/LFU eviction + central location index) applies verbatim.

A copy of the reference's ``repro.serve.kvcache`` on the port's
``core.objects``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Sequence

from repro_torch.core.objects import DataObject


def prefix_oid(tokens: Sequence[int]) -> str:
    """Content address of a token prefix."""
    h = hashlib.sha1(bytes(str(tuple(tokens)), "utf8")).hexdigest()[:16]
    return f"prefix:{h}:{len(tokens)}"


def prefix_chain(tokens: Sequence[int], block: int = 64) -> list[str]:
    """oids for every block-aligned prefix of ``tokens`` (longest last)."""
    out = []
    for end in range(block, len(tokens) + 1, block):
        out.append(prefix_oid(tokens[:end]))
    return out


def kv_bytes_per_token(cfg) -> int:
    """KV-cache bytes per token for a ModelConfig (bf16)."""
    total = 0
    for spec in cfg.pattern:
        if spec.kind == "attn":
            total += 2 * cfg.n_kv_heads * cfg.head_dim_ * 2
    return total * cfg.n_blocks


@dataclass
class PrefixEntry:
    """A cached prefix: token ids + the packed KV payload."""
    oid: str
    tokens: tuple[int, ...]
    payload: Any           # model KV pytree (or None for accounting-only)
    size_bytes: int

    def as_object(self) -> DataObject:
        return DataObject(self.oid, self.size_bytes)
