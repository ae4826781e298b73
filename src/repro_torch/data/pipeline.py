"""Diffusion-backed training input pipeline, on the card.

The paper's technique as a first-class training feature: dataset shards are
diffusable objects; per-step shard reads are dispatched by the Falkon-style
Dispatcher over host-worker executors with local caches.  Epoch N+1's
accesses hit the caches that epoch N populated -- the locality the paper
exploits (Figures 8-11) shows up here as store-byte reduction.

The port of the reference's ``repro.data.pipeline`` on the port's
``DiffusionRuntime``: the store holds the shards in host memory, and every
executor cache holds them as tensors on the runtime's device, so a fetched
shard comes back as a device tensor (a store read is one host-to-device
copy, a cache hit none) and the batch is sliced from it on the device.

Pipeline = DiffusionRuntime (real threaded engine) + prefetch queue:
  * ``shard_for_step`` maps step -> shard oid (seeded shuffle, repeats
    across epochs create the Table-2-style locality);
  * shard-read tasks resolve via local cache -> peer cache -> store;
  * fetched shards are sliced into (global_batch, seq_len+1) token blocks,
    at the start index the reference draws from the same numpy seed, so the
    batches are the reference's bit for bit;
  * a background thread keeps ``prefetch_depth`` batches ready, overlapping
    data movement with train-step compute (the paper's overlap discipline).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.cache import EvictionPolicy
from repro_torch.core.objects import Task
from repro_torch.core.policies import DispatchPolicy
from repro_torch.core.runtime import DiffusionRuntime, ObjectStore
from .dataset import ShardSpec, shard_oid, synthesize


@dataclass(frozen=True)
class PipelineConfig:
    global_batch: int
    seq_len: int
    n_hosts: int = 4
    policy: DispatchPolicy = DispatchPolicy.MAX_COMPUTE_UTIL
    cache_policy: EvictionPolicy = EvictionPolicy.LRU
    host_cache_bytes: int = 1 << 28
    prefetch_depth: int = 2
    seed: int = 0

    @property
    def tokens_per_batch(self) -> int:
        return self.global_batch * (self.seq_len + 1)


class DiffusionDataPipeline:
    """``device`` is the runtime's: where the executor caches, and so the
    batches, live (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: PipelineConfig, spec: ShardSpec,
                 store: Optional[ObjectStore] = None,
                 device: str | torch.device = "cuda") -> None:
        assert spec.tokens_per_shard >= cfg.tokens_per_batch, \
            "shard must cover a global batch"
        self.cfg = cfg
        self.spec = spec
        self.store = store if store is not None else ObjectStore()
        self.objs = synthesize(spec, self.store)
        self.rt = DiffusionRuntime(
            n_executors=cfg.n_hosts, policy=cfg.policy,
            cache_policy=cfg.cache_policy,
            cache_capacity_bytes=cfg.host_cache_bytes, store=self.store,
            seed=cfg.seed, device=device)
        self.rt.configure_caches(cfg.host_cache_bytes, cfg.cache_policy)
        self._q: "queue.Queue[tuple[int, torch.Tensor]]" = queue.Queue(
            maxsize=cfg.prefetch_depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- shard schedule -------------------------------------------------
    def shard_for_step(self, step: int) -> str:
        """Seeded shuffled epochs over shards: repeats across epochs give
        the workload its locality (the lever the paper's Figure 11 turns)."""
        n = self.spec.n_shards
        epoch, pos = divmod(step, n)
        rng = np.random.default_rng(self.cfg.seed * 7 + epoch)
        perm = rng.permutation(n)
        return shard_oid(int(perm[pos]))

    # -- batch materialization -------------------------------------------
    def _batch_from(self, tokens: torch.Tensor, step: int) -> torch.Tensor:
        need = self.cfg.tokens_per_batch
        rng = np.random.default_rng(self.cfg.seed * 13 + step)
        start = int(rng.integers(0, max(len(tokens) - need, 1)))
        flat = tokens[start:start + need]
        if len(flat) < need:  # wrap
            flat = torch.cat([flat, tokens[: need - len(flat)]])
        return flat.reshape(self.cfg.global_batch, self.cfg.seq_len + 1)

    def fetch_step(self, step: int) -> torch.Tensor:
        """Synchronous fetch of one global batch through diffusion: a
        (global_batch, seq_len+1) int32 tensor on the runtime's device."""
        oid = self.shard_for_step(step)
        task = Task(inputs=(oid,), fn=lambda inputs: next(iter(inputs.values())))
        self.rt.submit([task])
        assert self.rt.wait(120), "diffusion fetch timed out"
        if isinstance(task.result, Exception):
            raise task.result
        return self._batch_from(task.result, step)

    # -- prefetching iterator ----------------------------------------------
    def _producer(self, start_step: int, n_steps: int) -> None:
        try:
            for s in range(start_step, start_step + n_steps):
                if self._stop.is_set():
                    return
                self._q.put((s, self.fetch_step(s)))
        except BaseException as e:  # noqa: BLE001 - surface in the consumer
            # a dead producer must not leave batches() blocked on q.get()
            self._q.put((-1, e))

    def batches(self, start_step: int, n_steps: int
                ) -> Iterator[tuple[int, torch.Tensor]]:
        self._thread = threading.Thread(
            target=self._producer, args=(start_step, n_steps), daemon=True)
        self._thread.start()
        for _ in range(n_steps):
            step, b = self._q.get()
            if isinstance(b, BaseException):
                raise b
            yield step, b

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self.rt.shutdown()

    # -- the paper's metrics ----------------------------------------------
    @property
    def ledger(self):
        return self.rt.ledger

    def stats(self) -> dict:
        lg = self.rt.ledger
        return {
            "bytes_local": lg.bytes_local,
            "bytes_cache_to_cache": lg.bytes_c2c,
            "bytes_store": lg.bytes_store,
            "local_hit_ratio": lg.local_hit_ratio,
            "global_hit_ratio": lg.global_hit_ratio,
            "store_reads": lg.store_reads,
        }
