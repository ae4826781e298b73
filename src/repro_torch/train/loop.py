"""Training loop: diffusion data pipeline + train step + checkpointing.

The port of the reference's ``repro.train.loop``, on the card:

  * restart-from-latest: the loop always resumes from the newest committed
    checkpoint -- kill the process at any step and rerun;
  * async checkpointing (no step blocks on IO);
  * the data pipeline's shard schedule is a pure function of the step, so
    a restarted run replays the exact same batches (bitwise-reproducible
    losses on the CPU);
  * pipeline host failures are handled by the diffusion runtime
    (re-dispatch + index invalidation), invisible here.

The modality frontends are stubs, as in the reference: the vision model
trains on a zero image and the encoder-decoder on zero frames
(:func:`train_batch`).  It logs the reference's ``[train]`` lines.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.data.pipeline import DiffusionDataPipeline
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models import init_params, make_train_step
from repro_torch.models.transformer import torch_dtype
from .checkpoint import CheckpointManager
from .optimizer import Optimizer, TrainState, adamw


@dataclass
class TrainResult:
    steps_run: int
    final_step: int
    losses: list[float] = field(default_factory=list)
    pipeline_stats: dict = field(default_factory=dict)
    resumed_from: Optional[int] = None
    #: host seconds of each step (batch wait excluded), ending in the
    #: read of its loss, which waits for the device
    step_seconds: list[float] = field(default_factory=list)
    #: the state after the last step (its tensors on the device)
    state: Optional[TrainState] = None


def train_batch(cfg: ModelConfig, tokens: torch.Tensor) -> dict:
    """The train step's batch for ``tokens`` (B, S) on their device: with
    the reference loop's frontend stubs, zero patch embeddings (B, T, D)
    for the vision model and zero frame embeddings (B, S, D) for the
    encoder-decoder, in ``cfg.dtype``."""
    batch = {"tokens": tokens}
    B, S = tokens.shape
    stub = dict(dtype=torch_dtype(cfg.dtype), device=tokens.device)
    if cfg.frontend == "vision":
        batch["image_embeds"] = torch.zeros(
            (B, cfg.num_frontend_tokens, cfg.d_model), **stub)
    if cfg.is_encdec:
        batch["frame_embeds"] = torch.zeros((B, S, cfg.d_model), **stub)
    return batch


def train(
    cfg: ModelConfig,
    pipeline: DiffusionDataPipeline,
    n_steps: int,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    optimizer: Optional[Optimizer] = None,
    seed: int = 0,
    log_every: int = 10,
    log: Callable[[str], None] = print,
    *,
    params: Optional[dict] = None,
    device: str | torch.device = "cuda",
) -> TrainResult:
    """Train ``cfg`` for ``n_steps`` on ``pipeline``'s batches.  The
    weights are drawn on ``device`` from ``seed``, or are ``params`` (e.g.
    the reference's, through ``convert.params_from_jax``)."""
    dev = resolve_device(device)
    opt = optimizer or adamw(3e-4, warmup=20, total=max(n_steps, 100))
    step_fn = make_train_step(cfg, opt)
    if params is None:
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    state = opt.init(params)
    mgr = CheckpointManager(ckpt_dir, async_save=True) if ckpt_dir else None
    start_step = 0
    resumed = None
    if mgr is not None:
        latest, restored = mgr.restore_latest(state)
        if latest is not None:
            state, start_step, resumed = restored, latest, latest
            log(f"[train] resumed from checkpoint step {latest}")

    losses: list[float] = []
    step_seconds: list[float] = []
    t0 = time.time()
    for step, tokens in pipeline.batches(start_step, n_steps - start_step):
        t_step = time.perf_counter()
        state, metrics = step_fn(state, train_batch(cfg, tokens.to(dev)))
        loss = float(metrics["loss"])
        step_seconds.append(time.perf_counter() - t_step)
        losses.append(loss)
        if (step + 1) % log_every == 0:
            dt = (time.time() - t0) / max(len(losses), 1)
            log(f"[train] step {step + 1}/{n_steps} loss={loss:.4f} "
                f"({dt * 1e3:.0f} ms/step) "
                f"store_hits_avoided={pipeline.ledger.global_hit_ratio:.2f}")
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, state)
    if mgr is not None:
        mgr.save(start_step + len(losses), state)
        mgr.wait()
    return TrainResult(steps_run=len(losses),
                       final_step=start_step + len(losses),
                       losses=losses, pipeline_stats=pipeline.stats(),
                       resumed_from=resumed, step_seconds=step_seconds,
                       state=state)
