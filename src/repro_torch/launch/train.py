"""Training launcher: the data path always flows through data diffusion.

The port of the reference's ``repro.launch.train``, on the card:

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-3-4b
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-3-4b \\
      --reduced --device cpu --steps 2     # a small rehearsal on the CPU

Without ``--reduced`` it trains the arch's full config (h2o-danube-3-4b:
3.84 B parameters, 46 GB of bf16 weights and grads and fp32 AdamW moments,
fits one 80 GB card).  The weights are random, drawn on the device from
``--seed``.  ``--attn-impl flash`` (the default) runs every attention
forward through the hand-written CUDA kernel, and ``--mamba-kernel`` (the
default) every selective scan of a Mamba layer; each backward goes through
the plain version, as the reference's backward is the jnp VJP.
``--remat`` (default: the config's) picks how blocks are recomputed in the
backward: none, full, or dots (save the products without batch
dimensions).  falcon-mamba-7b at full width (7.27 B parameters, 87 GB of
state) fits no single card (``chip_smoke.py`` trains it cut to 32 of its
64 layers); its reduced form trains on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \\
      --reduced --device cpu --steps 2

It prints the reference's ``[train] done`` and ``[train] diffusion
ledger`` lines, then one line with the step time, tokens per second and
peak device memory, named with the device they ran on and the mixers of
the forward.
"""
from __future__ import annotations

import argparse
import statistics

import torch

from repro_torch.configs import get_config
from repro_torch.core.policies import DispatchPolicy
from repro_torch.data.dataset import ShardSpec
from repro_torch.data.pipeline import DiffusionDataPipeline, PipelineConfig
from repro_torch.device import describe, resolve_device
from repro_torch.launch.serve import mixers
from repro_torch.models.config import ModelConfig
from repro_torch.train.loop import TrainResult, train


def make_pipeline(cfg: ModelConfig, global_batch: int, seq_len: int,
                  hosts: int = 4, policy: str = "max-compute-util",
                  cache_mb: int = 64, shards: int = 16, seed: int = 0,
                  device: str | torch.device = "cuda"
                  ) -> DiffusionDataPipeline:
    """The reference launcher's pipeline: ``shards`` synthetic shards of
    max(one batch, 65,536) tokens, read through ``hosts`` executors whose
    caches hold ``cache_mb`` MiB each, on ``device``."""
    pipe_cfg = PipelineConfig(
        global_batch=global_batch, seq_len=seq_len, n_hosts=hosts,
        policy=DispatchPolicy(policy), host_cache_bytes=cache_mb << 20,
        seed=seed)
    spec = ShardSpec(
        n_shards=shards,
        tokens_per_shard=max(pipe_cfg.tokens_per_batch, 1 << 16),
        vocab_size=cfg.vocab_size, seed=seed)
    return DiffusionDataPipeline(pipe_cfg, spec, device=device)


def report(result: TrainResult, cfg: ModelConfig, global_batch: int,
           seq_len: int, device: torch.device,
           peak_bytes: int | None = None) -> list[str]:
    """The reference's two closing lines, then the times: the median step
    (the first, which builds and warms up, is left out where there are
    more), tokens per second at that step time, the peak device memory
    where it was read, and the token mixers ``cfg``'s forward ran."""
    lines = [
        f"[train] done: {result.steps_run} steps, "
        f"final loss {result.losses[-1]:.4f}" if result.losses
        else "no steps",
        f"[train] diffusion ledger: {result.pipeline_stats}",
    ]
    times = result.step_seconds[1:] or result.step_seconds
    if not times:
        return lines
    step_s = statistics.median(times)
    tokens = global_batch * (seq_len + 1)
    mem = ("" if peak_bytes is None else
           f", peak device memory {peak_bytes / 2**30:.3f} GiB")
    lines.append(f"[train] on {describe(device)}: {step_s * 1e3:.1f} ms per "
                 f"step (median of {len(times)}), {tokens / step_s:.0f} "
                 f"tokens/s at {global_batch} x {seq_len + 1} tokens a "
                 f"step{mem} ({mixers(cfg, device)} in the forward)")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced config (CPU-sized)")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--policy", default="max-compute-util")
    ap.add_argument("--cache-mb", type=int, default=64)
    ap.add_argument("--shards", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--attn-impl", default="flash",
                    choices=("flash", "blocked", "ref"),
                    help="attention of every forward (default flash: the "
                         "hand-written CUDA kernel on the card)")
    ap.add_argument("--mamba-kernel", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="selective scan of every Mamba forward: the "
                         "hand-written CUDA kernel on the card (default), "
                         "or the plain chunked path")
    ap.add_argument("--remat", default=None, choices=("none", "full", "dots"),
                    help="recompute blocks in the backward: none, full or "
                         "dots (default: the config's)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.with_(attn_impl=args.attn_impl,
                    use_mamba_kernel=args.mamba_kernel,
                    remat=args.remat or cfg.remat)
    pipeline = make_pipeline(cfg, args.global_batch, args.seq_len,
                             args.hosts, args.policy, args.cache_mb,
                             args.shards, args.seed, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        result = train(cfg, pipeline, args.steps, ckpt_dir=args.ckpt_dir,
                       seed=args.seed, device=dev)
    finally:
        pipeline.close()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    for line in report(result, cfg, args.global_batch, args.seq_len, dev,
                       peak):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
