"""End-to-end training example: an LM trained with the diffusion data
pipeline, checkpoint/restart, and the full training substrate, on the card.

The port of ``examples/train_lm.py``: the same presets, flags and printed
lines, plus ``--device`` (default ``cuda``; ``cpu`` only when asked).  Its
checkpoints go to a directory of its own, so it never resumes the
reference's.

  PYTHONPATH=src python -m repro_torch.apps.train_lm
  PYTHONPATH=src python -m repro_torch.apps.train_lm --preset 100m --steps 300
  PYTHONPATH=src python -m repro_torch.apps.train_lm --preset moe-30m
  PYTHONPATH=src python -m repro_torch.apps.train_lm --device cpu --steps 4
"""
from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch.core.policies import DispatchPolicy
from repro_torch.data.dataset import ShardSpec
from repro_torch.data.pipeline import DiffusionDataPipeline, PipelineConfig
from repro_torch.device import resolve_device
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.train import adamw, train

#: under the checkout's git-ignored build/, apart from the reference's
DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_lm_ckpt"

PRESETS = {
    "10m": ModelConfig(name="lm-10m", family="dense", n_layers=4,
                       d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                       vocab_size=8192, head_dim=32),
    "100m": ModelConfig(name="lm-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
                        vocab_size=32768, head_dim=64),
    "moe-30m": ModelConfig(name="lm-moe-30m", family="moe", n_layers=4,
                           d_model=256, n_heads=8, n_kv_heads=4, d_ff=512,
                           vocab_size=8192, head_dim=32,
                           pattern=(LayerSpec(mlp="moe"),),
                           n_experts=8, top_k=2),
}


#: the example's optimizer: AdamW to this peak after a linear warmup, then
#: cosine decay to the last step
PEAK_LR, WARMUP = 3e-4, 20


def make_pipeline(cfg: ModelConfig, global_batch: int, seq_len: int,
                  hosts: int, shards: int, seed: int,
                  device) -> DiffusionDataPipeline:
    """The example's pipeline: synthetic shards of at least 2^17 tokens,
    read through the diffusion runtime's ``hosts`` executors."""
    pipe_cfg = PipelineConfig(
        global_batch=global_batch, seq_len=seq_len, n_hosts=hosts,
        policy=DispatchPolicy.MAX_COMPUTE_UTIL, host_cache_bytes=1 << 28,
        seed=seed)
    spec = ShardSpec(n_shards=shards,
                     tokens_per_shard=max(pipe_cfg.tokens_per_batch, 1 << 17),
                     vocab_size=cfg.vocab_size, seed=seed)
    return DiffusionDataPipeline(pipe_cfg, spec, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--shards", type=int, default=12)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    n_params = cfg.param_count()
    print(f"training {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.global_batch}x{args.seq_len}")
    pipeline = make_pipeline(cfg, args.global_batch, args.seq_len,
                             args.hosts, args.shards, args.seed, dev)
    try:
        res = train(cfg, pipeline, n_steps=args.steps,
                    ckpt_dir=args.ckpt_dir, ckpt_every=25,
                    optimizer=adamw(PEAK_LR, warmup=WARMUP,
                                    total=args.steps),
                    seed=args.seed, device=dev)
    finally:
        pipeline.close()
    if res.losses:
        print(f"\nfinal loss: {res.losses[-1]:.4f} "
              f"(first: {res.losses[0]:.4f})")
    else:   # resumed at --steps: nothing left to run
        print(f"\nno step run: the checkpoint is at step {res.final_step}")
    print(f"resumed from checkpoint: {res.resumed_from}")
    print(f"diffusion pipeline ledger: {res.pipeline_stats}")
    print("rerun the same command to watch restart-from-checkpoint resume.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
