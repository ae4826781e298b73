"""Serving launcher: batched requests through prefix-cache-aware routing.

The port of the reference's ``repro.launch.serve``, on the card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-3-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
      --reduced --device cpu          # a small rehearsal on the CPU

It prints the reference's three ``[serve]`` lines, then one line with the
forward (prefill) and decode times, named with the device they ran on.
The weights are random, drawn on the device from ``--seed``.  As in the
reference, the encoder-decoder (whisper-base) is not served here: the
launcher prints the reference's line saying so and exits 0; and the
vision model (llava-next-mistral-7b) fails as the reference's does, with
a ``KeyError`` for ``image_embeds``, since the engine passes only tokens.
``--attn-impl flash`` (the default) runs the prefill forward's attention
through the hand-written CUDA kernel, which is what replaces the
reference's ``blocked`` attention on an accelerator; ``--mamba-kernel``
(the default) runs each Mamba layer's selective scan in the forward
through the hand-written CUDA scan kernel, which is what replaces the
reference's chunked plain scan on an accelerator (``--no-mamba-kernel``
selects the plain path, for comparison).  MoE layers route through the
port of the reference's capacity-bounded ``moe_block``; the times line
names their experts and top-k.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.policies import DispatchPolicy
from repro_torch.device import describe, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.serve import Request, ServeEngine

#: the reference launcher's traffic: waves of 8 requests, each prompt one of
#: 4 shared 32-token bases plus 8 random tokens, in a 96-token window
WAVE, N_BASES, BASE_LEN, TAIL_LEN, MAX_SEQ = 8, 4, 32, 8, 96


def make_requests(cfg: ModelConfig, n: int, max_new: int,
                  seed: int) -> list[Request]:
    """The reference launcher's requests, from the same numpy seed (so both
    packages serve the same prompts)."""
    rng = np.random.default_rng(seed)
    # shared prompt prefixes => prefix-cache locality (Table 2's "locality"
    # knob, serving edition)
    bases = [list(rng.integers(2, cfg.vocab_size, BASE_LEN))
             for _ in range(N_BASES)]
    reqs = []
    for i in range(n):
        base = bases[i % len(bases)]
        reqs.append(Request(rid=i, prompt=[int(t) for t in base + list(
            rng.integers(2, cfg.vocab_size, TAIL_LEN))],
            max_new_tokens=max_new))
    return reqs


def serve(cfg: ModelConfig, n_requests: int = 16, replicas: int = 2,
          policy: str = "max-compute-util", max_new: int = 8, seed: int = 0,
          device: str | torch.device = "cuda",
          params: Optional[dict] = None
          ) -> tuple[ServeEngine, list[Request]]:
    """Build the engine and serve the reference launcher's traffic in
    waves of 8."""
    eng = ServeEngine(cfg, n_replicas=replicas,
                      policy=DispatchPolicy(policy), max_seq=MAX_SEQ,
                      seed=seed, device=device, params=params)
    reqs = make_requests(cfg, n_requests, max_new, seed)
    done = []
    for i in range(0, len(reqs), WAVE):
        done += eng.generate(reqs[i: i + WAVE])
    return eng, done


def mixers(cfg: ModelConfig, device: torch.device) -> str:
    """What the forward ran: the attention impl; for Mamba layers the
    selective scan (the CUDA kernel on the card with ``use_mamba_kernel``,
    else the plain version); the MoE layer's experts."""
    out = []
    if any(s.kind == "attn" for s in cfg.pattern):
        out.append(f"attention {cfg.attn_impl}")
    if any(s.kind == "mamba" for s in cfg.pattern):
        ran_kernel = cfg.use_mamba_kernel and device.type == "cuda"
        out.append("selective scan "
                   + ("mamba_scan kernel" if ran_kernel else "plain"))
    if any(s.mlp == "moe" for s in cfg.pattern):
        out.append(f"MoE {cfg.n_experts} experts top-{cfg.top_k}")
    return ", ".join(out)


def report(eng: ServeEngine, done: list[Request], replicas: int,
           policy: str) -> list[str]:
    """The reference's three ``[serve]`` lines, then the times (with no
    wave served there are none to report, and the line says so)."""
    lines = [
        f"[serve] served {len(done)} requests on {replicas} replicas "
        f"({policy})",
        f"[serve] prefill tokens computed: {eng.prefill_tokens}, "
        f"reused from prefix caches: {eng.reused_tokens}",
        f"[serve] router: {eng.router.stats()}",
    ]
    ran = mixers(eng.cfg, eng.device)
    steps = sum(w.replay_steps + w.decode_steps for w in eng.waves)
    if not steps:
        lines.append(f"[serve] on {describe(eng.device)}: no wave served, "
                     f"so no forward or decode time ({ran} in the forward)")
        return lines
    fwd_ms = [w.forward_s * 1e3 for w in eng.waves]
    step_ms = sum(w.replay_s + w.decode_s for w in eng.waves) * 1e3 / steps
    lines.append(
        f"[serve] on {describe(eng.device)}: prefill forward "
        + ", ".join(f"{t:.2f}" for t in fwd_ms)
        + f" ms per wave of {WAVE} x {eng.max_seq} tokens; decode "
        f"{step_ms:.2f} ms per step ({steps} steps, {ran} in the forward)")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--policy", default="max-compute-util")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--attn-impl", default="flash",
                    choices=("flash", "blocked", "ref"),
                    help="attention of the prefill forward (default flash: "
                         "the hand-written CUDA kernel on the card)")
    ap.add_argument("--mamba-kernel", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="selective scan of the prefill forward's Mamba "
                         "layers: the hand-written CUDA kernel on the card "
                         "(default), or the plain chunked path")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encdec:
        print("[serve] enc-dec serving demo uses the decoder-only path of a "
              "dense arch; pick an LM arch for this driver")
        return 0
    cfg = cfg.with_(attn_impl=args.attn_impl,
                    use_mamba_kernel=args.mamba_kernel)
    eng, done = serve(cfg, args.requests, args.replicas, args.policy,
                      args.max_new, args.seed, resolve_device(args.device))
    for line in report(eng, done, args.replicas, args.policy):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
