"""End-to-end serving example: batched requests, prefix-cache-aware routing.

The port of ``examples/serve_lm.py``: the same TINY model, flags and
printed lines, plus ``--device`` (default ``cuda``; ``cpu`` only when
asked).  It serves a small LM across logical replicas; requests share
prompt prefixes (the serving analogue of Table 2's locality), so the
data-aware router reuses prefix KV as the paper's scheduler reuses cached
files.  The routing lines equal the reference's for the same flags; the
``sample output:`` line does not, because each package draws its own
random weights (from a ``torch.Generator`` here).

  PYTHONPATH=src python -m repro_torch.apps.serve_lm --requests 24
  PYTHONPATH=src python -m repro_torch.apps.serve_lm --policy first-available
  PYTHONPATH=src python -m repro_torch.apps.serve_lm --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.policies import DispatchPolicy
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.serve import Request, ServeEngine

TINY = ModelConfig(name="serve-demo", family="dense", n_layers=4,
                   d_model=128, n_heads=8, n_kv_heads=4, d_ff=512,
                   vocab_size=4096, head_dim=16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--policy", default="max-compute-util")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    eng = ServeEngine(TINY, n_replicas=args.replicas,
                      policy=DispatchPolicy(args.policy), max_seq=96,
                      seed=args.seed, device=resolve_device(args.device))
    rng = np.random.default_rng(args.seed)
    bases = [list(rng.integers(2, TINY.vocab_size, 48)) for _ in range(3)]
    done = []
    for wave in range(0, args.requests, 8):
        reqs = []
        for i in range(wave, min(wave + 8, args.requests)):
            prompt = bases[i % 3] + list(rng.integers(2, TINY.vocab_size, 8))
            reqs.append(Request(rid=i, prompt=[int(t) for t in prompt],
                                max_new_tokens=args.max_new))
        done += eng.generate(reqs)
    total_prompt = sum(len(r.prompt) for r in done)
    print(f"served {len(done)} requests x {args.max_new} tokens on "
          f"{args.replicas} replicas, policy={args.policy}")
    print(f"  prompt tokens total:   {total_prompt}")
    print(f"  prefill computed:      {eng.prefill_tokens}")
    print(f"  reused from prefix KV: {eng.reused_tokens} "
          f"({eng.reused_tokens / max(total_prompt, 1):.1%})")
    print(f"  router: {eng.router.stats()}")
    print(f"  sample output: {done[0].output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
