"""ModelConfig: one schema covering all ten assigned architectures.

A model is a repeated *pattern* of layer specs (period P), scanned over
n_layers/P blocks -- this expresses plain stacks (P=1), gemma2's local:global
alternation (P=2) and jamba's 1-attn:7-mamba interleave with alternating
MoE (P=8) with a single code path, and keeps the traced HLO one-block-sized.

A copy of the reference's ``repro.models.config``, whole: the port runs the
same configurations, and its model loops over the ``n_blocks`` blocks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"        # attn | mamba
    attn: str = "full"        # full | swa   (when kind == attn)
    mlp: str = "dense"        # dense | moe | none


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: Optional[int] = None
    window: int = 0                   # swa window
    attn_softcap: float = 0.0         # gemma2: 50.0
    final_softcap: float = 0.0        # gemma2: 30.0
    mlp_act: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 10_000.0
    use_rope: bool = True
    norm: str = "rms"                 # rms | layer
    rms_plus_one: bool = False        # gemma (1 + w) scaling
    post_norms: bool = False          # gemma2 post-attn/post-mlp norms
    embed_scale: bool = False         # gemma multiplies embed by sqrt(D)
    tie_embeddings: bool = True
    qkv_bias: bool = False
    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- ssm (mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256              # seq chunk for the selective scan
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    # --- modality frontend (STUB: precomputed embeddings via input_specs) ---
    frontend: str = "none"            # none | vision | audio
    num_frontend_tokens: int = 0      # llava: 576 patch embeddings
    frontend_offset: int = 1          # splice position for vision tokens
    # learned-position table length (used when use_rope=False, e.g. whisper
    # decoder; sized to the largest assigned decode shape, see DESIGN.md)
    max_learned_pos: int = 0
    # explicit long_500k capability (assignment: run for SSM / hybrid /
    # window-bounded archs; skip pure full-attention archs).  Hybrids like
    # jamba qualify even though their few attn layers are full (state is
    # O(S) on 1/8 of layers, not O(S^2) compute per token).
    long_context: bool = False
    # --- numerics / perf knobs (the §Perf hillclimb turns these) ---
    dtype: str = "bfloat16"
    remat: str = "full"               # none | full | dots
    scan_unroll: int = 1
    attn_impl: str = "blocked"    # ref | blocked | flash(Pallas, TPU)
    use_mamba_kernel: bool = False

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % self.period == 0, \
            f"{self.name}: n_layers {self.n_layers} % pattern {self.period}"
        return self.n_layers // self.period

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)

    @property
    def subquadratic(self) -> bool:
        """True iff no layer needs an unbounded-length KV cache."""
        return all(
            s.kind == "mamba" or (s.attn == "swa" and self.window > 0)
            for s in self.pattern)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def kv_cache_len(self, spec: LayerSpec, seq_len: int) -> int:
        if spec.attn == "swa" and self.window > 0:
            return min(self.window, seq_len)
        return seq_len

    # -- parameter count (for MODEL_FLOPS = 6*N*D roofline term) -----------
    def param_count(self, active_only: bool = False) -> int:
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, dh = self.n_heads, self.n_kv_heads, self.head_dim_
        total = V * D  # embed
        if not self.tie_embeddings:
            total += V * D
        for spec in self.pattern:
            per = 0
            if spec.kind == "attn":
                per += D * (H + 2 * KV) * dh + H * dh * D
            else:
                I, N, R = self.d_inner, self.ssm_state, self.dt_rank
                per += D * 2 * I + self.ssm_conv * I + I * (R + 2 * N) \
                    + R * I + I * N + I + I * D
            if spec.mlp == "dense":
                per += D * F * (3 if self.gated_mlp else 2)
            elif spec.mlp == "moe":
                e = self.top_k if active_only else self.n_experts
                per += D * self.n_experts  # router (always live)
                per += e * D * F * (3 if self.gated_mlp else 2)
            total += per * self.n_blocks
        if self.enc_layers:
            per = D * (H + 2 * KV) * dh + H * dh * D  # enc self-attn
            per += D * F * (3 if self.gated_mlp else 2)
            total += per * self.enc_layers
            # decoder cross-attention adds another attn block per layer
            total += (D * (H + 2 * KV) * dh + H * dh * D) * self.n_layers
        return total

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=max(2 * self.period, self.period),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            window=min(self.window, 8) if self.window else 0,
            num_frontend_tokens=min(self.num_frontend_tokens, 4),
        )
        if self.n_experts:
            kw["n_experts"] = 4
            kw["top_k"] = min(self.top_k, 2)
        if self.ssm_state:
            kw["ssm_state"] = 4
        if self.enc_layers:
            kw["enc_layers"] = 2
        return self.with_(**kw)
