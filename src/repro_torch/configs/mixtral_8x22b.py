"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, SWA [arXiv:2401.04088].

8 experts top-2 (~141B total / ~39B active), sliding-window attention per
the assignment (window 4096) => sub-quadratic => runs long_500k.  With 8
experts on a 16-way model axis, expert-parallel sharding does not divide;
the sharding rules fall back to TP over d_ff for this arch (DESIGN.md §5)."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    pattern=(LayerSpec(kind="attn", attn="swa", mlp="moe"),),
    window=4096,
    n_experts=8,
    top_k=2,
    mlp_act="silu",
    gated_mlp=True,
    norm="rms",
    rope_theta=1e6,
    tie_embeddings=False,
    long_context=True,
)
