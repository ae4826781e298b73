"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B].

Every layer is MoE (no shared expert in the 30B-A3B release); d_ff=768 is
the per-expert intermediate size.  ~30.5B total / ~3.3B active params.
(Qwen3's q/k-norm is not modeled -- noted in DESIGN.md.)  Full attention
=> long_500k skipped."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151_936,
    head_dim=128,
    pattern=(LayerSpec(kind="attn", attn="full", mlp="moe"),),
    n_experts=128,
    top_k=8,
    mlp_act="silu",
    gated_mlp=True,
    norm="rms",
    rope_theta=1e6,
    tie_embeddings=False,
)
