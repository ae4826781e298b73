"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 -- llama+mistral mix, SWA [arXiv:2401.16818].

Llama-style gated-SiLU MLP + RMSNorm with mistral-style sliding-window
attention on every layer (window 4096) => sub-quadratic, runs long_500k."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    pattern=(LayerSpec(kind="attn", attn="swa", mlp="dense"),),
    window=4096,
    mlp_act="silu",
    gated_mlp=True,
    norm="rms",
    rope_theta=1e4,
    tie_embeddings=True,
    long_context=True,
)
