"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 -- GQA, squared-ReLU [arXiv:2402.16819].

Nemotron-4: plain (non-gated) squared-ReLU MLP, LayerNorm, RoPE, untied
256k embeddings."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256_000,
    head_dim=128,
    pattern=(LayerSpec(kind="attn", attn="full", mlp="dense"),),
    mlp_act="relu2",
    gated_mlp=False,
    norm="layer",
    rope_theta=1e4,
    tie_embeddings=False,
)
