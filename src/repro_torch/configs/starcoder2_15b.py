"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 -- GQA, RoPE [arXiv:2402.19173; hf].

StarCoder2 uses LayerNorm and a plain (non-gated) GELU MLP with 4x
expansion; 15.4B params with untied embeddings."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    pattern=(LayerSpec(kind="attn", attn="full", mlp="dense"),),
    mlp_act="gelu",
    gated_mlp=False,
    norm="layer",
    rope_theta=1e5,
    tie_embeddings=False,
)
