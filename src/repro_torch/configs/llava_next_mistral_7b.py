"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 -- anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B backbone (gated SiLU, RMSNorm, RoPE 1e6, full attention in the
v0.2 lineage).  The anyres vision frontend (CLIP ViT + tiling + projector)
is a STUB per the assignment: input_specs() supplies precomputed patch
embeddings (base grid 576 = 24x24 tokens) which forward_lm splices at
frontend_offset.  long_500k skipped (full attention)."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    pattern=(LayerSpec(kind="attn", attn="full", mlp="dense"),),
    mlp_act="silu",
    gated_mlp=True,
    norm="rms",
    rope_theta=1e6,
    tie_embeddings=False,
    frontend="vision",
    num_frontend_tokens=576,
    frontend_offset=1,
)
