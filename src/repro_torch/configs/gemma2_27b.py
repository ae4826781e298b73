"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 -- local+global alternating, logit softcap [arXiv:2408.00118].

Gemma2 specifics modeled: 1:1 local(4096-window):global alternation
(pattern period 2), attn logit softcap 50, final logit softcap 30,
(1+w) RMSNorm with pre+post norms, sqrt(d_model) embedding scale, gated
GELU.  head_dim 128 (q width 4096 != d_model 4608).  Global layers are
full attention => NOT sub-quadratic => long_500k is skipped (DESIGN.md §4)."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256_000,
    head_dim=128,
    pattern=(LayerSpec(kind="attn", attn="swa", mlp="dense"),
             LayerSpec(kind="attn", attn="full", mlp="dense")),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_act="gelu",
    gated_mlp=True,
    norm="rms",
    rms_plus_one=True,
    post_norms=True,
    embed_scale=True,
    rope_theta=1e4,
    tie_embeddings=True,
)
