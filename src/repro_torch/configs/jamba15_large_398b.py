"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 -- Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887].

Pattern period 8 = Jamba's 1:7 attention:mamba ratio (position 0 is the
attention layer); MoE replaces the dense MLP on every other layer
(positions 1,3,5,7 => 36 of 72 layers are MoE, matching Jamba's
every-2-layers placement).  ~398B total params; hybrid => the only
unbounded KV state is on the 9 attention layers => runs long_500k."""
from repro_torch.models.config import LayerSpec, ModelConfig

_PATTERN = tuple(
    LayerSpec(kind="attn" if i == 0 else "mamba",
              attn="full",
              mlp="moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    pattern=_PATTERN,
    n_experts=16,
    top_k=2,
    ssm_state=16,
    ssm_conv=4,
    ssm_chunk=512,
    ssm_expand=2,
    mlp_act="silu",
    gated_mlp=True,
    norm="rms",
    rope_theta=1e4,
    tie_embeddings=False,
    long_context=True,
)
