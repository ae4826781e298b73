"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attn-free) d_ff=0 vocab=65024,
ssm_state=16 -- mamba1 arch [arXiv:2410.05355].

Pure Mamba-1 stack: no attention, no MLP (the mamba block IS the layer:
in_proj expand 2x -> conv1d(4) -> selective scan -> gated out_proj).
Attention-free => O(1) decode state => runs long_500k natively."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    pattern=(LayerSpec(kind="mamba", mlp="none"),),
    ssm_state=16,
    ssm_conv=4,
    ssm_chunk=512,
    ssm_expand=2,
    norm="rms",
    tie_embeddings=False,
    long_context=True,
)
