"""mamba2-130m [ssm]: pure SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  24L d_model=768 vocab=50280, ssm_state=128,
d_inner=1536, headdim=64 (24 SSD heads).  No KV cache: decode carries a
constant-size recurrent state, so long_500k runs natively.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
    tie_embeddings=True,
)
