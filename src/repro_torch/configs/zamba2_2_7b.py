"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared full-attention block.

[arXiv:2411.15242; hf]  54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  Simplification vs. the released model: one shared
attention+FFN block applied every 6 backbone layers (the paper's "shared
attn blocks"); LoRA projectors on the shared block are omitted.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, attn_every=6,
    rope_theta=1e4,
)
