"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf]  56L d_model=6144 48H (kv=8) d_ff=16384 vocab=32768,
MoE 8e top-2, SWA window 4096.  SWA makes long_500k decode feasible
(rolling KV cache capped at the window).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    n_experts=8, top_k=2, window=4096,
    rope_theta=1e6,
)
