"""dbrx-132b [moe]: 16 experts top-4, fine-grained.

[hf:databricks/dbrx-base; unverified]  40L d_model=6144 48H (kv=8)
d_ff=10752 vocab=100352, MoE 16e top-4.  16 experts divide the 16-way model
axis exactly -> expert parallelism (EP) on 'model'.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352, head_dim=128,
    n_experts=16, top_k=4,
    rope_theta=5e5,
)
