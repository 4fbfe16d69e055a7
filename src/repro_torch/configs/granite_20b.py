"""granite-20b [dense]: llama-arch code model with MQA (kv=1).

[arXiv:2405.04324; hf]  52L d_model=6144 48H (kv=1) d_ff=24576 vocab=49152.
kv=1 forces KV-head replication under 16-way TP (Megatron MQA practice).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128, ffn_act="gelu", tie_embeddings=True,
    rope_theta=1e4,
)
