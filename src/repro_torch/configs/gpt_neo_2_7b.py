"""GPT-Neo-2.7B: the paper's second evaluation model (§5, Fig 9).

32L d_model=2560 20H d_ff=10240 vocab=50257; gbs=2048 x seq 2048.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gpt-neo-2.7b", family="dense",
    n_layers=32, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=10240, vocab_size=50257, head_dim=128, ffn_act="gelu", tie_embeddings=True,
)
