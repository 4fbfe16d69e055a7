"""OPT-350M: the paper's primary evaluation model (§5, Figs 1,3,5-8,10-12).

24L d_model=1024 16H d_ff=4096 vocab=50272; trained with gbs=2048 seqs of
2048 tokens (paper §5 'Models').  Used by the planner/simulator benchmarks.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="opt-350m", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=50272, head_dim=64, ffn_act="gelu", tie_embeddings=True,
)
