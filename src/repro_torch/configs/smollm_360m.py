"""smollm-360m [dense]: llama-arch small, GQA kv=5.

[hf:HuggingFaceTB/SmolLM-360M; hf]  32L d_model=960 15H (kv=5) d_ff=2560
vocab=49152.  15 query heads do not divide the 16-way model axis; the
sharding rules replicate attention across 'model' and shard the FFN
(2560/16=160) -- see DESIGN.md §4 and the §Perf head-padding experiment.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab_size=49152, head_dim=64,
    rope_theta=1e4, tie_embeddings=True,
)
