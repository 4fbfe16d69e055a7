"""internvl2-26b [vlm]: InternViT + InternLM2 backbone; frontend stubbed.

[arXiv:2404.16821; hf]  48L d_model=6144 48H (kv=8) d_ff=16384 vocab=92553.
The InternViT tower is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (n_patches x d_model) that are prepended to the
text token embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553, head_dim=128,
    n_patches=256,
    rope_theta=1e6,
)
