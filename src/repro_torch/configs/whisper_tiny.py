"""whisper-tiny [audio]: encoder-decoder, conv frontend stubbed.

[arXiv:2212.04356; unverified]  4L (decoder) d_model=384 6H (kv=6)
d_ff=1536 vocab=51865; 4 encoder layers over 1500 precomputed frame
embeddings (the conv frontend is a STUB per the assignment:
``input_specs()`` provides frame embeddings directly).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
    n_encoder_layers=4, n_frames=1500,
    ffn_act="gelu", rope_theta=1e4, tie_embeddings=True,
)
