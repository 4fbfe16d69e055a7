"""Model architecture configuration (copy of ``repro/models/config.py``).

One ``ModelConfig`` drives the port's model init/forward and the analytic
profiler.  The dataclass is kept field for field as the reference has it,
so the two packages read the same configs.  ``ShapeConfig``, ``SHAPES``
and ``get_shape`` are the reference's input-shape cells, which the dry
run (``launch/dryrun.py``) builds its stand-ins for.

Families:
  dense   - decoder-only transformer (GQA/MQA, RoPE, SwiGLU)
  moe     - dense + mixture-of-experts FFN (top-k, capacity dispatch)
  hybrid  - Mamba2 backbone with a shared full-attention block every k layers
  ssm     - pure Mamba2 (SSD), attention-free
  encdec  - encoder-decoder transformer (whisper-style; conv frontend stubbed)
  vlm     - decoder LM consuming stubbed vision patch embeddings + text
Every family is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False           # qwen-style
    ffn_act: str = "swiglu"          # swiglu | gelu | relu2 (non-gated: 2 mats)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "global"     # global | per_seq
    # --- sliding-window attention (0 = full attention) ---
    window: int = 0
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0               # N (d_state)
    ssm_headdim: int = 64            # P
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_chunk: int = 128             # SSD chunk length
    attn_every: int = 0              # hybrid: shared attn block period
    # --- encoder-decoder ---
    n_encoder_layers: int = 0
    n_frames: int = 1500             # encoder input length (stub frontend)
    # --- vision-language ---
    n_patches: int = 256             # stub ViT patch embeddings per image
    # --- numerics / training ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- distribution policy defaults (overridable by plan/launcher) ---
    sharding: str = "fsdp_tp"        # replicated | tp | fsdp_tp
    remat: str = "full"              # none | full | dots
    attn_impl: str = "auto"          # auto | naive | chunked | kernel
    logits_chunk: int = 0            # >0: CE loss in seq chunks
    attn_block_remat: bool = False   # checkpoint the chunked-attn kv scan

    # sub-quadratic attention available? (drives long_500k applicability)
    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.window > 0

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    # ---- parameter counting ---------------------------------------------------
    def attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        b = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + b

    def ffn_params(self) -> int:
        # SwiGLU: gate + up + down; non-gated acts: in + out
        mats = 3 if self.ffn_act == "swiglu" else 2
        return mats * self.d_model * self.d_ff

    def moe_layer_params(self) -> int:
        router = self.d_model * self.n_experts
        return router + self.n_experts * self.ffn_params()

    def ssm_layer_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_nheads
        in_proj = d * (2 * di + 2 * n + h)   # x, z, B, C, dt
        conv = 4 * (di + 2 * n)              # depthwise conv, k=4
        out = di * d
        extra = 2 * h + di                   # A_log, dt_bias, norm
        return in_proj + conv + out + extra

    def layer_params(self, layer_idx: int = 0) -> int:
        """Parameters of one decoder layer (norms included)."""
        norms = 2 * self.d_model
        if self.family == "ssm":
            return self.ssm_layer_params() + self.d_model
        if self.family == "hybrid":
            # backbone mamba2 layer; the shared attn block is counted once
            return self.ssm_layer_params() + self.d_model
        ffn = (self.moe_layer_params() if self.family == "moe"
               else self.ffn_params())
        return self.attn_params() + ffn + norms

    def shared_attn_params(self) -> int:
        if self.family != "hybrid":
            return 0
        return self.attn_params() + self.ffn_params() + 2 * self.d_model

    def embed_params(self) -> int:
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n *= 2  # separate lm head
        return n

    def encoder_params(self) -> int:
        if self.family != "encdec":
            return 0
        per = self.attn_params() + self.ffn_params() + 2 * self.d_model
        stem = (self.n_frames + self.d_model) * self.d_model  # pos + proj
        return self.n_encoder_layers * per + stem

    def cross_attn_params(self) -> int:
        if self.family != "encdec":
            return 0
        return self.n_layers * (self.attn_params() + self.d_model)

    def total_params(self) -> int:
        n = self.n_layers * self.layer_params()
        n += self.embed_params() + self.d_model  # final norm
        n += self.shared_attn_params()
        n += self.encoder_params() + self.cross_attn_params()
        return n

    def active_params(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.family != "moe":
            return self.total_params()
        per_layer_active = (self.attn_params() + 2 * self.d_model
                            + self.d_model * self.n_experts
                            + self.top_k * self.ffn_params())
        n = self.n_layers * per_layer_active
        n += self.embed_params() + self.d_model
        return n

    # ---- reduced config for CPU smoke tests -----------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config: few layers, small width, tiny vocab."""
        small = dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            window=min(self.window, 32) if self.window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            attn_every=2 if self.attn_every else 0,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            n_frames=16 if self.family == "encdec" else self.n_frames,
            n_patches=8 if self.family == "vlm" else self.n_patches,
            dtype="float32", param_dtype="float32",
            sharding="replicated", remat="none",
        )
        return small


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                  # train | prefill | decode
    seq_len: int
    global_batch: int
    # microbatches for gradient accumulation (train only); 0 -> auto
    num_microbatches: int = 0


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; known: {[s.name for s in SHAPES]}")
