"""ArchConfig: one dataclass describing every architecture in the zoo, plus
the input-shape registry (the four assigned LM shape cells).

A copy of ``repro/configs/base.py`` with ``jdtype`` replaced by ``tdtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


# the four LM shape cells (assigned set)
SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0         # 0 = full attention
    # MoE
    n_experts: int = 0
    moe_topk: int = 0
    moe_dense_residual: bool = False   # arctic: dense FFN in parallel
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    # enc-dec (whisper): encoder depth; n_layers is the decoder depth
    encoder_layers: int = 0
    frontend_dim: int = 0           # stub frontend input feature dim
    # vlm
    vis_tokens: int = 0
    vis_dim: int = 0
    # numerics
    dtype: str = "bfloat16"
    # pad the embedding/lm-head vocab dim up to a multiple of this
    # (logits masked above `vocab`); 0 = off
    pad_vocab_to: int = 256
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False
    # distribution hints
    fsdp: bool = False              # shard weights over 'data' too (ZeRO-3)
    # which shape cells this arch supports (None = all four)
    skip_shapes: Tuple[str, ...] = ()
    skip_reason: str = ""

    @property
    def hdim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        if not self.pad_vocab_to:
            return self.vocab
        return -(-self.vocab // self.pad_vocab_to) * self.pad_vocab_to

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def supports(self, shape_name: str) -> bool:
        return shape_name not in self.skip_shapes

    def scaled(self, **overrides) -> "ArchConfig":
        """A reduced copy for smoke tests (same family/features)."""
        return dataclasses.replace(self, **overrides)

    def smoke(self) -> "ArchConfig":
        """Tiny same-family config: runs a real fwd step on CPU."""
        small = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab=256,
            sliding_window=min(self.sliding_window, 32)
            if self.sliding_window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            moe_topk=min(self.moe_topk, 2) if self.moe_topk else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_dim=32 if self.frontend_dim else 0,
            vis_tokens=8 if self.vis_tokens else 0,
            vis_dim=32 if self.vis_dim else 0,
            dtype="float32",
        )
        return dataclasses.replace(self, **small)
