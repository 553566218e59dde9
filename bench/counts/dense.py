"""Operations of a dense GQA layer (``bench.reference.dense``): the
projections q, k, v, o and the SwiGLU feed-forward's in and out, and causal
attention over the positions."""
from __future__ import annotations

from typing import Mapping

from bench.reference import head_dim


def layer_weights(c: Mapping) -> int:
    """Matrix elements of one dense GQA layer (q, k, v, o; SwiGLU in, out)."""
    d, H, G, D, f = (c["d_model"], c["n_heads"], c["n_kv_heads"], head_dim(c),
                     c["d_ff"])
    return d * (H + 2 * G) * D + H * D * d + d * 2 * f + f * d


def mixer_flops(c: Mapping, S: int) -> float:
    """Causal attention's operations for one sequence of S positions in one
    layer, beyond its projections."""
    return 4.0 * c["n_heads"] * head_dim(c) * S * (S + 1) / 2


def layers_flops(c: Mapping, B: int, S: int) -> float:
    """Every layer over B sequences of S positions."""
    L = c["n_layers"]
    return 2.0 * layer_weights(c) * B * S * L + mixer_flops(c, S) * B * L
