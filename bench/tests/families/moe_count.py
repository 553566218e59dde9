"""Operations of the ``moe`` family's layers, for the tests that add a
family as files: attention's projections and mixer as dense's, the router's
product, and the ``moe_topk`` experts a token is sent to (SwiGLU in, out)."""
from __future__ import annotations

from typing import Mapping

from bench.counts import dense
from bench.reference import head_dim


def layer_weights(c: Mapping) -> int:
    """Matrix elements one token meets in a layer."""
    d, H, G, D, f = (c["d_model"], c["n_heads"], c["n_kv_heads"], head_dim(c),
                     c["d_ff"])
    attention = d * (H + 2 * G) * D + H * D * d
    return attention + d * c["n_experts"] + c["moe_topk"] * 3 * d * f


def layers_flops(c: Mapping, B: int, S: int) -> float:
    L = c["n_layers"]
    return (2.0 * layer_weights(c) * B * S * L
            + dense.mixer_flops(c, S) * B * L)
