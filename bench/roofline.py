"""The benchmark's yardstick: the card's published peaks, and the operations
and bytes that a step's inputs need, counted from the configuration and the
shapes sent. Written for the benchmark and frozen with it: nothing here
reads the program.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit (a run prints the card's limit beside them).

Counting rules, the same whatever implements a step:
- a matrix product of (m, k) by (k, n) is 2 m k n operations;
- causal attention over S positions takes 2 H D S (S + 1) / 2 operations for
  the scores and as many for the weighted values (4 H D S (S + 1) / 2);
- training is three forward passes' operations (forward, and a backward of
  twice the forward), with no recompute counted;
- logits are counted where the work needs them: every position in training
  (the loss), the last position of a prompt (the next token); over the
  true vocabulary, not the padded one;
- a routed-expert layer counts the experts a token is sent to, never all
  of them;
- each input byte is read once and each output byte written once.

A family's layers are counted in ``counts/<family>.py``: its
``layers_flops(c, B, S)`` gives every layer's projections and mixer over B
sequences of S positions.
"""
from __future__ import annotations

from typing import Mapping, Tuple

from bench.cell import family_module

PEAK_FLOPS = 989e12      # bf16 dense, FLOP/s
PEAK_BYTES = 3.35e12     # HBM3, bytes/s
BF16 = 2                 # bytes an element as served


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def forward_flops(c: Mapping, B: int, S: int, logit_positions: int) -> float:
    """One forward pass over B sequences of S positions, logits at
    ``logit_positions`` positions of each."""
    layers = family_module("counts", c["family"]).layers_flops(c, B, S)
    logits = 2.0 * c["d_model"] * c["vocab"] * B * logit_positions
    return layers + logits


def train_flops(c: Mapping, B: int, S: int) -> float:
    """A training step's model operations: 3 forward passes, the loss's
    logits at every position, no recompute."""
    return 3.0 * forward_flops(c, B, S, S)


def prefill_flops(c: Mapping, B: int, S: int) -> float:
    """A prompt's prefill: every layer over S positions, the logits of the
    last position (the first token)."""
    return forward_flops(c, B, S, 1)


# ---------------------------------------------------- attention kernels --
def attn_fwd(B: int, S: int, H: int, G: int, D: int) -> Tuple[float, float]:
    """(operations, bytes) of one causal prefill attention call:
    q and o (B, S, H, D), k and v (B, S, G, D)."""
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    nbytes = BF16 * B * S * D * (2 * H + 2 * G)
    return flops, nbytes
