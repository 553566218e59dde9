"""serve_step / prefill_step factories (counterpart of the serving half of
``repro/train/step.py``). The model module holds its parameters, so the
steps take no params argument; the train step comes with the training
slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import DecodeCache


def make_serve_step(model) -> Callable:
    """serve_step(cache, tokens, pos) -> (next_tokens, logits, cache): one
    greedy decode step for the whole request batch. The cache is updated
    in place (the JAX version donates it)."""

    def serve_step(cache: DecodeCache, tokens: torch.Tensor, pos: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, DecodeCache]:
        logits, cache = model.decode_step(cache, tokens, pos)
        next_tokens = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        return next_tokens, logits, cache

    return serve_step


def make_prefill_step(model, cache_len: Optional[int] = None) -> Callable:
    """prefill_step(batch) -> (next_tokens (B,1) int32, cache)."""

    def prefill_step(batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, DecodeCache]:
        logits, cache = model.prefill(batch, cache_len=cache_len)
        next_tokens = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        return next_tokens, cache

    return prefill_step
