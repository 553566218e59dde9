"""serve_step / prefill_step factories (counterpart of the serving half of
``repro/train/step.py``). The model module holds its parameters, so the
steps take no params argument; the train step comes with the training
slice. The steps pass the model's cache through whatever its type
(``DecodeCache``, ``RwkvCache``, ``HymbaCache``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch


def make_serve_step(model) -> Callable:
    """serve_step(cache, tokens, pos) -> (next_tokens, logits, cache): one
    greedy decode step for the whole request batch. The cache is updated
    in place (the JAX version donates it)."""

    def serve_step(cache: Any, tokens: torch.Tensor, pos: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        logits, cache = model.decode_step(cache, tokens, pos)
        next_tokens = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        return next_tokens, logits, cache

    return serve_step


def make_prefill_step(model, cache_len: Optional[int] = None) -> Callable:
    """prefill_step(batch) -> (next_tokens (B,1) int32, cache).
    ``cache_len`` reserves ring slots for the decode steps; a model with an
    O(1) state (rwkv6) ignores it."""

    def prefill_step(batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Any]:
        logits, cache = model.prefill(batch, cache_len=cache_len)
        next_tokens = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        return next_tokens, cache

    return prefill_step
