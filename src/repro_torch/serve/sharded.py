"""The sharded serving step: ``make_prefill_step`` and ``make_serve_step``'s
flow on a ("data", "model") or ("pod", "data", "model") mesh under the
rules, the counterpart of JAX's serving steps jitted with the shardings
of ``tree_shardings`` (``repro/launch/dryrun.py::lower_cell``).

A serving rank holds
- every weight as its piece over the mesh axes the rules split it on
  (``place``, as JAX's serving steps take ``param_shardings``): the
  tensor-parallel leaves (``sharding.tp``, every family's attention,
  MLP, vocab and its own head blocks) as their pieces over 'model', the
  MoE experts as its E/M experts (``moe_ep``), every other split leaf
  gathered where the layer reads it;
- its rows of the batch, split over the batch axes where they divide;
- its slots of the KV cache: JAX's ``cache_seq`` -> 'model' splits the
  S_max-slot ring into M runs of S_max/M slots, every kv head
  (``transformer.SplitCache``; encdec's cross K/V too), and its heads of
  a recurrent state (rwkv6's, hymba's SSM), as ``heads`` -> 'model'
  splits them. The new token's k/v go to the rank that holds slot
  pos % S_max; each rank runs the split decode kernel over its slots
  for every head and the ranks merge their partials
  (``transformer.tp_decode_attention``).

Each layer runs on the rank's heads, d_ff columns and vocab rows, the
partial products summed over 'model'. The MoE FFN runs expert-parallel
at prefill (the all-to-all, where the sequence splits over 'model') and,
at a decode step, on each rank's E/M experts' rows of the dense dispatch,
summed over 'model' (JAX's fallback for S % M). The greedy token is the
best over the ranks' vocab columns (``transformer.tp_argmax``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import SplitCache, tp_argmax, tp_on
from repro_torch.sharding import collectives as col
from repro_torch.sharding.params import batch_axes, place
from repro_torch.sharding.partition import Rules, use_rules
from repro_torch.train.step import make_prefill_step, make_serve_step


class ShardedServing:
    """A model placed on ``mesh`` for serving. Every rank builds it from
    the same (initialised) parameters."""

    def __init__(self, model, mesh, rules: Rules):
        self.model, self.mesh, self.rules = model, mesh, rules
        self.batch = batch_axes(mesh, rules)
        self.plan = place(model, mesh, rules)
        self.tp = model.tp

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of x, where they divide over the batch axes."""
        n = col.axis_size(self.mesh, self.batch) if self.batch else 1
        if n == 1 or x.shape[0] % n:
            return x
        return col.chunk_dim(x, self.mesh, self.batch, 0)

    def _next(self, parts) -> torch.Tensor:
        """The greedy tokens of the last position's logits (the ranks'
        vocab columns)."""
        if self.model.vocab_tp():
            return tp_argmax(self.tp, [x[:, -1:] for x in parts]
                             ).to(torch.int32)
        return parts[0][:, -1:].argmax(dim=-1).to(torch.int32)

    def prefill(self, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Any]:
        """The rank's rows of the prompt -> (next tokens (B_l, 1) int32,
        the rank's cache)."""
        with use_rules(self.mesh, self.rules), torch.no_grad():
            if self.tp is None:
                return make_prefill_step(self.model, cache_len)(batch)
            parts, cache = self.model.prefill_parts(batch, cache_len)
            return self._next(parts), cache

    def decode(self, cache: Any, tokens: torch.Tensor, pos: int
               ) -> Tuple[torch.Tensor, Any, Any]:
        """One greedy step: (next tokens (B_l, 1) int32, the logits (each
        rank's vocab columns, a list, under tensor parallelism), the
        cache, updated in place)."""
        with use_rules(self.mesh, self.rules), torch.no_grad():
            if self.tp is None:
                return make_serve_step(self.model)(cache, tokens, pos)
            parts, cache = self.model.decode_split(cache, tokens, pos)
            return self._next(parts), parts, cache

    def logits(self, parts) -> torch.Tensor:
        """Whole logits from ``decode``'s (a gather over 'model')."""
        if not isinstance(parts, list):
            return parts
        return self.model.join(parts)

    def cache_specs(self, B: int, S_max: int) -> Any:
        """The rank's cache for B rows and an S_max-slot ring, on ``meta``
        (the dry run's input), as ``prefill`` lays it out: the ring's
        ``cache_seq`` dim split over 'model' where every ring divides by
        M, a state's ``heads`` dim the rank's heads."""
        full = self.model.cache_specs(B, S_max)
        if self.tp is None:
            return full
        model, M = self.model, self.tp.M
        axes = {f.name: tuple(getattr(model.cache_axes(), f.name))
                for f in dataclasses.fields(full)}
        seq = [getattr(full, f).shape[ax.index("cache_seq")]
               for f, ax in axes.items() if "cache_seq" in ax]
        split = bool(seq) and not any(n % M for n in seq)
        H = model.cfg.n_heads
        state = model.state_module()
        heads = (H // math.gcd(H, M) if state is not None and tp_on(state)
                 else H)
        out = {}
        for f, ax in axes.items():
            t = getattr(full, f)
            shape = list(t.shape)
            if split and ("cache_seq" in ax or f == "kpos"):
                i = ax.index("cache_seq") if "cache_seq" in ax else 0
                shape[i] //= M
            if "heads" in ax:
                shape[ax.index("heads")] = heads
            out[f] = torch.empty(shape, dtype=t.dtype, device="meta")
        part = type(full)(**out)
        return SplitCache([part for _ in self.tp.ranks],
                          S_max if split else 0)
