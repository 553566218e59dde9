"""train_step / serve_step / prefill_step factories (counterpart of
``repro/train/step.py``). The model module holds its parameters, so the
steps take no params argument: the train step updates them in place and
returns the optimizer state. The serving steps pass the model's cache
through whatever its type (``DecodeCache``, ``RwkvCache``,
``HymbaCache``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.train.compress import compress_decompress
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    n_micro: int = 1              # gradient-accumulation microbatches
    remat: bool = True
    compress_grads: bool = False  # int8 error-feedback (train/compress.py)


def make_train_step(model, tcfg: TrainConfig = TrainConfig()) -> Callable:
    """train_step(opt_state, batch) -> (opt_state, metrics): the gradient
    of ``model.loss`` w.r.t. every parameter, then AdamW, in place.

    With n_micro > 1 the batch's leading dim is split, each microbatch's
    gradient (in the param dtype) is added into f32 accumulators, and the
    sum and the loss are divided by n_micro, as the JAX step's scan does.
    With ``compress_grads`` the gradients take the int8 error-feedback
    round trip first, the residual kept in ``opt_state["ef"]``. Metrics:
    loss, grad_norm, lr (and tokens when n_micro == 1), as 0-dim tensors.
    """
    params = dict(model.named_parameters())

    def grads_of(mb: Dict[str, torch.Tensor]):
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss(mb, remat=tcfg.remat)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
        return loss.detach(), metrics, grads

    def train_step(opt_state: Dict[str, Any], batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        n = tcfg.n_micro
        if n == 1:
            loss, metrics, grads = grads_of(batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                     for name, p in params.items()}
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=next(iter(grads.values())).device)
            for i in range(n):
                mb = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
                      for k, x in batch.items()}
                loss_i, _, g = grads_of(mb)
                loss_sum += loss_i
                for name, acc in grads.items():
                    acc += g[name].float()
                del g
            loss = loss_sum / n
            for acc in grads.values():
                acc /= n
            metrics = {"loss": loss}
        if tcfg.compress_grads:
            grads, opt_state["ef"] = compress_decompress(
                grads, opt_state.get("ef"))
        opt_state, opt_metrics = adamw_update(tcfg.opt, grads, opt_state,
                                              params)
        del grads
        return opt_state, dict(metrics, **opt_metrics, loss=loss)

    return train_step


def init_train_state(model, generator: torch.Generator,
                     tcfg: TrainConfig = TrainConfig()) -> Dict[str, Any]:
    """Fill the model's params from ``generator`` and return a fresh
    optimizer state (with a zero error-feedback residual when
    ``compress_grads``)."""
    model.init_params(generator)
    params = dict(model.named_parameters())
    opt_state = adamw_init(params, tcfg.opt.state_dtype)
    if tcfg.compress_grads:
        opt_state["ef"] = {n: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                           for n, p in params.items()}
    return opt_state


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
