"""Gradient-carrying calls of the port's kernels.

The kernels write their outputs through raw pointers, so an output of
theirs has no ``grad_fn``. Each ``torch.autograd.Function`` here runs the
kernel in its forward. In its backward, flash attention runs its backward
kernels where the forward ran the tc kernel; elsewhere, and for the other
kernels (forward-only, as the Pallas kernels are), the backward recomputes
the same function through autograd of the plain version the JAX package
trains through:

- ``FlashAttentionFn``: on CUDA bf16 with Sq > 1
  (``flash_attention.backward_on_kernel``), the forward saves its output
  and each row's log-sum-exp and the backward runs ``attn_bwd_dq`` and
  ``attn_bwd_dkv`` (``flash_attention.flash_attention_backward``), the
  exact gradient of what the kernel computes. Elsewhere (the CPU, f32, f64,
  the dry run's meta tensors) ``models.common.attention_plain``, the plain
  function of the caller: the dispatch of JAX
  ``transformer.causal_attention`` (banded for a sliding window that tiles
  the sequence at least twice, else chunked with ``block_k = min(1024,
  max(S, 128))``), or, where the caller passes its ``block_k``,
  ``attention_chunked`` at that ``block_k``, as JAX's direct call sites
  (encdec, the moe and vlm prefills) train through;
- ``GlaScanFn``: ``kernels.gla_scan.gla_scan_ref``, the function the GLA
  kernel computes (``gla_chunked`` in chunks of 32, ``shifted_prev``).

``PlainSpanFn`` wraps a plain function the same way, without a kernel: the
MoE dispatch and combine (``models.moe``) go through it, so that the
device time of their scatter and gather backwards has a span of its own.

``kernels.ops`` routes through the kernels' Functions when grad mode is on
and an input requires grad; the raw wrappers raise on such inputs
(``refuse_grad``). The wrappers import this module, so it imports them
where it calls them. Each backward runs inside the profiler range named
in ``BACKWARD_SPANS`` (``spans.span``: only while a profiler collects),
so a profile can tell its device time apart.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch import spans
from repro_torch.models import common as cm

#: kernel -> the range name of its backward
BACKWARD_SPANS = {k: f"{spans.PREFIX}{k}_backward"
                  for k in ("flash_attention", "gla_scan", "moe_dispatch")}


def _recompute_grads(fn, inputs: Sequence[Optional[torch.Tensor]],
                     needs: Sequence[bool], outs_grads) -> Tuple:
    """Rerun ``fn(*inputs)`` under autograd and return the gradients of
    its outputs (paired with ``outs_grads``, a None grad skips its output)
    w.r.t. each input that ``needs`` one, None for the others."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(inputs, needs)]
        outs = fn(*leaves)
    pairs = [(o, g) for o, g in zip(outs, outs_grads) if g is not None]
    wrt = [t for t in leaves if t is not None and t.requires_grad]
    if not pairs or not wrt:
        return (None,) * len(inputs)
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                   [g for _, g in pairs], allow_unused=True))
    return tuple(next(got) if t is not None and t.requires_grad else None
                 for t in leaves)


class FlashAttentionFn(torch.autograd.Function):
    """q (B,Sq,H,D), k/v (B,Sk,G,D), contiguous; int32 positions or None.
    ``self_attention`` says that qpos and kpos are the same positions, the
    condition of the banded plain backward; ``block_k`` (or None) is the
    caller's, passed on to ``attention_plain``. Each backward counts in
    ``flash_attention_backward.launches`` (the kernels) or its
    ``plain_calls``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int,
                qpos: Optional[torch.Tensor], kpos: Optional[torch.Tensor],
                self_attention: bool, block_k: Optional[int] = None):
        ctx.set_materialize_grads(False)
        ctx.causal, ctx.window, ctx.self_attention = (causal, window,
                                                      self_attention)
        ctx.block_k = block_k
        from repro_torch.kernels import flash_attention as _fa
        kw = dict(causal=causal, window=window, qpos=qpos, kpos=kpos)
        if _fa.backward_on_kernel(q):
            o, lse = _fa.flash_attention_fwd_lse(q, k, v, **kw)
            ctx.save_for_backward(q, k, v, qpos, kpos, o, lse)
            return o
        ctx.save_for_backward(q, k, v, qpos, kpos)
        return _fa.flash_attention(q, k, v, **kw)

    @staticmethod
    def backward(ctx, do):
        if do is None:
            return (None,) * 9
        from repro_torch.kernels import flash_attention as _fa
        q, k, v, qpos, kpos, *kernel = ctx.saved_tensors

        def plain(q, k, v):
            return (cm.attention_plain(
                q, k, v, causal=ctx.causal, window=ctx.window, qpos=qpos,
                kpos=kpos, self_attention=ctx.self_attention,
                block_k=ctx.block_k),)

        with spans.span("flash_attention_backward"):
            if kernel:
                o, lse = kernel
                grads = _fa.flash_attention_backward(
                    q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
                    window=ctx.window, qpos=qpos, kpos=kpos)
                dq, dk, dv = (g if need else None for g, need in
                              zip(grads, ctx.needs_input_grad[:3]))
            else:
                _fa.flash_attention_backward.plain_calls += 1
                dq, dk, dv = _recompute_grads(plain, (q, k, v),
                                              ctx.needs_input_grad[:3],
                                              (do,))
        return dq, dk, dv, None, None, None, None, None, None


class GlaScanFn(torch.autograd.Function):
    """r/k (B,T,H,K) in v's dtype, v (B,T,H,V), f32 logw (B,T,H,K), f32 u
    (H,K) or None, f32 initial state (B,H,K,V) or None, all contiguous ->
    (y, final state)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, initial_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u, initial_state)
        from repro_torch.kernels import gla_scan as _gla
        return _gla.gla_scan(r, k, v, logw, u, initial_state=initial_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        from repro_torch.kernels import gla_scan as _gla

        def plain(r, k, v, logw, u, s0):
            return _gla.gla_scan_ref(r, k, v, logw, u, initial_state=s0)

        with spans.span("gla_scan_backward"):
            return _recompute_grads(plain, ctx.saved_tensors,
                                    ctx.needs_input_grad, (dy, dstate))


class PlainSpanFn(torch.autograd.Function):
    """``fn(*inputs)``, one tensor out, whose backward recomputes ``fn``
    under autograd inside the profiler range ``BACKWARD_SPANS[span]``.
    The gradients are those of autograd through ``fn`` itself; integer
    inputs (indices, masks) get none."""

    @staticmethod
    def forward(ctx, span: str, fn, *inputs):
        ctx.span, ctx.fn = span, fn
        ctx.save_for_backward(*inputs)
        return fn(*inputs)

    @staticmethod
    def backward(ctx, grad):
        with spans.span(f"{ctx.span}_backward"):
            grads = _recompute_grads(lambda *a: (ctx.fn(*a),),
                                     ctx.saved_tensors,
                                     ctx.needs_input_grad[2:], (grad,))
        return (None, None) + grads


def wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Grad mode is on and some input requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where a raw kernel wrapper would hand back an output without
    ``grad_fn``, whose inputs would then get no gradient and no error."""
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel's output has no "
            f"grad_fn; call it through repro_torch.kernels.ops (or under "
            f"torch.no_grad())")
