"""The program's spans: ``torch.profiler`` ranges at its layer boundaries.

``SPANS`` lists the key of every range the program records; the range's
name is ``PREFIX + key``. A range exists only while a ``torch.profiler``
is collecting: ``span(key)`` then enters
``torch.profiler.record_function(PREFIX + key)``, and otherwise returns a
shared no-op context after one check (``record_function`` itself costs
about 15 us a call even with no profiler running). The check reads the
profiler state of the calling thread, which the autograd engine hands on
to the threads that run a backward, so the backward ranges of
``kernels/autograd.py`` hold there too.

A range nests under the range that was open on its thread when it began,
so a span's parent is the span that caused it. The profiler keeps the
ranges with its events; ``bench/trace.py`` reads the device time launched
under each range in its window (``Trace.spans``) and credits each idle gap
of the device to the outermost range or operation the host was in
(``Trace.gaps``).
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch::"

#: every span's key; what each covers, and what reads it
SPANS = (
    # one model.loss, in train/step.py::accumulate_grads; idle gaps
    "train.forward",
    # adamw_update in make_train_step (the norm and every leaf);
    # bench: optimizer_share.train
    "train.optimizer",
    # serve/lm.py::route_requests, the JoSS router; idle gaps
    "serve.route",
    # make_prefill_step's prefill_step; idle gaps
    "serve.prefill",
    # make_serve_step's serve_step, one decode step of the batch; idle gaps
    "serve.decode_step",
    # the head (final norm, head matmul, padding mask):
    # TransformerLM.unembed and logit_parts, every family's; idle gaps
    "model.unembed",
    # the backwards of kernels/autograd.py (BACKWARD_SPANS), on the
    # autograd engine's thread; bench: attn_bwd_share.train (flash)
    "flash_attention_backward",
    "gla_scan_backward",
    "moe_dispatch_backward",
)

_OFF = contextlib.nullcontext()


def launch(name: str):
    """Around a kernel launch through ``ctypes`` while a profiler collects
    on this thread: an operation ``name`` that owns the kernel's device
    time, so that the span open around it holds that time. The profiler
    credits a kernel to the innermost operation open at its launch that is
    not a range of ``record_function``; without one the kernel would go to
    an operation outside the span (``FlashAttentionFnBackward``, around the
    flash backward's span). Otherwise a no-op context."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def span(key: str):
    """The range ``PREFIX + key`` as a context while a profiler collects
    on this thread, else a no-op context."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + key)
