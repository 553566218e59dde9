"""The kernels' stand-ins on ``meta`` tensors, which the dry run
(``launch/dryrun.py``) sizes the port's path with.

A ``meta`` tensor holds no values, so no kernel runs on it. Each stand-in
is one op with a Meta implementation only: it takes the kernel's inputs
and gives outputs of the kernel's shapes. An op counter so sees what the
kernel reads and writes, one op, in place of the plain version's
intermediates (score blocks, the chunked scan's pieces), which the kernel
keeps on chip. Each has a ``FlopCounterMode`` formula for the kernel's
operations:

- ``flash_attention``: q, k, v and the positions in, o out; 4 D flops for
  each visible (query, key) pair of each head, the queries at the last Sq
  of the Sk key positions (self-attention, and a decode step at the end
  of its cache);
- ``flash_decode_partials``: q, k, v and the positions in, the packed
  partials (B * H, 2 + D) f32 out; the flash formula's flops for its one
  query over its keys (every key of a rank's slots where it is not
  causal: encdec's cross K/V); ``flash_decode_merge``: the ranks'
  partials in, o out, no matrix flops;
- ``gla_scan``: r, k, v, logw, u and the initial state in, y and the
  final state out; the flops of the chunked form in chunks of
  ``gla_scan.CHUNK`` rows.

The flash stand-ins apply the wrapper's head-dim rule
(``flash_attention.check_head_dim``): a cell at a head dim the kernels
have no instantiation of fails, as the card would, instead of counting a
call that cannot launch.

The backwards are the plain versions' autograd on the card too
(``kernels.autograd``), so they are counted as they run.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention import check_head_dim

_LIB = torch.library.Library("repro_torch_meta", "DEF")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, Tensor? qpos, "
            "Tensor? kpos, bool causal, int window) -> Tensor")
_LIB.define("flash_decode_partials(Tensor q, Tensor k, Tensor v, "
            "Tensor? qpos, Tensor? kpos, bool causal, int window) -> Tensor")
_LIB.define("flash_decode_merge(Tensor part, ScalarType dtype) -> Tensor")
_LIB.define("gla_scan(Tensor r, Tensor k, Tensor v, Tensor logw, Tensor? u, "
            "Tensor? s0) -> (Tensor, Tensor)")


def _flash(q, k, v, qpos, kpos, causal, window):
    return torch.empty_like(q)


def _partials(q, k, v, qpos, kpos, causal, window):
    B, _, H, D = q.shape
    return q.new_empty((B * H, 2 + D), dtype=torch.float32)


def _merge(part, dtype):
    return part.new_empty(part.shape[1:2] + (part.shape[2] - 2,),
                          dtype=dtype)


def _gla(r, k, v, logw, u, s0):
    B, _, H, K = r.shape
    return torch.empty_like(v), r.new_empty((B, H, K, v.shape[-1]),
                                            dtype=torch.float32)


_LIB.impl("flash_attention", _flash, "Meta")
_LIB.impl("flash_decode_partials", _partials, "Meta")
_LIB.impl("flash_decode_merge", _merge, "Meta")
_LIB.impl("gla_scan", _gla, "Meta")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    qpos: Optional[torch.Tensor],
                    kpos: Optional[torch.Tensor], causal: bool,
                    window: int) -> torch.Tensor:
    check_head_dim(q.shape[-1])
    return torch.ops.repro_torch_meta.flash_attention(q, k, v, qpos, kpos,
                                                      causal, window)


def flash_decode_partials(q, k, v, qpos, kpos, causal, window):
    check_head_dim(q.shape[-1])
    return torch.ops.repro_torch_meta.flash_decode_partials(
        q, k, v, qpos, kpos, causal, window)


def flash_decode_merge(part, dtype):
    check_head_dim(part.shape[-1] - 2)
    return torch.ops.repro_torch_meta.flash_decode_merge(part, dtype)


def gla_scan(r, k, v, logw, u, initial_state):
    return torch.ops.repro_torch_meta.gla_scan(r, k, v, logw, u,
                                               initial_state)


def _span(lo: int, hi: int) -> int:
    """lo + (lo + 1) + ... + hi, 0 where hi < lo."""
    return (hi * (hi + 1) - (lo - 1) * lo) // 2 if hi >= lo else 0


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask keeps, for query positions
    Sk - Sq .. Sk - 1 and key positions 0 .. Sk - 1."""
    a = Sk - Sq
    if causal:
        # query p sees min(p + 1, W) keys
        W = window or Sk
        return _span(a + 1, min(Sk, W)) + W * max(0, Sk - max(a, W))
    if not window:
        return Sq * Sk
    # query p sees the keys above p - window: Sk less max(0, p - window + 1)
    return Sq * Sk - _span(max(1, a - window + 1), Sk - window)


@register_flop_formula(torch.ops.repro_torch_meta.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, qpos_shape, kpos_shape,
                 causal, window, out_shape=None, **kwargs) -> int:
    B, Sq, H, D = q_shape
    return 4 * D * B * H * visible_pairs(Sq, k_shape[1], causal, window)


@register_flop_formula(torch.ops.repro_torch_meta.flash_decode_partials)
def _partials_flops(q_shape, k_shape, v_shape, qpos_shape, kpos_shape,
                    causal, window, out_shape=None, **kwargs) -> int:
    return _flash_flops(q_shape, k_shape, v_shape, qpos_shape, kpos_shape,
                        causal, window)


@register_flop_formula(torch.ops.repro_torch_meta.gla_scan)
def _gla_flops(r_shape, k_shape, v_shape, logw_shape, u_shape, s0_shape,
               out_shape=None, **kwargs) -> int:
    """Per chunk of n rows: 2nKV inter-chunk, 2nKV state update, n(n-1)/2
    pairs of 2K (A) and 2V (A @ v), and 2n(K + V) for the diagonal."""
    from repro_torch.kernels.gla_scan import CHUNK
    B, T, H, K = r_shape
    V = v_shape[-1]

    def chunk(n):
        return 4 * n * K * V + n * (n - 1) * (K + V) + 2 * n * (K + V)

    return (T // CHUNK * chunk(CHUNK) + chunk(T % CHUNK)) * B * H
