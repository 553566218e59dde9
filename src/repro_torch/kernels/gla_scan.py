"""Chunked GLA scan: the hand-written CUDA kernel and its plain PyTorch
version.

Counterpart of ``repro/kernels/gla_scan.py::gla_pallas`` (the Pallas TPU
kernel). The port takes the model layout directly, r/k/logw (B, T, H, K)
and v (B, T, H, V), with none of the Pallas wrapper's (B*H, T, d)
transposes; u (H, K) or None; an optional f32 ``initial_state`` (B, H, K,
V), which the Pallas kernel lacks and ``gla_chunked`` has. Returns y (B, T,
H, V) in v's dtype and the final f32 state (B, H, K, V). Any T >= 1: the
kernel masks a ragged last chunk itself.

Two kernels (``csrc/gla_scan.cu``) compute the same function; the wrapper
picks one by dtype (``choose_variant``):

- ``"tc"``: bf16, the pairs and the three products on the tensor cores, a
  block per (b, h);
- ``"simt"``: f32 (and bf16 on request), f32 on CUDA cores (tensor cores
  would run f32 as TF32).

``gla_scan_ref`` is the plain version of both. On a CPU tensor the wrapper
runs it. On a CUDA tensor it launches the chosen kernel or raises. Its
outputs have no ``grad_fn``, so it refuses inputs that require grad under
grad mode, on any device; ``kernels.autograd.GlaScanFn`` carries the
gradients.

Precondition of both kernels: logw <= 0 (a decay, as both models make it:
RWKV6's -exp(.), hymba's dt * -exp(a_log)). Every exponent they take is
then <= 0, or bounded inside a tc sub-chunk. A positive logw breaks that:
the two kernels clamp differently, so they need not agree with each other
or with the plain version there.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.autograd import refuse_grad
from repro_torch.models.recurrence import gla_chunked

CHUNK = 32                      # the kernel's chunk length
DIMS = (8, 16, 32, 64)          # key and value widths the kernel takes
VARIANTS = ("tc", "simt")
_VARIANT_CODE = {"simt": 0, "tc": 1}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# repro_gla_scan_fwd(r, k, v, logw, u, s0, y, state, B, T, H, K, V, dtype,
#                    variant, device, stream)
_SIGNATURES = {"repro_gla_scan_fwd": (
    ctypes.c_int, [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
    + [ctypes.c_void_p])}


def gla_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: Optional[torch.Tensor] = None, *,
                 initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ``gla_chunked`` in chunks of 32 with
    the kernel's cw_prev (``shifted_prev=True``), T padded up to a multiple
    of 32 with r = k = v = logw = 0, which leaves the state as it is (as the
    kernel masks its last chunk)."""
    T = r.shape[1]
    pad = -T % CHUNK
    if pad:
        r, k, v, logw = (F.pad(x, (0, 0, 0, 0, 0, pad))
                         for x in (r, k, v, logw))
    y, state = gla_chunked(r, k, v, logw, u, chunk=CHUNK,
                           initial_state=initial_state, shifted_prev=True)
    return y[:, :T], state


def choose_variant(dtype: torch.dtype) -> str:
    """The kernel a call goes to: ``"tc"`` for bf16, ``"simt"`` for f32 (f32
    on the tensor cores would be TF32, outside the f32 tolerance). Either
    takes logw <= 0 (the module's precondition)."""
    return "tc" if dtype == torch.bfloat16 else "simt"


def _check_variant(variant: str, dtype: torch.dtype) -> None:
    if variant not in _VARIANT_CODE:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if variant == "tc" and dtype != torch.bfloat16:
        raise TypeError(f"the tc kernel takes bfloat16, got {dtype}")


def _check(r, k, v, logw, u, s0) -> None:
    ts = [("r", r), ("k", k), ("v", v), ("logw", logw)]
    if u is not None:
        ts.append(("u", u))
    if s0 is not None:
        ts.append(("initial_state", s0))
    if len({t.device for _, t in ts}) != 1:
        raise ValueError("r, k, v, logw, u and initial_state must share one "
                         "device")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r/k/v must all be float32 or bfloat16, got "
                        f"{r.dtype}/{k.dtype}/{v.dtype}")
    for name, t in ts[3:]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need r/k/logw (B,T,H,K) and v (B,T,H,V); got "
                         f"{tuple(r.shape)} and {tuple(v.shape)}")
    B, T, H, K = r.shape
    V = v.shape[-1]
    if k.shape != r.shape or logw.shape != r.shape or \
            v.shape[:3] != r.shape[:3]:
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, logw "
                         f"{tuple(logw.shape)} and v {tuple(v.shape)} do not "
                         f"fit")
    if K not in DIMS or V not in DIMS:
        raise ValueError(f"K={K} and V={V} must be in {DIMS}")
    if min(B, T, H) < 1 or B > 65535:
        raise ValueError(f"unsupported sizes B={B} T={T} H={H}")
    if u is not None and u.shape != (H, K):
        raise ValueError(f"u must be (H, K) = {(H, K)}, got {tuple(u.shape)}")
    if s0 is not None and s0.shape != (B, H, K, V):
        raise ValueError(f"initial_state must be (B, H, K, V) = "
                         f"{(B, H, K, V)}, got {tuple(s0.shape)}")
    for name, t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def gla_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: Optional[torch.Tensor] = None, *,
             initial_state: Optional[torch.Tensor] = None,
             variant: Optional[str] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/logw (B,T,H,K), v (B,T,H,V) -> (y (B,T,H,V), state (B,H,K,V)),
    for logw <= 0.

    ``variant`` (default ``choose_variant``) pins the kernel, for
    measurements and checks; the model path does not pass it. Raises on
    inputs that require grad under grad mode (``kernels.ops`` carries
    gradients). On ``meta`` tensors (the dry run) it is the kernel's
    stand-in, ``kernels.meta``."""
    refuse_grad("gla_scan", r, k, v, logw, u, initial_state)
    if variant is not None:
        _check_variant(variant, r.dtype)
    variant = variant or choose_variant(r.dtype)
    if r.device.type == "cpu":
        return gla_scan_ref(r, k, v, logw, u, initial_state=initial_state)
    if r.device.type == "meta":
        from repro_torch.kernels import meta
        return meta.gla_scan(r, k, v, logw, u, initial_state)
    if r.device.type != "cuda":
        raise ValueError(f"no gla_scan for device {r.device}")
    _check(r, k, v, logw, u, initial_state)
    lib = build.load("gla_scan", _SIGNATURES)
    B, T, H, K = r.shape
    V = v.shape[-1]
    device = r.device.index or 0
    if variant == "tc":
        for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
            if t.data_ptr() % 16:  # copied in 16-byte pieces
                raise ValueError(f"{name} must be 16-byte aligned")
    y = torch.empty_like(v)
    state = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.repro_gla_scan_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        None if u is None else u.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), B, T, H, K, V,
        _DTYPE_CODE[r.dtype], _VARIANT_CODE[variant], device, stream)
    build.raise_on_error(lib, err, f"gla_scan ({variant})")
    gla_scan.launches += 1
    gla_scan.launches_by_variant[variant] += 1
    return y, state


gla_scan.launches = 0
gla_scan.launches_by_variant = {name: 0 for name in VARIANTS}
