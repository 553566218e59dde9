"""Flash-attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention`` (the
Pallas TPU kernel). The port takes the model layout directly, q (B, Sq, H,
D) and k/v (B, Sk, G, D) with G dividing H; the kernel reads kv head
h // (H/G) by index instead of the Pallas wrapper's ``repeat``. Positions:
``qpos`` (Sq,) and ``kpos`` (Sk,) int32, ``kpos == -1`` marks an empty slot.

On a CPU tensor the wrapper runs ``flash_attention_ref``. On a CUDA tensor
it launches the kernel (``csrc/flash_attention.cu``) or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _positions(pos: Optional[torch.Tensor], n: int,
               device: torch.device) -> torch.Tensor:
    if pos is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    return pos


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        qpos: Optional[torch.Tensor] = None,
                        kpos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the kernel: same masks, finite NEG_INF, f32
    accumulation, zero for a row with no valid key, output in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    qp = _positions(qpos, Sq, q.device).long()
    kp = _positions(kpos, Sk, q.device).long()
    ok = (kp[None, :] >= 0).expand(Sq, Sk)
    if causal:
        ok = ok & (kp[None, :] <= qp[:, None])
    if window > 0:
        ok = ok & (kp[None, :] > qp[:, None] - window)
    qg = q.float().reshape(B, Sq, G, H // G, D)
    s = torch.einsum("bsgqd,btgd->bgqst", qg, k.float()) * (1.0 / math.sqrt(D))
    s = torch.where(ok, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                        device=s.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(ok, p, torch.zeros((), dtype=p.dtype, device=p.device))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgqst,btgd->bsgqd", p, v.float())
    o = o / l.clamp_min(1e-30).permute(0, 3, 1, 2, 4)
    return o.reshape(B, Sq, H, D).to(q.dtype)


def _check(q, k, v, qpos, kpos) -> None:
    if not (k.device == v.device == q.device == qpos.device == kpos.device):
        raise ValueError("q, k, v, qpos and kpos must share one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must all be float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,Sq,H,D), k/v (B,Sk,G,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Sk, G, Dk = k.shape
    if Bk != B or Dk != D or G < 1 or H % G:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if min(B, Sq, Sk) < 1 or B > 65535 or G > 65535:
        raise ValueError(f"unsupported sizes B={B} Sq={Sq} Sk={Sk} G={G}")
    if qpos.shape != (Sq,) or kpos.shape != (Sk,) or \
            qpos.dtype != torch.int32 or kpos.dtype != torch.int32:
        raise ValueError("qpos (Sq,) and kpos (Sk,) must be int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("qpos", qpos),
                    ("kpos", kpos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):  # read as 16-byte vectors
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    qpos: Optional[torch.Tensor] = None,
                    kpos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,G,D) -> (B,Sq,H,D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   qpos=qpos, kpos=kpos)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    qpos = _positions(qpos, q.shape[1], q.device)
    kpos = _positions(kpos, k.shape[1], q.device)
    _check(q, k, v, qpos, kpos)
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
             kpos.data_ptr(), out.data_ptr(), B, Sq, Sk, H, G, D,
             int(causal), int(window), 1.0 / math.sqrt(D),
             _DTYPE_CODE[q.dtype], q.device.index or 0, stream)
    build.raise_on_error(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
