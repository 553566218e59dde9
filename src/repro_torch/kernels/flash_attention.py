"""Flash-attention forward: the hand-written CUDA kernels and their plain
PyTorch versions.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention`` (the
Pallas TPU kernel). The port takes the model layout directly, q (B, Sq, H,
D) and k/v (B, Sk, G, D) with G dividing H; the kernels read kv head
h // (H/G) by index instead of the Pallas wrapper's ``repeat``. Positions:
``qpos`` (Sq,) and ``kpos`` (Sk,) int32, ``kpos == -1`` marks an empty slot.

Three kernels (``csrc/flash_attention.cu``) compute the same function; the
wrapper picks one by dtype and Sq (``choose_variant``):

- ``"tc"``: bf16 with Sq > 1 (prefill), on the tensor cores;
- ``"split"``: Sq == 1 (decode), keys split over ``decode_splits`` blocks
  and merged, f32 arithmetic; ``flash_decode_ref`` is its plain version;
- ``"simt"``: f32 with Sq > 1, f32 on CUDA cores (tensor cores would run
  f32 as TF32).

On a CPU tensor the wrapper runs ``flash_attention_ref``. On a CUDA tensor
it launches the chosen kernel or raises. Its output has no ``grad_fn``, so
it refuses inputs that require grad under grad mode, on any device;
``kernels.autograd.FlashAttentionFn`` carries the gradient.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.autograd import refuse_grad
from repro_torch.models.common import acc_dtype

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
TILE_KEYS = 64               # keys a tile of the tc and split kernels
# split-kernel blocks an SM holds at once (4 warps, one 64-key stage: ~39
# KB of shared memory at D = 128 in bf16): decode_splits fits one wave
DECODE_BLOCKS_PER_SM = 5
VARIANTS = ("simt", "tc", "split")
_VARIANT_CODE = {name: i for i, name in enumerate(VARIANTS)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# repro_flash_attention_fwd(q, k, v, qpos, kpos, o, B, Sq, Sk, H, G, D,
#     causal, window, scale, dtype, variant, n_split, scratch, device, stream)
_SIGNATURES = {"repro_flash_attention_fwd": (
    ctypes.c_int, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])}
_sm_count: Dict[int, int] = {}
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _positions(pos: Optional[torch.Tensor], n: int,
               device: torch.device) -> torch.Tensor:
    if pos is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    return pos


def _mask(qp: torch.Tensor, kp: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    ok = (kp[None, :] >= 0).expand(qp.shape[0], kp.shape[0])
    if causal:
        ok = ok & (kp[None, :] <= qp[:, None])
    if window > 0:
        ok = ok & (kp[None, :] > qp[:, None] - window)
    return ok


def _scores(q: torch.Tensor, k: torch.Tensor, ok: torch.Tensor
            ) -> torch.Tensor:
    """(B, G, H/G, Sq, Sk) scores in f32 (f64 for f64 inputs), NEG_INF
    where masked."""
    B, Sq, H, D = q.shape
    G = k.shape[2]
    acc = acc_dtype(q)
    qg = q.to(acc).reshape(B, Sq, G, H // G, D)
    s = torch.einsum("bsgqd,btgd->bgqst", qg, k.to(acc)) * (1.0 / math.sqrt(D))
    return torch.where(ok, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                           device=s.device))


def _finish(acc: torch.Tensor, l: torch.Tensor, q: torch.Tensor
            ) -> torch.Tensor:
    """acc (B, Sq, G, H/G, D) / max(l, 1e-30), l (B, G, H/G, Sq, 1)."""
    B, Sq, H, D = q.shape
    o = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2, 4)
    return o.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        qpos: Optional[torch.Tensor] = None,
                        kpos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the kernels: same masks, finite NEG_INF, f32
    accumulation, zero for a row with no valid key, output in q's dtype."""
    Sq, Sk = q.shape[1], k.shape[1]
    ok = _mask(_positions(qpos, Sq, q.device).long(),
               _positions(kpos, Sk, q.device).long(), causal, window)
    s = _scores(q, k, ok)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(ok, p, torch.zeros((), dtype=p.dtype, device=p.device))
    acc = torch.einsum("bgqst,btgd->bsgqd", p, v.to(p.dtype))
    return _finish(acc, p.sum(dim=-1, keepdim=True), q)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     n_split: int, causal: bool = True, window: int = 0,
                     qpos: Optional[torch.Tensor] = None,
                     kpos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the split kernel and its merge, written as they do
    it: the key tiles cut into ``n_split`` contiguous ranges of
    ceil(tiles / n_split) tiles of 64 keys, a partial (m, l, acc) in f32 per
    range (m = NEG_INF, l = 0, acc = 0 where no key is valid), then
    o = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-30) with
    M = max m_s."""
    if n_split < 1:
        raise ValueError(f"n_split must be >= 1, got {n_split}")
    Sq, Sk = q.shape[1], k.shape[1]
    ok = _mask(_positions(qpos, Sq, q.device).long(),
               _positions(kpos, Sk, q.device).long(), causal, window)
    s = _scores(q, k, ok)
    tiles = -(-Sk // TILE_KEYS)
    per = -(-tiles // n_split) * TILE_KEYS
    ms, ls, accs = [], [], []
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    for i in range(n_split):
        lo, hi = min(Sk, i * per), min(Sk, (i + 1) * per)
        si, oki = s[..., lo:hi], ok[:, lo:hi]
        m = (si.amax(dim=-1, keepdim=True) if hi > lo else
             torch.full(s.shape[:-1] + (1,), NEG_INF, dtype=s.dtype,
                        device=s.device))
        p = torch.where(oki, torch.exp(si - m), zero)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bgqst,btgd->bsgqd", p,
                                 v[:, lo:hi].to(p.dtype)))
    M = torch.stack(ms).amax(dim=0)
    w = [torch.exp(m - M) for m in ms]                 # (B, G, H/G, Sq, 1)
    l = sum(wi * li for wi, li in zip(w, ls))
    acc = sum(wi.permute(0, 3, 1, 2, 4) * ai for wi, ai in zip(w, accs))
    return _finish(acc, l, q)


def choose_variant(dtype: torch.dtype, Sq: int) -> str:
    """The kernel a call goes to: ``"split"`` for one query position
    (decode), else ``"tc"`` for bf16 and ``"simt"`` for f32 (f32 on the
    tensor cores would be TF32, outside the f32 tolerance)."""
    if Sq == 1:
        return "split"
    return "tc" if dtype == torch.bfloat16 else "simt"


@functools.lru_cache(maxsize=None)
def decode_splits(B: int, G: int, Sk: int, n_sm: int) -> int:
    """How many key ranges the split kernel cuts Sk into: as many as one
    wave of ``DECODE_BLOCKS_PER_SM`` blocks (B * G * n_split) an SM holds,
    at least one 64-key tile a range, and no empty range. On the card a
    block's latency grows by about one tile's load for each tile it takes
    (PERF.md), so one tile a block is best while the blocks fit. Reads no
    data, so it never synchronises the stream."""
    tiles = -(-Sk // TILE_KEYS)
    want = max(1, min(tiles, DECODE_BLOCKS_PER_SM * n_sm // (B * G)))
    per = -(-tiles // want)
    return -(-tiles // per)


def _check(q, k, v, qpos, kpos) -> None:
    # get_device(): the decode step calls this on every layer, and building
    # torch.device objects would cost the host more than the kernel's time
    if not (k.get_device() == v.get_device() == q.get_device()
            == qpos.get_device() == kpos.get_device()):
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


def _check_variant(variant: str, dtype: torch.dtype, Sq: int) -> None:
    if variant not in _VARIANT_CODE:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if variant == "tc" and dtype != torch.bfloat16:
        raise TypeError(f"the tc kernel takes bfloat16, got {dtype}")
    if variant == "split" and Sq != 1:
        raise ValueError(f"the split kernel takes Sq == 1, got Sq={Sq}")


def _split_scratch(numel: int, device: int, stream: int) -> torch.Tensor:
    """f32 scratch for the split kernel's partials. One buffer is kept per
    (device, stream) and grown as needed: calls on one stream run in order,
    so the merge of one call has read it before the next call's split
    kernel writes it. A CUDA graph being captured gets a buffer of its own,
    from the graph's pool."""
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(numel, dtype=torch.float32, device=device)
    key = (device, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < numel:
        buf = _scratch[key] = torch.empty(numel, dtype=torch.float32,
                                          device=device)
    return buf


def _n_sm(device: int) -> int:
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_count[device]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    qpos: Optional[torch.Tensor] = None,
                    kpos: Optional[torch.Tensor] = None,
                    variant: Optional[str] = None,
                    n_split: Optional[int] = None) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,G,D) -> (B,Sq,H,D) in q's dtype.

    ``variant`` (default ``choose_variant``) and ``n_split`` (default
    ``decode_splits``; split only) pin the kernel for measurements and
    checks; the model path passes neither. Raises on inputs that require
    grad under grad mode (``kernels.ops`` carries gradients)."""
    refuse_grad("flash_attention", q, k, v)
    if variant is None:
        variant = choose_variant(q.dtype, q.shape[1])
    else:
        _check_variant(variant, q.dtype, q.shape[1])
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   qpos=qpos, kpos=kpos)
    if dev.type != "cuda":
        raise ValueError(f"no flash_attention for device {dev}")
    qpos = _positions(qpos, q.shape[1], dev)
    kpos = _positions(kpos, k.shape[1], dev)
    _check(q, k, v, qpos, kpos)
    lib = build.load("flash_attention", _SIGNATURES)
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    device = dev.index or 0
    # the raw handle of the current stream, without building a Stream
    stream = torch._C._cuda_getCurrentRawStream(device)
    out = torch.empty_like(q)
    scratch = None
    if variant == "split":
        n_split = n_split or decode_splits(B, G, Sk, _n_sm(device))
        scratch = _split_scratch((2 + D) * B * H * n_split, device, stream)
    err = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), out.data_ptr(), B, Sq, Sk, H, G, D, int(causal),
        int(window), 1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype],
        _VARIANT_CODE[variant], n_split or 0,
        None if scratch is None else scratch.data_ptr(), device, stream)
    build.raise_on_error(lib, err, f"flash_attention ({variant})")
    flash_attention.launches += 1
    flash_attention.launches_by_variant[variant] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_variant = {name: 0 for name in VARIANTS}
