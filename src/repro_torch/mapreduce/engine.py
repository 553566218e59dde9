"""Map / combine / reduce on one device, the local half of
``repro/mapreduce/engine.py``: ``local_mapreduce`` (the test oracle path)
and ``measure_fp`` (the paper's filtering percentage, Figs. 1-2). The mesh
half (``_partition_pack``, ``mesh_mapreduce``) comes with the port's
multi-device slice.

The reduce is a stable sort by key and integer segment sums: exact, so the
card and the CPU give the same keys, counts and FP bits. The JAX package
promises a Pallas segment-reduce kernel here, but it has none; nor does
the port.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.mapreduce.jobs import EMPTY, KVBatch, MapReduceSpec

ArrayLike = Union[np.ndarray, torch.Tensor]


def _sort_reduce(keys: torch.Tensor, values: torch.Tensor,
                 nbytes: torch.Tensor, *, combined_bytes: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Sort by key and aggregate each key's values/bytes.

    Returns (unique_keys, summed_values, out_bytes, n_unique); slots beyond
    n_unique (and the EMPTY segment) carry key == EMPTY.

    combined_bytes=True models a combiner's output size: one serialized kv
    per unique key, with the bytes of the key's first member in sort order
    (JAX's scatter leaves unsaid which member's bytes survive; the members
    of a key share their bytes unless two 3-grams collide on the hash),
    else the sum of member bytes.
    """
    n = keys.shape[0]
    k, order = torch.sort(keys, stable=True)
    v = values[order]
    b = nbytes[order]
    first = torch.ones(n, dtype=torch.bool, device=keys.device)
    first[1:] = k[1:] != k[:-1]
    seg = torch.cumsum(first, 0) - 1
    n_seg = int(seg[-1]) + 1 if n else 0
    vsum = torch.zeros(n, dtype=values.dtype, device=keys.device)
    vsum.index_add_(0, seg, v)
    ukeys = torch.full((n,), EMPTY, dtype=k.dtype, device=keys.device)
    ukeys[:n_seg] = k[first]
    if combined_bytes:
        out = torch.zeros(n, dtype=nbytes.dtype, device=keys.device)
        out[:n_seg] = b[first]
    else:
        out = torch.zeros(n, dtype=nbytes.dtype, device=keys.device)
        out.index_add_(0, seg, b)
    valid = ukeys != EMPTY
    zero = torch.zeros((), dtype=values.dtype, device=keys.device)
    return (ukeys, torch.where(valid, vsum, zero),
            torch.where(valid, out, zero.to(nbytes.dtype)),
            valid.sum().to(torch.int32))


def run_map(spec: MapReduceSpec, tokens: torch.Tensor, lengths: torch.Tensor,
            doc_id: int) -> KVBatch:
    kv = spec.map_fn(tokens, lengths, doc_id)
    if spec.combine_in_map:
        k, v, b, _ = _sort_reduce(kv.keys, kv.values, kv.nbytes,
                                  combined_bytes=True)
        kv = KVBatch(k, v, b, kv.cap)
    return kv


def _on_device(x: ArrayLike, device: DeviceLike) -> torch.Tensor:
    """A tensor stays where it is unless ``device`` is named; numpy goes to
    ``device`` (the card by default)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, device=resolve_device(device))


@torch.no_grad()
def local_mapreduce(spec: MapReduceSpec, tokens: ArrayLike,
                    lengths: ArrayLike, *, device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Map+combine+reduce of one shard on one device (the test oracle path).

    Returns (unique_keys int64, counts int32, n_unique int32), the keys
    sorted, EMPTY past n_unique."""
    tokens = _on_device(tokens, device)
    lengths = _on_device(lengths, tokens.device)
    kv = run_map(spec, tokens, lengths, 0)
    k, v, _, n = _sort_reduce(kv.keys, kv.values, kv.nbytes,
                              combined_bytes=False)
    return k, v, n


def _fp_one(spec: MapReduceSpec, tokens: torch.Tensor,
            lengths: torch.Tensor) -> torch.Tensor:
    """Map-output bytes over map-input bytes of one shard, in float32 as
    JAX divides an int32 sum by an int32 sum: each exact integer sum is
    rounded to float32 and then divided."""
    kv = run_map(spec, tokens, lengths, 0)
    emitted = kv.nbytes.sum()
    consumed = torch.where(tokens >= 0, lengths, 0).sum()
    return emitted.to(torch.float32) / consumed.clamp_min(1).to(torch.float32)


@torch.no_grad()
def measure_fp(spec: MapReduceSpec, shards_tokens: ArrayLike,
               shards_lengths: ArrayLike, *,
               device: DeviceLike = None) -> np.ndarray:
    """Per-shard filtering percentage (paper Figs. 1-2): map-output bytes
    over map-input bytes, for a (n_shards, S) batch of shards, one shard
    after another on the device. Returns float32 (n_shards,)."""
    tokens = _on_device(shards_tokens, device)
    lengths = _on_device(shards_lengths, tokens.device)
    fps = torch.stack([_fp_one(spec, t, l) for t, l in zip(tokens, lengths)])
    return fps.cpu().numpy()
