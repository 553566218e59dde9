"""Map / combine / shuffle / reduce in torch, the counterpart of
``repro/mapreduce/engine.py``.

The local half, ``local_mapreduce`` (the test oracle path) and
``measure_fp`` (the paper's filtering percentage, Figs. 1-2), runs on one
device. The mesh half, ``mesh_mapreduce``, runs on every rank of a
``DeviceMesh``: the shuffle is one ``all_to_all_single`` over a chosen set
of mesh axes. JoSS's placement decisions select those axes: policy A keeps
the shuffle on intra-pod axes only, policy B lets it cross the ``pod``
axis; ``MeshResult.cross_pod`` counts the records that crossed.

The reduce is a stable sort by key and integer segment sums: exact, so the
card and the CPU give the same keys, counts and FP bits. The JAX package
promises a Pallas segment-reduce kernel here, but it has none; nor does
the port.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.mapreduce.jobs import EMPTY, KVBatch, MapReduceSpec
from repro_torch.sharding.collectives import axes_group
from repro_torch.sharding.partition import mesh_axes

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


# -------------------------------------------------------------- mesh plane --
def _partition_pack(kv: KVBatch, n_dest: int, cap_dest: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bucket kv records by destination = key % n_dest into fixed-size
    per-destination buffers (EMPTY-padded); returns (keys, vals) shaped
    (n_dest, cap_dest) plus the number of dropped (overflow) records, as
    int32. Records keep their order inside a bucket (a stable sort, as
    ``jnp.argsort``); the records past a bucket's ``cap_dest`` go to a
    spill slot that is cut off, the only slot written twice."""
    dev = kv.keys.device
    dest = torch.where(kv.keys == EMPTY, n_dest, kv.keys % n_dest)
    d, order = torch.sort(dest, stable=True)
    k = kv.keys[order]
    v = kv.values[order]
    # rank of each record within its destination bucket
    starts = torch.searchsorted(d, torch.arange(n_dest + 1, device=dev))
    rank = torch.arange(d.shape[0], device=dev) - starts[d]
    ok = (d < n_dest) & (rank < cap_dest)
    spill = n_dest * cap_dest
    slot = torch.where(ok, d * cap_dest + rank, spill)
    buf_k = torch.full((spill + 1,), EMPTY, dtype=torch.int64, device=dev)
    buf_v = torch.zeros((spill + 1,), dtype=torch.int32, device=dev)
    buf_k[slot] = k
    buf_v[slot] = v
    dropped = ((d < n_dest) & ~ok).sum().to(torch.int32)
    return (buf_k[:-1].reshape(n_dest, cap_dest),
            buf_v[:-1].reshape(n_dest, cap_dest), dropped)


class MeshResult(NamedTuple):
    """One rank's ``mesh_mapreduce``: its shard group's row of JAX's
    (n_groups, ...) outputs, and what it counted on the way."""

    unique_keys: torch.Tensor   # (1, n) int64, sorted, EMPTY past n_unique
    counts: torch.Tensor        # (1, n) int32
    n_unique: torch.Tensor      # (1,) int32
    dropped: torch.Tensor       # (1,) int32: records past a bucket's cap
    records: torch.Tensor       # (1,) int64: records this rank's map emitted
    cross_pod: torch.Tensor     # (1,) int64: of those, sent to another pod


def _coordinate(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _index(coord: dict, sizes: dict, axes: Sequence[str]) -> int:
    """The index over ``axes``, the first axis major (JAX's
    ``axis_index`` of a tuple of axes)."""
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    return idx


@torch.no_grad()
def mesh_mapreduce(spec: MapReduceSpec, tokens, lengths, mesh,
                   shuffle_axes: Sequence[str] = ("data",),
                   shard_axes: Optional[Sequence[str]] = None,
                   slack: int = 4) -> MeshResult:
    """Distributed MapReduce over ``mesh``, called by every rank.

    tokens/lengths: the global (n_shards, S) batch, n_shards divisible by
    the product of the ``shard_axes`` sizes (input placement; defaults to
    ``shuffle_axes``). A rank maps the n_shards / n_groups shards of its
    shard group (its index over ``shard_axes``, pod-major, which is also
    every record's doc id), packs them by destination, and all_to_alls
    keys and values over ``shuffle_axes`` only, so reducer d owns keys
    with key % D == d within each shuffle group. shard_axes=('pod','data')
    with shuffle_axes=('data',) is JoSS policy A: every pod reduces its
    own shards and no record crosses a pod. The received records are
    reduced by ``_sort_reduce`` on their occupied slots and padded back to
    the buffer's length, as JAX's reduce over the whole buffer lays them
    out. ``gather_groups`` collects the rows into JAX's layout.
    """
    sizes = mesh_axes(mesh)
    shuffle_axes = tuple(shuffle_axes)
    shard_axes = tuple(shard_axes) if shard_axes else shuffle_axes
    D = math.prod(sizes[a] for a in shuffle_axes)
    n_groups = math.prod(sizes[a] for a in shard_axes)
    dev = torch.device(mesh.device_type)
    tokens = _on_device(tokens, dev)
    lengths = _on_device(lengths, tokens.device)
    n_shards, S = tokens.shape
    if n_shards % n_groups:
        raise ValueError(f"n_shards {n_shards} not divisible by {n_groups}")
    cap = S * spec.cap_mult
    local = n_shards // n_groups
    cap_dest = slack * -(-cap // D) * local
    coord = _coordinate(mesh)
    idx = _index(coord, sizes, shard_axes)
    kvs = [run_map(spec, t, l, idx) for t, l in
           zip(tokens[idx * local:(idx + 1) * local],
               lengths[idx * local:(idx + 1) * local])]
    flat = KVBatch(torch.cat([kv.keys for kv in kvs]),
                   torch.cat([kv.values for kv in kvs]),
                   torch.cat([kv.nbytes for kv in kvs]), cap * local)
    del kvs
    records = (flat.keys != EMPTY).sum().reshape(1)
    bk, bv, dropped = _partition_pack(flat, D, cap_dest)
    del flat
    # which pod each destination sits in, and so the records that cross
    pod = ("pod" in shuffle_axes) and (sizes["pod"] > 1)
    if pod:
        dest_pod = torch.arange(D, device=dev)
        for a in reversed(shuffle_axes[shuffle_axes.index("pod") + 1:]):
            dest_pod = dest_pod // sizes[a]
        dest_pod = dest_pod % sizes["pod"]
        away = dest_pod != coord["pod"]
        cross = (bk[away] != EMPTY).sum().reshape(1)
    else:
        cross = torch.zeros(1, dtype=torch.int64, device=dev)
    # the shuffle: one all_to_all over the chosen axes
    group = axes_group(mesh, shuffle_axes)
    rk, rv = torch.empty_like(bk), torch.empty_like(bv)
    dist.all_to_all_single(rk, bk, group=group)
    dist.all_to_all_single(rv, bv, group=group)
    del bk, bv
    rk, rv = rk.reshape(-1), rv.reshape(-1)
    occ = rk != EMPTY
    k, v = rk[occ], rv[occ]
    n = rk.shape[0]
    del rk, rv, occ
    uk, uv, _, n_unique = _sort_reduce(k, v, torch.zeros_like(v),
                                       combined_bytes=False)
    keys = torch.full((1, n), EMPTY, dtype=torch.int64, device=dev)
    counts = torch.zeros((1, n), dtype=torch.int32, device=dev)
    keys[0, :uk.shape[0]] = uk
    counts[0, :uv.shape[0]] = uv
    return MeshResult(keys, counts, n_unique.reshape(1),
                      dropped.reshape(1), records, cross)


@torch.no_grad()
def gather_groups(result: MeshResult, mesh,
                  shard_axes: Sequence[str] = ("data",)) -> MeshResult:
    """Every rank's ``mesh_mapreduce`` rows -> JAX's layout, on every
    rank: unique_keys, counts (n_groups, n), n_unique, dropped (n_groups,)
    from the first rank of each shard group; records and cross_pod
    (world,) from every rank, by global rank. The mesh must span the
    process group."""
    world = dist.get_world_size()
    if mesh.mesh.numel() != world:
        raise ValueError("the mesh does not span the process group")
    sizes = mesh_axes(mesh)
    names = list(mesh.mesh_dim_names)
    first = {}
    for pos in np.ndindex(*mesh.mesh.shape):
        g = _index(dict(zip(names, pos)), sizes, tuple(shard_axes))
        first.setdefault(g, int(mesh.mesh[pos]))
    rows = [first[g] for g in range(len(first))]

    def gather(t: torch.Tensor) -> torch.Tensor:
        out = torch.empty((world,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous())
        return out

    full = [gather(t) for t in result]
    return MeshResult(*(t[rows] for t in full[:4]), *full[4:])
