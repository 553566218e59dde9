"""Hierarchical collectives on ``torch.distributed``: the JoSS
reduce-placement insight applied to gradient reduction and MoE dispatch.
Counterpart of ``repro/sharding/collectives.py``.

The paper's policies A/B place the reduce phase so shuffle bytes stay
inside one datacenter. The gradient all-reduce analogue on a (pod, data,
model) mesh: reduce-scatter over the in-pod 'data' axis first, then
all-reduce only the 1/|data| shard over 'pod' (the scarce inter-pod
link), then all-gather in-pod. Inter-pod bytes drop from 2·(P-1)/P·|g| to
2·(P-1)/P·|g|/D. The same trick for MoE: a two-hop all_to_all exchanges
within the pod first, so only pod-aggregated traffic crosses pods.

Where JAX runs these inside ``shard_map`` on named axes, each function
here is called by every rank of a ``DeviceMesh`` on its own tensor and
runs on the mesh's sub-groups. A group over several axes (the flat
baselines) is made with ``dist.new_group`` on every rank in the same
order, once per mesh, and kept beside it.
"""
from __future__ import annotations

import math
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.models.common import tree_map

# mesh -> {axes: this rank's group over them}
_GROUPS: "weakref.WeakKeyDictionary[DeviceMesh, Dict]" = (
    weakref.WeakKeyDictionary())


def axis_size(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    names = list(mesh.mesh_dim_names)
    return math.prod(mesh.size(names.index(a)) for a in axes)


def axes_group(mesh: DeviceMesh, axes: Sequence[str]) -> dist.ProcessGroup:
    """The group over mesh axes ``axes`` that holds this rank (its
    coordinates on the other axes fixed). Its group ranks follow the
    index over ``axes``, the first axis major, as JAX's index over a
    tuple of axes does; every rank must call it (it may make groups)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = _GROUPS.setdefault(mesh, {})
    if axes not in groups:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{tuple(names)}")
        rest = [i for i in range(len(names)) if i not in dims]
        rows = mesh.mesh.permute(*rest, *dims).reshape(
            -1, axis_size(mesh, axes)).tolist()
        me = dist.get_rank()
        for row in rows:
            # new_group orders a group by global rank: that must be the
            # index over axes, as it is for a mesh laid out rank-major
            if row != sorted(row):
                raise ValueError(f"mesh ranks {row} over {axes} are not "
                                 f"ascending")
            g = dist.new_group(ranks=row)
            if me in row:
                groups[axes] = g
    return groups[axes]


def hierarchical_psum(x: torch.Tensor, mesh: DeviceMesh, *,
                      data_axis: str = "data",
                      pod_axis: Optional[str] = "pod") -> torch.Tensor:
    """In-pod reduce-scatter -> cross-pod all-reduce -> in-pod all-gather.

    Every rank calls it with its x; the result equals ``flat_psum``, the
    sum over the (pod, data) ranks. Requires x.shape[0] divisible by the
    data-axis size."""
    D = axis_size(mesh, (data_axis,))
    if x.shape[0] % D:
        raise ValueError(f"dim 0 ({x.shape[0]}) must divide by |{data_axis}|"
                         f" = {D}")
    data = mesh.get_group(data_axis)
    x = x.contiguous()
    part = torch.empty((x.shape[0] // D,) + tuple(x.shape[1:]),
                       dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(part, x, group=data)
    if pod_axis is not None:
        dist.all_reduce(part, group=mesh.get_group(pod_axis))
    out = torch.empty_like(x)
    dist.all_gather_into_tensor(out, part, group=data)
    return out


def flat_psum(x: torch.Tensor, mesh: DeviceMesh, *, data_axis: str = "data",
              pod_axis: Optional[str] = "pod") -> torch.Tensor:
    """Baseline: one flat all-reduce over both axes."""
    axes = (data_axis,) if pod_axis is None else (pod_axis, data_axis)
    out = x.clone()
    dist.all_reduce(out, group=axes_group(mesh, axes))
    return out


def make_grad_allreduce(mesh: DeviceMesh, *, hierarchical: bool = True
                        ) -> Callable:
    """A function summing a tree of gradient tensors (each rank's own,
    leading dims divisible by |data| for the hierarchical form) over the
    batch axes, 'pod' too where the mesh has it."""
    pod_axis = "pod" if "pod" in mesh.mesh_dim_names else None
    fn = hierarchical_psum if hierarchical else flat_psum

    def reduce_tree(grads):
        return tree_map(lambda g: fn(g, mesh, data_axis="data",
                                     pod_axis=pod_axis), grads)

    return reduce_tree


def two_hop_all_to_all(x: torch.Tensor, mesh: DeviceMesh, *,
                       pod_axis: str = "pod",
                       inner_axis: str = "model") -> torch.Tensor:
    """MoE dispatch across pods in two hops: exchange within the pod
    first, then one aggregated exchange across pods. x: (n_total, ...)
    with n_total = |pod| * |inner|, chunk i for the rank of index i over
    (pod, inner), pod-major. Returns what the flat all_to_all over both
    axes returns: row s is rank s's chunk for this rank.

    Wire effect: per-token inter-pod crossings drop from one small message
    per (src, dst) rank pair to one aggregated message per pod pair.
    """
    n_pod, n_inner = (axis_size(mesh, (pod_axis,)),
                      axis_size(mesh, (inner_axis,)))
    if x.shape[0] != n_pod * n_inner:
        raise ValueError(f"dim 0 ({x.shape[0]}) must be |{pod_axis}| x "
                         f"|{inner_axis}| = {n_pod * n_inner}")
    rest: Tuple[int, ...] = tuple(x.shape[1:])
    # hop 1 (in-pod): inner rank j gets column j for all pods
    y = x.reshape((n_pod, n_inner) + rest).transpose(0, 1).contiguous()
    got = torch.empty_like(y)
    dist.all_to_all_single(got, y, group=mesh.get_group(inner_axis))
    # now (n_pod, n_inner, ...): [q, j] is inner rank j's chunk for pod q
    y = got.transpose(0, 1).contiguous()
    # hop 2 (inter-pod): one aggregated exchange across pods
    got = torch.empty_like(y)
    dist.all_to_all_single(got, y, group=mesh.get_group(pod_axis))
    return got.reshape(x.shape)
