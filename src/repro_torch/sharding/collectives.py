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

import collections
import math
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.models.common import tree_map
from repro_torch.sharding.partition import MeshShape, mesh_axes

# mesh -> {axes: this rank's group over them}
_GROUPS: "weakref.WeakKeyDictionary[DeviceMesh, Dict]" = (
    weakref.WeakKeyDictionary())


Mesh = Union[DeviceMesh, MeshShape]
Axes = Union[str, Sequence[str]]

#: the ring's wire factor of each kind: the bytes a rank sends for one
#: call = factor(n) x the bytes logged (all-gather: its result; the
#: others: their operand), n the group's size, as
#: ``launch/hlo_analysis.py`` counts them
WIRE = {"all-gather": lambda n: (n - 1) / n,
        "reduce-scatter": lambda n: (n - 1) / n,
        "all-reduce": lambda n: 2 * (n - 1) / n,
        "all-to-all": lambda n: (n - 1) / n}


class CollectiveLog:
    """Calls and bytes by (kind, group size), in integers, so that two
    logs (a run's and the dry run's reckoning) compare exactly."""

    def __init__(self):
        self.calls: collections.Counter = collections.Counter()
        self.nbytes: collections.Counter = collections.Counter()

    def add(self, kind: str, n: int, nbytes: int) -> None:
        self.calls[(kind, n)] += 1
        self.nbytes[(kind, n)] += int(nbytes)

    def reset(self) -> None:
        self.calls.clear()
        self.nbytes.clear()

    def snapshot(self) -> Dict[str, Dict]:
        return {"calls": dict(self.calls), "nbytes": dict(self.nbytes)}

    def wire_bytes(self) -> Dict[str, float]:
        """Per kind, the bytes this rank puts on the wire."""
        out: Dict[str, float] = collections.defaultdict(float)
        for (kind, n), b in sorted(self.nbytes.items()):
            out[kind] += WIRE[kind](n) * b
        return dict(out)

    def n_calls(self) -> Dict[str, int]:
        out: Dict[str, int] = collections.Counter()
        for (kind, _), c in self.calls.items():
            out[kind] += c
        return dict(out)


#: every collective of this process; callers reset and read it
LOG = CollectiveLog()


def _flat_axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh: Mesh, axes: Axes) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in _flat_axes(axes))


def axis_index(mesh: Mesh, axes: Axes) -> int:
    """This rank's index over ``axes``, the first axis major (JAX's
    ``axis_index`` over a tuple); 0 on a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return 0
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx = 0
    for a in _flat_axes(axes):
        idx = idx * mesh.size(names.index(a)) + coord[names.index(a)]
    return idx


def _reckoned(x: torch.Tensor, mesh: Mesh) -> bool:
    """Whether a call is only logged, not made: the dry run's ``meta``
    tensors on a ``MeshShape``. A real tensor on a ``MeshShape`` has no
    ranks to exchange with and raises."""
    if not isinstance(mesh, MeshShape):
        return False
    if not x.is_meta:
        raise ValueError(f"a collective on the MeshShape {mesh} takes meta "
                         f"tensors (a dry run), not a {x.device} tensor")
    return True


def _group(mesh: DeviceMesh, axes: Axes) -> dist.ProcessGroup:
    return axes_group(mesh, _flat_axes(axes))


def gather_dim(x: torch.Tensor, mesh: Mesh, axes: Axes,
               dim: int = 0) -> torch.Tensor:
    """All-gather along ``dim`` over ``axes``: the ranks' pieces in index
    order."""
    n = axis_size(mesh, axes)
    shape = list(x.shape)
    shape[dim] *= n
    LOG.add("all-gather", n, math.prod(shape) * x.element_size())
    if _reckoned(x, mesh):
        return x.new_empty(shape)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
    dist.all_gather_into_tensor(out, xs, group=_group(mesh, axes))
    return out.movedim(0, dim)


def scatter_sum_dim(x: torch.Tensor, mesh: Mesh, axes: Axes,
                    dim: int = 0) -> torch.Tensor:
    """Reduce-scatter along ``dim`` over ``axes``: the sum over the ranks,
    this rank's piece of it."""
    n = axis_size(mesh, axes)
    LOG.add("reduce-scatter", n, x.numel() * x.element_size())
    shape = list(x.shape)
    shape[dim] //= n
    if _reckoned(x, mesh):
        return x.new_empty(shape)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, group=_group(mesh, axes))
    return out.movedim(0, dim)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axes: Axes
                   ) -> torch.Tensor:
    """The sum over ``axes``, a new tensor."""
    n = axis_size(mesh, axes)
    LOG.add("all-reduce", n, x.numel() * x.element_size())
    if _reckoned(x, mesh):
        return x.new_empty(x.shape)
    out = x.clone()
    dist.all_reduce(out, group=_group(mesh, axes))
    return out


def all_reduce_max(x: torch.Tensor, mesh: Mesh, axes: Axes
                   ) -> torch.Tensor:
    """The elementwise max over ``axes``, a new tensor (no gradient)."""
    n = axis_size(mesh, axes)
    LOG.add("all-reduce", n, x.numel() * x.element_size())
    if _reckoned(x, mesh):
        return x.new_empty(x.shape)
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_group(mesh, axes))
    return out


def all_to_all0(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """Equal-split all_to_all over dim 0: chunk j goes to the rank of
    index j, and row block s of the result came from rank s."""
    n = axis_size(mesh, axes)
    LOG.add("all-to-all", n, x.numel() * x.element_size())
    if _reckoned(x, mesh):
        return x.new_empty(x.shape)
    xs = x.contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=_group(mesh, axes))
    return out


def chunk_dim(x: torch.Tensor, mesh: Mesh, axes: Axes,
              dim: int = 0) -> torch.Tensor:
    """This rank's piece along ``dim`` (no communication)."""
    n = axis_size(mesh, axes)
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axes) * size, size)


class GatherDim(torch.autograd.Function):
    """``gather_dim`` under autograd. Where the ranks of ``axes`` compute
    the same thing after the gather (``replicated``, the 'model' axis),
    each holds the whole gradient and keeps its piece; where they compute
    on different rows (the batch axes), the pieces' gradients are summed
    over them (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, replicated):
        ctx.args = (mesh, axes, dim, replicated)
        return gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, replicated = ctx.args
        if replicated:
            return chunk_dim(g, mesh, axes, dim).contiguous(), None, None, \
                None, None
        return scatter_sum_dim(g, mesh, axes, dim), None, None, None, None


class Copy(torch.autograd.Function):
    """The input of a tensor-parallel layer that every rank of ``axes``
    holds whole: itself forward; its gradient summed over ``axes``
    backward, each rank having taken the part its own columns give."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return all_reduce_sum(g, mesh, axes), None, None


class Reduce(torch.autograd.Function):
    """The sum over ``axes`` of the ranks' partial results (a row-parallel
    product): each rank's part feeds the sum once, so the gradient of the
    sum is its gradient, unchanged."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class SliceDim(torch.autograd.Function):
    """This rank's piece along ``dim`` of a tensor every rank of ``axes``
    holds whole; the gradient pieces are gathered back, so the whole
    tensor's gradient is whole on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return chunk_dim(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return gather_dim(g.contiguous(), mesh, axes, dim), None, None, None


class AllToAll(torch.autograd.Function):
    """``all_to_all0`` under autograd: an equal-split exchange is a
    permutation of chunks among the ranks, so its backward is the same
    exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return all_to_all0(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return all_to_all0(g, mesh, axes), None, None


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


def hierarchical_psum(x: torch.Tensor, mesh: Mesh, *,
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
    part = scatter_sum_dim(x, mesh, data_axis)
    if pod_axis is not None:
        part = all_reduce_sum(part, mesh, pod_axis)
    return gather_dim(part, mesh, data_axis)


def flat_psum(x: torch.Tensor, mesh: Mesh, *, data_axis: str = "data",
              pod_axis: Optional[str] = "pod") -> torch.Tensor:
    """Baseline: one flat all-reduce over both axes."""
    axes = (data_axis,) if pod_axis is None else (pod_axis, data_axis)
    return all_reduce_sum(x, mesh, axes)


def make_grad_allreduce(mesh: Mesh, *, hierarchical: bool = True
                        ) -> Callable:
    """A function summing a tree of gradient tensors (each rank's own,
    leading dims divisible by |data| for the hierarchical form) over the
    batch axes, 'pod' too where the mesh has it."""
    pod_axis = "pod" if "pod" in mesh_axes(mesh) else None
    fn = hierarchical_psum if hierarchical else flat_psum

    def reduce_tree(grads):
        return tree_map(lambda g: fn(g, mesh, data_axis="data",
                                     pod_axis=pod_axis), grads)

    return reduce_tree


def two_hop_all_to_all(x: torch.Tensor, mesh: Mesh, *,
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
    y = x.reshape((n_pod, n_inner) + rest).transpose(0, 1)
    got = all_to_all0(y, mesh, inner_axis)
    # now (n_pod, n_inner, ...): [q, j] is inner rank j's chunk for pod q
    # hop 2 (inter-pod): one aggregated exchange across pods
    got = all_to_all0(got.transpose(0, 1), mesh, pod_axis)
    return got.reshape(x.shape)
