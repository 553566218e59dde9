"""Tensor parallelism over the 'model' axis, as JAX's rules give it.

JAX maps ``qkv``, ``heads``, ``mlp`` and ``vocab`` to 'model'
(``partition.DEFAULT_RULES``) and GSPMD splits the products by them. The
port does it by hand for every family (each model's ``tp_roles``):

- column-parallel: the projections into heads (attention's
  ``wq``/``wk``/``wv`` and biases, encdec's cross-attention, rwkv6's
  ``wr``/``wk``/``wv``/``wg``/``wB``, hymba's SSM ``wx``/``wB``/``wC``)
  and the MLPs' ``wi`` (arctic's dense residual, rwkv6's channel-mix
  ``wk``);
- by heads: the per-head leaves (rwkv6's ``w0``/``u`` and ``ln_x``,
  hymba's ``attn_norm``, SSM ``norm``, ``wdt``/``a_log``/``dt_bias``);
- row-parallel: every ``wo`` (rwkv6's channel-mix ``wv``), whose partial
  products are summed over 'model' (``reduce``);
- vocab-parallel: ``embed`` and ``lm_head`` (the lookup masked to the
  rank's rows and summed, the logits and the loss on the rank's columns).

The MoE experts are not among them: they run expert-parallel
(``models.moe_ep``), each rank on its E/M experts.

A leaf goes tensor-parallel where the rules split its role's dim over
'model' alone (``placements``, the divisibility fallback of
``logical_to_spec``), and only with the rest of its group: an
attention's projections (and biases) together, ``wi`` and ``wo``
together (``wi`` with whole gate and up halves, d_ff dividing by M),
``embed`` and ``lm_head`` together. Elsewhere the leaf keeps storage
sharding (``sharding.params``) and its compute repeats, as JAX's does
where a dim does not divide (``WHOLE``, a group of one rank, runs the
same model code there).

SwiGLU's ``wi`` is (d, 2f), gate ‖ up. Rank r's piece is gate[:, r-th f/M]
‖ up[:, r-th f/M] (``piece``), so that each rank's SwiGLU pairs its own
columns; the whole tensor keeps JAX's layout (``whole``).

The ranks' partial products are summed in the activations' type, as
GSPMD's all-reduces of bf16 dot outputs are: each part is rounded once
before the sum, where the whole product rounds once after it.

Two groups run the same model code (``TransformerLM``):

- ``MeshTP``: this process is one rank of a mesh; each leaf is stored as
  its piece, and the sums and gathers are collectives (``Reduce``,
  ``Copy``, ``GatherDim``, logged by ``collectives.LOG``; on a
  ``MeshShape`` with ``meta`` tensors, only logged: the dry run);
- ``VirtualTP``: all M ranks in one process, the model's leaves whole and
  each rank's piece a view of them; a sum over the ranks is the sum of
  their parts in rank order, a gather a concatenation, so autograd gives
  the whole gradient of every leaf. The card's ``tp`` phase runs it.

The model code works on lists: one tensor for each rank this process runs
(one on a mesh, M virtual); a tensor every rank holds alike (the residual
stream) is one tensor.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from repro_torch.sharding import collectives as col
from repro_torch.sharding.partition import (DEFAULT_RULES, MeshShape, Rules,
                                            mesh_axes)

AXIS = "model"

#: a tensor-parallel leaf: (the tensor dim split over 'model', paired)
Role = Tuple[int, bool]


def tp_leaves(model: nn.Module, mesh, rules: Rules) -> Dict[str, Role]:
    """The leaves of ``model`` that go tensor-parallel on ``mesh`` under
    ``rules``, by ``state_dict`` name: ``model.tp_roles()`` (name ->
    (dim, paired, group)) kept where every leaf of the group has its dim
    split over 'model' alone, paired ones with whole halves."""
    from repro_torch.sharding.params import placements
    roles = getattr(model, "tp_roles", lambda: {})()
    M = mesh_axes(mesh).get(AXIS, 1)
    if not roles or M <= 1:
        return {}
    specs = model.named_param_specs()
    plan = placements({n: specs[n] for n in roles}, mesh, rules)
    ok: Dict[str, bool] = collections.defaultdict(lambda: True)
    for name, (dim, paired, group) in roles.items():
        split = any(g.dim == dim and g.axes == (AXIS,)
                    for g in plan[name].gathers)
        if paired and specs[name].shape[dim] // 2 % M:
            split = False
        ok[group] &= split
    return {n: (dim, paired) for n, (dim, paired, group) in roles.items()
            if ok[group]}


#: the leaves a tensor-parallel block may hold whole but apply to the
#: rank's heads only (a per-head leaf whose heads do not divide by M):
#: each rank's gradient of them is a part, summed over 'model'
#: (``train.sharded``)
PARTIAL = ("q_norm", "k_norm", "w0", "u", "wdt", "a_log", "dt_bias")


def partial_leaves(model: nn.Module) -> set:
    """The ``state_dict`` names of the ``PARTIAL`` leaves held whole by
    the modules that run tensor-parallel."""
    return {f"{name}.{leaf}" for name, mod in model.named_modules()
            if getattr(mod, "tp_dims", None)
            for leaf in PARTIAL if leaf in getattr(mod, "inits", ())
            and leaf not in mod.tp_dims}


def piece(full: torch.Tensor, role: Role, M: int, r: int) -> torch.Tensor:
    """Rank r's piece of a whole leaf (a view, or a concatenation of two
    for a paired leaf)."""
    dim, paired = role
    if not paired:
        n = full.shape[dim] // M
        return full.narrow(dim, r * n, n)
    half = full.shape[dim] // 2
    n = half // M
    return torch.cat([full.narrow(dim, r * n, n),
                      full.narrow(dim, half + r * n, n)], dim=dim)


def whole(pieces: Sequence[torch.Tensor], role: Role) -> torch.Tensor:
    """The whole leaf, in JAX's layout, from the M ranks' pieces in rank
    order."""
    dim, paired = role
    if not paired:
        return torch.cat(list(pieces), dim=dim)
    halves = [p.chunk(2, dim=dim) for p in pieces]
    return torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                     dim=dim)


def mark(model: nn.Module, leaves: Dict[str, Role]) -> None:
    """Record on each module which of its own leaves are tensor-parallel
    (``tp_dims``: leaf -> role), where the model code reads it."""
    by_owner: Dict[str, Dict[str, Role]] = collections.defaultdict(dict)
    for name, role in leaves.items():
        owner, _, leaf = name.rpartition(".")
        by_owner[owner][leaf] = role
    for owner, dims in by_owner.items():
        mod = model.get_submodule(owner) if owner else model
        mod.tp_dims = dims


class TPGroup:
    """The 'model' ranks one process runs (``ranks``) of M."""

    M: int
    ranks: Tuple[int, ...]

    def pieces(self, module: nn.Module, leaf: str) -> List[torch.Tensor]:
        """Each rank's piece of ``module.leaf``, a tensor-parallel leaf."""
        raise NotImplementedError

    def copy(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x, which every rank holds alike, as each rank's input of a
        column-parallel product (its gradient summed over the ranks)."""
        raise NotImplementedError

    def reduce(self, xs: List[torch.Tensor]) -> torch.Tensor:
        """The sum of the ranks' parts, in rank order."""
        raise NotImplementedError

    def gather(self, xs: List[torch.Tensor], dim: int,
               replicated: bool) -> torch.Tensor:
        """The ranks' pieces along ``dim``, joined in rank order.
        ``replicated``: whether every rank computes alike with the result
        (its gradient is then whole on each); else the ranks' gradients
        of it are summed."""
        raise NotImplementedError

    def slice(self, x: torch.Tensor, dim: int) -> List[torch.Tensor]:
        """Each rank's piece along ``dim`` of x, which every rank holds
        alike."""
        raise NotImplementedError

    def max(self, xs: List[torch.Tensor]) -> torch.Tensor:
        """The elementwise max over the ranks (no gradient)."""
        raise NotImplementedError

    def to_slots(self, xs: List[torch.Tensor], heads_dim: int,
                 slots_dim: int) -> List[torch.Tensor]:
        """From each rank's heads (every slot) to each rank's slots
        (every head): the ranks' heads joined in rank order along
        ``heads_dim``, rank r keeping the r-th piece along ``slots_dim``
        (an all_to_all on a mesh)."""
        raise NotImplementedError


class Whole(TPGroup):
    """One rank holding every leaf whole: a block whose group is not
    tensor-parallel runs the tensor-parallel model code on it, its
    compute repeated on every 'model' rank."""

    M = 1
    ranks = (0,)

    def pieces(self, module, leaf):
        return [getattr(module, leaf)]

    def copy(self, x):
        return [x]

    def reduce(self, xs):
        return xs[0]

    def gather(self, xs, dim, replicated):
        return xs[0]

    def slice(self, x, dim):
        return [x]

    def max(self, xs):
        return xs[0].detach()

    def to_slots(self, xs, heads_dim, slots_dim):
        return xs


WHOLE = Whole()


def group_of(model: nn.Module, p: nn.Module) -> TPGroup:
    """The group module p's leaves run on: the model's where they are
    tensor-parallel, else ``WHOLE``."""
    return (model.tp if model.tp is not None and getattr(p, "tp_dims", None)
            else WHOLE)


class MeshTP(TPGroup):
    """This process is one rank of the 'model' axis of ``mesh`` (``ranks``:
    its index)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.M = col.axis_size(mesh, AXIS)
        self.ranks = (col.axis_index(mesh, AXIS),)

    def pieces(self, module, leaf):
        return [getattr(module, leaf)]

    def copy(self, x):
        return [col.Copy.apply(x, self.mesh, AXIS)]

    def reduce(self, xs):
        return col.Reduce.apply(xs[0], self.mesh, AXIS)

    def gather(self, xs, dim, replicated):
        return col.GatherDim.apply(xs[0].contiguous(), self.mesh, AXIS,
                                   dim % xs[0].dim(), replicated)

    def slice(self, x, dim):
        return [col.SliceDim.apply(x, self.mesh, AXIS, dim % x.dim())]

    def max(self, xs):
        return col.all_reduce_max(xs[0], self.mesh, AXIS)

    def to_slots(self, xs, heads_dim, slots_dim):
        x = xs[0]
        n = x.shape[slots_dim] // self.M
        # (M, ...): block j holds slot piece j, for rank j
        send = torch.stack(x.split(n, dim=slots_dim))
        got = col.all_to_all0(send, self.mesh, AXIS)
        # block s came from rank s: its heads for this rank's slots
        return [torch.cat(got.unbind(0), dim=heads_dim)]


class VirtualTP(TPGroup):
    """All M ranks in one process, the model's leaves whole."""

    def __init__(self, M: int):
        self.M = M
        self.ranks = tuple(range(M))

    def pieces(self, module, leaf):
        full = getattr(module, leaf)
        role = module.tp_dims[leaf]
        return [piece(full, role, self.M, r) for r in self.ranks]

    def copy(self, x):
        return [x] * self.M

    def reduce(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

    def gather(self, xs, dim, replicated):
        return torch.cat(xs, dim=dim)

    def slice(self, x, dim):
        return list(x.chunk(self.M, dim=dim))

    def max(self, xs):
        return torch.stack([x.detach() for x in xs]).amax(dim=0)

    def to_slots(self, xs, heads_dim, slots_dim):
        return list(torch.cat(xs, dim=heads_dim).chunk(self.M, dim=slots_dim))


def place_virtual(model: nn.Module, M: int,
                  rules: Rules = DEFAULT_RULES) -> Dict[str, Role]:
    """Run ``model`` (whole leaves) as M virtual 'model' ranks in this
    process: the leaves the rules split on a ('model',) mesh of M go
    tensor-parallel. Returns them."""
    leaves = tp_leaves(model, MeshShape.of(model=M), rules)
    mark(model, leaves)
    model.tp = VirtualTP(M) if leaves else None
    return leaves
