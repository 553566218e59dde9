"""A model's parameters placed on a mesh: each rank stores its shard of
every parameter and gathers it where it is used, or, for the leaves that
go tensor-parallel (``sharding.tp``), computes with its shard.

The placements are ``tree_shardings``' over the model's
``named_param_specs()`` (one spec a ``state_dict`` name, no ``layers``
dim). A parameter split over mesh axes is stored as this rank's piece
(``Shard(d)`` over a mesh dim of size > 1) and wrapped in a
``torch.nn.utils.parametrize`` parametrization, ``Gathered``, which
all-gathers it whenever the model reads it: just before each layer's
compute, and again in the remat recompute of the backward. The gathered
tensor is a plain tensor, so the kernels' wrappers see what they see on
one device. Training and serving place alike, as JAX's steps take
``param_shardings`` for every weight: a serving rank holds its pieces
too, and serving has no backward.

The 'model' axis, which GSPMD derives from the rules (``qkv``, ``heads``,
``mlp``, ``vocab`` -> 'model'), is tensor parallelism for every family:
``tp.tp_leaves`` names the leaves, which keep their piece over 'model'
for compute (``Placement.tp``) and are gathered over the other axes
only; the model then runs on the rank's heads, d_ff columns and vocab
rows (``models.transformer`` and each family's module). Every other leaf
split over 'model' is storage sharding: the ranks of a 'model' group
compute the same thing after the gather, each on its data rank's rows,
so the gradient of the gathered tensor is whole on each of them and each
keeps its piece (``GatherDim`` with ``replicated``). A parameter split
over a batch axis (``fsdp`` archs: 'embed' -> 'data') is gathered the
same way, but its ranks compute on different rows: the backward sums the
pieces' gradients over that axis (a reduce-scatter). The MoE experts are
the exception: ``models.moe_ep`` reads their stored shard
(``held_over``), E/M experts a rank, expert-parallel where the sequence
splits over 'model' and on the rank's experts' rows of the dense
dispatch where it does not (a decode step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.utils.parametrize as parametrize
from torch.distributed.tensor import Shard

from repro_torch.models.common import ParamSpec
from repro_torch.sharding import collectives as col
from repro_torch.sharding import tp as tpm
from repro_torch.sharding.partition import Rules, mesh_axes, tree_shardings


@dataclasses.dataclass(frozen=True)
class Gather:
    """One all-gather of a stored piece: tensor dim ``dim`` over mesh
    ``axes`` (in mesh order); ``replicated``: its ranks compute alike
    after it (no batch axis among them)."""

    dim: int
    axes: Tuple[str, ...]
    replicated: bool


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one parameter lives: its full spec and the gathers that
    rebuild it from this rank's piece; ``tp`` the role of a
    tensor-parallel leaf (its 'model' gather is never made)."""

    spec: ParamSpec
    gathers: Tuple[Gather, ...]
    tp: Optional[tpm.Role] = None

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the parameter is stored over."""
        return tuple(a for g in self.gathers for a in g.axes)

    def used(self) -> Tuple[Gather, ...]:
        """The gathers made where the model reads the parameter."""
        if self.tp is None:
            return self.gathers
        return tuple(g for g in self.gathers if tpm.AXIS not in g.axes)


def batch_axes(mesh, rules: Rules) -> Tuple[str, ...]:
    """The mesh axes the batch is split over, as JAX's ``moe_ffn_ep``
    reads them: the rule's axes that the mesh has."""
    b = rules.get("batch")
    b = (b,) if isinstance(b, str) else tuple(b or ())
    return tuple(a for a in b if a in mesh_axes(mesh))


def placements(specs: Dict[str, ParamSpec], mesh, rules: Rules
               ) -> Dict[str, Placement]:
    """Every parameter's placement, from ``tree_shardings``: a mesh dim
    of size 1 splits nothing and is left out."""
    order = list(mesh_axes(mesh))
    sizes = mesh_axes(mesh)
    batch = set(batch_axes(mesh, rules))
    shard = tree_shardings(mesh, rules, {n: s.axes for n, s in specs.items()},
                           specs)
    out = {}
    for name, spec in specs.items():
        dims: Dict[int, list] = {}
        for i, pl in enumerate(shard[name]):
            if isinstance(pl, Shard) and sizes[order[i]] > 1:
                dims.setdefault(pl.dim, []).append(order[i])
        gathers = []
        for dim, axes in sorted(dims.items()):
            on_batch = [a in batch for a in axes]
            if any(on_batch) and not all(on_batch):
                raise ValueError(f"{name}: dim {dim} is split over batch "
                                 f"and other axes {axes}")
            gathers.append(Gather(dim, tuple(axes), not any(on_batch)))
        out[name] = Placement(spec, tuple(gathers))
    return out


class Gathered(nn.Module):
    """The parametrization of a stored piece: its gathers in turn."""

    def __init__(self, mesh, gathers: Tuple[Gather, ...]):
        super().__init__()
        self.mesh = mesh
        self.gathers = gathers

    def forward(self, piece: torch.Tensor) -> torch.Tensor:
        return apply_gathers(piece, self.mesh, self.gathers)


def apply_gathers(piece: torch.Tensor, mesh, gathers) -> torch.Tensor:
    for g in gathers:
        piece = col.GatherDim.apply(piece, mesh, g.axes, g.dim, g.replicated)
    return piece


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    owner, _, leaf = name.rpartition(".")
    return (model.get_submodule(owner) if owner else model), leaf


@torch.no_grad()
def place(model: nn.Module, mesh, rules: Rules) -> Dict[str, Placement]:
    """Store this rank's piece of every parameter of ``model`` (in place)
    and gather it on use, but over 'model' for the tensor-parallel
    leaves, which the model then computes with (``model.tp``, a
    ``tp.MeshTP``). Returns the placements by ``state_dict`` name. Works
    on ``meta`` with a ``MeshShape`` (this rank: index 0 on every axis),
    which is how the dry run sizes a rank."""
    plan = placements(model.named_param_specs(), mesh, rules)
    leaves = tpm.tp_leaves(model, mesh, rules)
    M = col.axis_size(mesh, tpm.AXIS) if leaves else 1
    r = col.axis_index(mesh, tpm.AXIS) if leaves else 0
    for name, pl in plan.items():
        if name in leaves:
            pl = plan[name] = dataclasses.replace(pl, tp=leaves[name])
        elif not pl.gathers:
            continue
        owner, leaf = _owner(model, name)
        piece = getattr(owner, leaf).detach()
        for g in pl.gathers:
            if pl.tp is not None and tpm.AXIS in g.axes:
                piece = tpm.piece(piece, pl.tp, M, r)
            else:
                piece = col.chunk_dim(piece, mesh, g.axes, g.dim)
        setattr(owner, leaf, nn.Parameter(piece.clone()))
        if pl.used():
            parametrize.register_parametrization(owner, leaf,
                                                 Gathered(mesh, pl.used()),
                                                 unsafe=True)
    tpm.mark(model, leaves)
    model.tp = tpm.MeshTP(mesh) if leaves else None
    return plan


def whole_params(model: nn.Module, plan: Dict[str, Placement]
                 ) -> Dict[str, torch.Tensor]:
    """Every parameter whole, in JAX's layout (a ``state_dict`` of the
    unplaced model): the tensor-parallel pieces gathered over 'model'.
    Every rank must call it (it runs collectives)."""
    out = {}
    for name, pl in plan.items():
        owner, leaf = _owner(model, name)
        t = getattr(owner, leaf).detach()
        if pl.tp is not None:
            M = col.axis_size(model.tp.mesh, tpm.AXIS)
            parts = col.gather_dim(t.unsqueeze(0).contiguous(),
                                   model.tp.mesh, tpm.AXIS, 0)
            t = tpm.whole(parts.unbind(0), pl.tp) if M > 1 else t
        out[name] = t
    return out


def stored(model: nn.Module, name: str) -> nn.Parameter:
    """The tensor that holds parameter ``name`` on this rank: its piece
    where it is placed over some axis, else the parameter."""
    owner, leaf = _owner(model, name)
    if parametrize.is_parametrized(owner, leaf):
        return owner.parametrizations[leaf].original
    return getattr(owner, leaf)


def held_over(module: nn.Module, name: str, axis: str
              ) -> Optional[torch.Tensor]:
    """Parameter ``name`` of ``module`` gathered over every axis but
    ``axis``: as this rank holds it over ``axis``. None where the
    parameter is not placed (a plain parameter)."""
    if not parametrize.is_parametrized(module, name):
        return None
    par = module.parametrizations[name]
    gathered: Gathered = par[0]
    return apply_gathers(par.original, gathered.mesh,
                         tuple(g for g in gathered.gathers
                               if axis not in g.axes))
