"""A model's parameters placed on a mesh: each rank stores its shard of
every parameter and gathers it where it is used.

The placements are ``tree_shardings``' over the model's
``named_param_specs()`` (one spec a ``state_dict`` name, no ``layers``
dim). A parameter split over mesh axes is stored as this rank's piece
(``Shard(d)`` over a mesh dim of size > 1) and wrapped in a
``torch.nn.utils.parametrize`` parametrization, ``Gathered``, which
all-gathers it whenever the model reads it: just before each layer's
compute, and again in the remat recompute of the backward. The gathered
tensor is a plain tensor, so the kernels' wrappers see what they see on
one device.

This is how the port realises JAX's 'model' axis, which GSPMD derives
from the rules (``qkv``, ``heads``, ``mlp``, ``vocab`` -> 'model'):
storage sharding. The ranks of a 'model' group compute the same thing
after the gather, each on its data rank's rows, so the gradient of the
gathered tensor is whole on each of them and each keeps its piece
(``GatherDim`` with ``replicated``). A parameter split over a batch axis
(``fsdp`` archs: 'embed' -> 'data') is gathered the same way, but its
ranks compute on different rows: the backward sums the pieces' gradients
over that axis (a reduce-scatter). The MoE experts are the exception:
``models.moe_ep`` reads their stored shard (``held_over``) and runs them
expert-parallel.
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
    rebuild it from this rank's piece."""

    spec: ParamSpec
    gathers: Tuple[Gather, ...]

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the parameter is stored over."""
        return tuple(a for g in self.gathers for a in g.axes)


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
    and gather it on use. Returns the placements by ``state_dict``
    name. Works on ``meta`` with a ``MeshShape`` (this rank: index 0 on
    every axis), which is how the dry run sizes a rank."""
    plan = placements(model.named_param_specs(), mesh, rules)
    for name, pl in plan.items():
        if not pl.gathers:
            continue
        owner, leaf = _owner(model, name)
        piece = getattr(owner, leaf).detach()
        for g in pl.gathers:
            piece = col.chunk_dim(piece, mesh, g.axes, g.dim)
        setattr(owner, leaf, nn.Parameter(piece.clone()))
        parametrize.register_parametrization(owner, leaf,
                                             Gathered(mesh, pl.gathers),
                                             unsafe=True)
    return plan


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
