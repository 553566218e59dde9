"""Logical axes -> mesh placements, with the divisibility fallback.

Counterpart of ``repro/sharding/partition.py``. Models declare *logical*
axes on every parameter (``ParamSpec.axes``), which place the sharded
step's parameters (``sharding.params``); ``hint`` constrains a DTensor
activation, where JAX's models call it. A ``Rules`` object maps logical names
to mesh axes; a mapping whose dimension is not divisible by the mesh-axis
size falls back to replication for that dim (the MaxText-style rule).

A mesh here is anything with axis names and sizes: a ``DeviceMesh``
(``mesh_dim_names``, ``shape``), a ``MeshShape`` (the same two, with no
devices or ranks, so the rules are tested without a process group), or a
JAX-style object with ``axis_names`` and a ``shape`` dict.
``logical_to_spec`` returns JAX's ``tuple(PartitionSpec(...))``;
``named_sharding`` turns it into DTensor placements, one per mesh dim.

The active (mesh, rules) pair is installed with ``use_rules``; outside such
a scope ``hint`` returns its input itself.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from repro_torch.models.common import tree_map

AxisVal = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class Rules:
    """logical axis name -> mesh axis (or tuple of mesh axes, or None)."""

    table: Tuple[Tuple[str, AxisVal], ...]

    @classmethod
    def make(cls, mapping: Dict[str, AxisVal]) -> "Rules":
        return cls(tuple(mapping.items()))

    def get(self, name: Optional[str]) -> AxisVal:
        if name is None:
            return None
        for k, v in self.table:
            if k == name:
                return v
        return None

    def updated(self, **overrides: AxisVal) -> "Rules":
        d = dict(self.table)
        d.update(overrides)
        return Rules(tuple(d.items()))


#: the default production rules for the (pod, data, model) mesh.
#: 'embed'/'mlp_fsdp' etc. are overridden per-arch by the launcher.
DEFAULT_RULES = Rules.make({
    "batch": ("pod", "data"),
    "batch_nopod": "data",
    "seq": None,              # sequence parallelism: override to 'model'
    "cache_seq": "model",     # flash-decoding: KV cache length sharded
    "embed": None,
    "fsdp": "data",           # weight-stationary FSDP axis (when enabled)
    "vocab": "model",
    "qkv": "model",           # flattened heads*head_dim weight columns
    "heads": "model",         # attention-head activations
    "kv_heads": None,         # GQA kv heads usually < model size -> replicate
    "mlp": "model",
    "experts": "model",       # expert parallelism
    "expert_mlp": None,
    "layers": None,
    "state": None,            # recurrent state channels
    "frontend": None,
    "vis": None,
})


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, in order, with no devices: what a
    ``DeviceMesh`` tells the rules (``mesh_dim_names``, ``shape``)."""

    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.mesh_dim_names) != len(self.shape):
            raise ValueError(f"names {self.mesh_dim_names}, sizes "
                             f"{self.shape}")

    @classmethod
    def of(cls, **axes: int) -> "MeshShape":
        return cls(tuple(axes), tuple(axes.values()))


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size}, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def mesh_axis_size(mesh, axis: AxisVal) -> int:
    sizes = mesh_axes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, str):
        return sizes.get(axis, 1)
    n = 1
    for a in axis:
        n *= sizes.get(a, 1)
    return n


def logical_to_spec(mesh, rules: Rules, axes: Sequence[Optional[str]],
                    shape: Optional[Sequence[int]] = None
                    ) -> Tuple[AxisVal, ...]:
    """JAX's PartitionSpec as a tuple, one entry a tensor dim (trailing
    Nones dropped): a mapping is dropped where its mesh axes are absent,
    already used by an earlier dim, or do not divide the dim."""
    out = []
    used: set = set()
    names = set(mesh_axes(mesh))
    for i, name in enumerate(axes):
        axis = rules.get(name)
        if axis is not None:
            flat = tuple(a for a in ((axis,) if isinstance(axis, str)
                                     else tuple(axis)) if a in names)
            axis = (flat[0] if len(flat) == 1 else flat) if flat else None
        if axis is not None:
            if any(a in used for a in flat):
                axis = None  # a mesh axis may appear at most once in a spec
            elif shape is not None and shape[i] % mesh_axis_size(mesh, axis):
                axis = None  # divisibility fallback -> replicate
            else:
                used.update(flat)
        out.append(axis)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def named_sharding(mesh, rules: Rules, axes: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None
                   ) -> Tuple[Placement, ...]:
    """The DTensor placements of ``logical_to_spec``: per mesh dim,
    ``Shard(d)`` where tensor dim d maps to it, else ``Replicate()``.

    A dim mapped to several mesh axes gets a ``Shard(d)`` on each; DTensor
    splits it in mesh-dim order, JAX in the order of the spec's tuple. The
    two agree only when the tuple follows the mesh's order, so any other
    order raises: it is never reordered silently."""
    order = list(mesh_axes(mesh))
    placements = [Replicate()] * len(order)
    for dim, entry in enumerate(logical_to_spec(mesh, rules, axes, shape)):
        if entry is None:
            continue
        flat = (entry,) if isinstance(entry, str) else entry
        pos = [order.index(a) for a in flat]
        if pos != sorted(pos):
            raise ValueError(
                f"tensor dim {dim} maps to mesh axes {flat}, not in the "
                f"mesh's order {tuple(order)}: DTensor would split it "
                f"{order[min(pos)]!r}-major, JAX {flat[0]!r}-major")
        for p in pos:
            placements[p] = Shard(dim)
    return tuple(placements)


def tree_shardings(mesh, rules: Rules, axes_tree, shape_tree=None):
    """A tree of logical-axes tuples (and, aligned, of specs or tensors
    with a ``shape``) -> the same tree of placements."""
    if shape_tree is None:
        return tree_map(lambda ax: named_sharding(mesh, rules, ax),
                        axes_tree)
    return tree_map(lambda ax, s: named_sharding(mesh, rules, ax, s.shape),
                    axes_tree, shape_tree)


# ------------------------------------------------------------- hint scope --
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "active_rules", default=None)


@contextlib.contextmanager
def use_rules(mesh, rules: Rules):
    """Install (mesh, rules) so ``hint`` calls bind to it."""
    tok = _ACTIVE.set((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def hint(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """JAX's with_sharding_constraint by logical axes. Outside
    ``use_rules`` it returns ``x`` itself. Inside, a DTensor is
    redistributed to the rules' placements on the active mesh (a
    ``DeviceMesh``); a plain tensor carries no placement and comes back
    as it is, its shape kept."""
    active = _ACTIVE.get()
    if active is None or not isinstance(x, DTensor):
        return x
    mesh, rules = active
    return x.redistribute(mesh, named_sharding(mesh, rules, axes, x.shape))


def current_rules():
    """The active (mesh, rules), or None."""
    return _ACTIVE.get()
