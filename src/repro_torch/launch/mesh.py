"""Mesh builders, the counterpart of ``repro/launch/mesh.py``.

The production meshes are 256 and 512 chips, which no process group here
has, so ``make_production_mesh`` gives their axis names and sizes only
(``MeshShape``), which is what the sharding rules read. ``make_host_mesh``
builds a ``DeviceMesh`` over the current process group.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sharding.partition import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 single pod (256 chips) or 2x16x16 two pods (512 chips).

    Axes: 'pod' = inter-pod DCN (the paper's inter-datacenter boundary),
    'data' = in-pod data parallelism, 'model' = tensor/expert parallelism.
    """
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(device: DeviceLike = None) -> DeviceMesh:
    """A (1, world) ('data', 'model') mesh over the current process group,
    on the card unless ``device`` names the CPU. Raises when no process
    group is up: the caller starts it (``init_process_group``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    return init_device_mesh(resolve_device(device).type,
                            (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))
