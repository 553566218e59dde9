"""Distribution layer: logical axes -> mesh placements, the hierarchical
collectives (``sharding.collectives``), and the activation-hint mechanism.
Counterpart of ``repro/sharding`` on ``torch.distributed``."""
from repro_torch.sharding.partition import (DEFAULT_RULES, MeshShape, Rules,
                                            current_rules, hint,
                                            logical_to_spec, mesh_axes,
                                            mesh_axis_size, named_sharding,
                                            tree_shardings, use_rules)

__all__ = ["DEFAULT_RULES", "MeshShape", "Rules", "current_rules", "hint",
           "logical_to_spec", "mesh_axes", "mesh_axis_size",
           "named_sharding", "tree_shardings", "use_rules"]
