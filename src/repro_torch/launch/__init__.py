"""Launchers: the production mesh's shape and a mesh over the current
process group. The multi-pod dry run (``launch/dryrun.py``,
``launch/hlo_analysis.py``) is not ported yet."""
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
