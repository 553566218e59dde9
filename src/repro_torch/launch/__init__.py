"""Launchers: the production mesh's shape and a mesh over the current
process group; the multi-pod dry run (``launch/dryrun.py``, with the
roofline terms of ``launch/hlo_analysis.py``)."""
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
