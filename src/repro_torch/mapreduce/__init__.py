"""MapReduce data plane: the paper's jobs (WordCount, SequenceCount,
InvertedIndex, Grep, Permu) as torch map/combine/shuffle/reduce over token
shards, and the filtering percentage FP that JoSS classifies jobs by
(paper Eq. 3, Figs. 1-2). Counterpart of ``repro/mapreduce``: the local
half on one device, and the mesh shuffle (``mesh_mapreduce``), one
all_to_all over the mesh axes that JoSS's reduce placement (policies A/B)
picks, on ``torch.distributed``.
"""
from repro_torch.mapreduce.engine import (MeshResult, gather_groups,
                                          local_mapreduce, measure_fp,
                                          mesh_mapreduce)
from repro_torch.mapreduce.jobs import JOBS, MapReduceSpec, corpus

__all__ = ["JOBS", "MapReduceSpec", "MeshResult", "corpus", "gather_groups",
           "local_mapreduce", "mesh_mapreduce", "measure_fp"]
