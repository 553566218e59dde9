"""MapReduce data plane, local half: the paper's jobs (WordCount,
SequenceCount, InvertedIndex, Grep, Permu) as torch map/combine/reduce over
token shards on one device, and the filtering percentage FP that JoSS
classifies jobs by (paper Eq. 3, Figs. 1-2). Counterpart of
``repro/mapreduce``; the mesh shuffle (``mesh_mapreduce``) is not ported
yet.
"""
from repro_torch.mapreduce.engine import local_mapreduce, measure_fp
from repro_torch.mapreduce.jobs import JOBS, MapReduceSpec, corpus

__all__ = ["JOBS", "MapReduceSpec", "corpus", "local_mapreduce",
           "measure_fp"]
