"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module paths and never imports it (or ``jax``). On one device it does
everything the JAX package does: the JoSS scheduler and its simulator
(``core/``, ``sim/``, ``elastic/``, ``chaos/``, ``obs/``, ``runtime/``), the
sweeps over it (``sweep/``: a process pool, a result store, and a lockstep
backend whose fabric fills go through the hand-written fill kernel), the
MapReduce data plane's local half (``mapreduce/``), and the LM zoo's
JoSS-routed serving and training paths (``serve/``, ``train/``,
``models/``), every attention call through the hand-written flash-attention
kernel and every GLA scan through the hand-written GLA kernel
(``kernels/csrc``). Of the multi-device layer it has, on
``torch.distributed``, the models' param specs with logical axes, the
sharding rules and their DTensor placements (``sharding/``), ZeRO-1 state
axes (``train/optimizer.py``), the hierarchical collectives, the mesh
builders (``launch/mesh.py``) and the MapReduce mesh shuffle
(``mapreduce.mesh_mapreduce``). Not ported yet: the expert-parallel MoE,
the sharded train step, and the multi-pod dry run.
"""
