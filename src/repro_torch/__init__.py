"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module paths and never imports it (or ``jax``). The first slice is the
JoSS-routed serving path: router -> batched prefill -> greedy decode on the
dense ``TransformerLM``, with every attention call going through the
hand-written CUDA flash-attention kernel in ``kernels/csrc``.
"""
