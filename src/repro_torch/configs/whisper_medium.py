"""whisper-medium [audio] — enc-dec, conv frontend stubbed: input_specs()
provides precomputed log-mel frame embeddings (arXiv:2212.04356,
unverified). n_layers is the decoder depth; encoder_layers the encoder."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    encoder_layers=24, frontend_dim=80,
    norm="layernorm", act="gelu",
    skip_shapes=("long_500k",),
    skip_reason="full-attention enc-dec: O(S^2) at 524k seq (DESIGN.md §5)",
)
