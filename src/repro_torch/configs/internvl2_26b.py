"""internvl2-26b [vlm] — InternViT frontend stubbed (input_specs() provides
precomputed patch embeddings, vis_dim = InternViT-6B width 3200), InternLM2
backbone [arXiv:2404.16821]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553, head_dim=128,
    vis_tokens=256, vis_dim=3200,
    rope_theta=1_000_000.0,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention: O(S^2) at 524k seq (DESIGN.md §5)",
)
