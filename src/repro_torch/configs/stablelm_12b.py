"""stablelm-12b [dense] — GQA [hf:stabilityai/stablelm-2-12b]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352,
    norm="layernorm", rope_theta=10_000.0,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention: O(S^2) at 524k seq (DESIGN.md §5)",
)
