"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay
[arXiv:2404.05892]. Runs long_500k (linear recurrence, O(1) state)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096,
    n_heads=64, n_kv_heads=64,          # RWKV6 head_dim 64 -> 64 state heads
    d_ff=14336, vocab=65536, head_dim=64,
)
