"""hymba-1.5b [hybrid] — parallel attention + mamba heads in each layer,
sliding-window attention + SSM state [arXiv:2411.13676]. Runs long_500k
(sub-quadratic: SWA + O(1) SSM state)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    ssm_state=16, sliding_window=1024,
)
