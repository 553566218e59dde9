"""arctic-480b [moe] — 128 experts top-2 + dense residual FFN
[hf:Snowflake/snowflake-arctic-base]. FSDP: 960 GB of bf16 weights must
shard over both mesh axes."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, head_dim=128,
    n_experts=128, moe_topk=2, moe_dense_residual=True,
    fsdp=True,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention: O(S^2) at 524k seq (DESIGN.md §5)",
)
