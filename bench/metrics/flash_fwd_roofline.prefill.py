"""The attn_fwd_tc launches' least time (causal operations, and q, k, v, o
bytes, from the shapes the traced batches sent; the larger) over their
device time."""
from bench import roofline
from bench.reference import head_dim

KERNEL = "attn_fwd_tc"


def read(run):
    c = run.config
    n, secs = run.trace.kernel_s(KERNEL)
    pf = run.traced.get("prefills", [])
    if not n or n != len(pf) * c["n_layers"]:
        return None
    least = c["n_layers"] * sum(roofline.bound_s(*roofline.attn_fwd(
        B, P, c["n_heads"], c["n_kv_heads"], head_dim(c))) for B, P, _ in pf)
    return 100.0 * least / secs
