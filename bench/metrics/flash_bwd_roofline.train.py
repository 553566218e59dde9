"""The attention backward kernels' least time over their device time: the
kernels whose name holds attn_bwd, in the traced training steps. Least time
a call: the five causal products of FA2 (2.5 times the forward's operations
at the cell's shapes) or the bytes of bf16 q, o, dO and dQ (B, S, H, D), k,
v, dK and dV (B, S, G, D) and each row's f32 log-sum-exp and D, the larger;
one call a layer a step. None unless the launches are a whole number of
launches a call."""
from bench import roofline
from bench.reference import head_dim

KERNEL = "attn_bwd"


def least_s(B: int, S: int, H: int, G: int, D: int) -> float:
    flops, _ = roofline.attn_fwd(B, S, H, G, D)
    nbytes = roofline.BF16 * B * S * D * (4 * H + 4 * G) + 2 * 4 * B * S * H
    return roofline.bound_s(2.5 * flops, nbytes)


def read(run):
    c = run.config
    calls = c["n_layers"] * run.traced.get("steps", 0)
    n, secs = run.trace.kernel_s(KERNEL)
    if not calls or not n or n % calls or secs <= 0:
        return None
    w = run.window
    least = calls * least_s(w["batch"], w["seq_len"], c["n_heads"],
                            c["n_kv_heads"], head_dim(c))
    return 100.0 * least / secs
