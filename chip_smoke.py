#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each failing the run with a non-zero exit:
  1. card    - CUDA present; the card's name and power limit (nvidia-smi)
  2. build   - compile every CUDA source of the port with nvcc
  3. kernel  - flash_attention against its plain version on the card
  4. wiring  - qwen3-4b at full width, 2 layers, f32: prefill + one decode
               step with the kernel vs with the plain reference attention
  5. serve   - the main path: JoSS routing -> prefill -> greedy decode of
               qwen3-4b at full width and depth in bf16; counts launches
  6. times   - kernel, plain version and SDPA (yardstick only) at the
               serving shapes, beside the least time the card could take
Each phase prints JSON lines; the run ends with the nvidia-smi line, the
kernels line and, last, the device line. Imports nothing of JAX or of the
JAX package.
"""
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.lm import serve  # noqa: E402

DEV = "cuda"  # the phases run on the card
# H100 SXM data sheet (dense): HBM3 rate and bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# tolerances of tests/test_kernels.py
TOL = {torch.float32: (2e-5, 1e-2), torch.bfloat16: (2e-2, 1e-2)}
# qwen3-4b serving run: 8 requests, 512 prompt tokens, 32 generated
N_REQ, PROMPT, GEN = 8, 512, 32
# logits of the f32 wiring check: flash and plain reference attention differ
# only by f32 summation order (TF32 off), so 1e-3 on O(1) logits is ample
WIRING_ATOL = 1e-3


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def rand(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


# ---------------------------------------------------------------- phase 3 --
def kernel_cases():
    """(name, B, Sq, Sk, H, G, D, causal, window, qpos, kpos, dtype)."""
    ar = lambda n, off=0: torch.arange(n, dtype=torch.int32,
                                       device=DEV) + off
    P, C = PROMPT, PROMPT + GEN
    last = P + GEN - 2                      # position of the last decode step
    ring = torch.where(ar(C) <= last, ar(C), -1).to(torch.int32)
    half = torch.where(ar(C) <= P, ar(C), -1).to(torch.int32)
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        cases += [
            ("prefill", N_REQ, P, P, 32, 8, 128, True, 0, ar(P), ar(P), dt),
            ("decode", N_REQ, 1, C, 32, 8, 128, True, 0,
             ar(1, last), ring, dt),
            ("decode_first", N_REQ, 1, C, 32, 8, 128, True, 0,
             ar(1, P), half, dt),
        ]
    cases += [
        ("window", 2, 256, 256, 4, 2, 64, True, 64, ar(256), ar(256),
         torch.float32),
        ("window_bf16", 2, 256, 256, 4, 2, 64, True, 48, ar(256), ar(256),
         torch.bfloat16),
        ("cross", 1, 128, 384, 2, 1, 64, False, 0, ar(128), ar(384),
         torch.float32),
        ("ragged", 2, 77, 203, 6, 3, 32, True, 0, ar(77, 126), ar(203),
         torch.float32),
        ("ragged_bf16", 3, 45, 100, 8, 2, 64, True, 0, ar(45, 55), ar(100),
         torch.bfloat16),
        ("masked_rows", 1, 40, 64, 2, 2, 32, True, 0, ar(40, -10),
         ar(64), torch.float32),
        ("head_dim_16", 2, 64, 64, 4, 2, 16, True, 0, ar(64), ar(64),
         torch.float32),
        ("head_dim_16_bf16", 2, 32, 96, 4, 1, 16, False, 0, ar(32), ar(96),
         torch.bfloat16),
    ]
    return cases


def phase_kernel():
    gen = torch.Generator(device=DEV).manual_seed(1)
    errs = {}
    for (name, B, Sq, Sk, H, G, D, causal, window, qpos, kpos,
         dt) in kernel_cases():
        q = rand((B, Sq, H, D), dt, gen)
        k = rand((B, Sk, G, D), dt, gen)
        v = rand((B, Sk, G, D), dt, gen)
        kw = dict(causal=causal, window=window, qpos=qpos, kpos=kpos)
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = fa.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        atol, rtol = TOL[dt]
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        excess = (diff - atol - rtol * ref.float().abs()).max().item()
        tag = f"{name}/{str(dt).split('.')[-1]}"
        emit(phase="kernel", case=tag, shape=[B, Sq, Sk, H, G, D],
             causal=causal, window=window, max_abs_err=err, atol=atol,
             rtol=rtol)
        check(excess <= 0, f"kernel disagrees with its plain version: {tag}")
        check(bool(torch.isfinite(out).all()), f"non-finite output: {tag}")
        if name == "masked_rows":  # qpos < 0: rows with no valid key are 0
            check(bool((out[:, :10] == 0).all()), "masked rows not zero")
        errs[tag] = err
    return errs


# ---------------------------------------------------------------- phase 4 --
def phase_wiring():
    cfg = get_config("qwen3-4b").scaled(n_layers=2, dtype="float32")
    B, S = 2, 128
    flash = build_model(cfg, device=DEV, attn_impl="flash")
    flash.init_params(torch.Generator(device=DEV).manual_seed(2))
    plain = build_model(cfg, device=DEV, attn_impl="ref")
    plain.load_state_dict(flash.state_dict())
    toks = torch.randint(0, cfg.vocab, (B, S + 1), device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(3))
    out = {}
    for name, model in (("flash", flash), ("ref", plain)):
        lg, cache = model.prefill({"tokens": toks[:, :S]}, cache_len=S + 4)
        ld, _ = model.decode_step(cache, toks[:, S:S + 1], S)
        out[name] = (lg[..., :cfg.vocab], ld[..., :cfg.vocab])
    torch.cuda.synchronize()
    err_pf = (out["flash"][0] - out["ref"][0]).abs().max().item()
    err_dec = (out["flash"][1] - out["ref"][1]).abs().max().item()
    emit(phase="wiring", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, prefill_max_abs_err=err_pf,
         decode_max_abs_err=err_dec, atol=WIRING_ATOL)
    check(err_pf <= WIRING_ATOL and err_dec <= WIRING_ATOL,
          "flash and reference attention disagree inside the model")
    del flash, plain, out, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 5 --
def phase_serve():
    cfg = get_config("qwen3-4b")
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    res = serve(cfg, N_REQ, PROMPT, GEN, device=DEV, seed=0)
    launches = fa.flash_attention.launches
    finite = bool(torch.isfinite(res.logits).all())
    tok_ok = bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all())
    emit(phase="serve", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, requests=N_REQ,
         prompt_len=PROMPT, gen_len=GEN,
         routes=[[d.rid, d.pod, d.policy, d.cache_hit]
                 for d in res.decisions],
         cache_hit_rate=res.cache_hit_rate,
         load_imbalance=res.load_imbalance, prefill_s=res.prefill_s,
         decode_s=res.decode_s, decode_tok_s=res.decode_tok_s,
         flash_launches=launches, expected_launches=cfg.n_layers * GEN,
         logits_shape=list(res.logits.shape), logits_finite=finite,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         tokens_req0=res.tokens[0].tolist())
    check(launches == cfg.n_layers * GEN,
          f"flash_attention launched {launches} times, expected "
          f"{cfg.n_layers} x {GEN}")
    check(finite, "non-finite logits on the serving path")
    check(tuple(res.logits.shape) == (N_REQ, GEN - 1, cfg.padded_vocab),
          "unexpected logits shape")
    check(tuple(res.tokens.shape) == (N_REQ, GEN) and tok_ok,
          "generated tokens out of shape or vocab")
    return launches


# ---------------------------------------------------------------- phase 6 --
def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(B, H, G, D, qpos, kpos, causal, itemsize):
    """Least time (ms) for the function on these inputs: bytes of q, o and
    the valid keys' k/v over HBM rate, or the valid (q, k) pairs' 4*D
    flops each over the bf16 peak, whichever is larger."""
    ok = kpos[None, :] >= 0
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    pairs = int(ok.sum().item()) * B * H
    n_keys = int((ok.any(dim=0)).sum().item())
    Sq = qpos.shape[0]
    nbytes = (2 * B * Sq * H * D + 2 * B * n_keys * G * D) * itemsize \
        + 4 * (Sq + kpos.shape[0])
    flops = 4 * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, flops


def phase_times():
    gen = torch.Generator(device=DEV).manual_seed(4)
    cfg = get_config("qwen3-4b")
    dt, H, G, D, L = (torch.bfloat16, cfg.n_heads, cfg.n_kv_heads, cfg.hdim,
                      cfg.n_layers)
    P, C = PROMPT, PROMPT + GEN
    ar = torch.arange(C, dtype=torch.int32, device=DEV)
    last = P + GEN - 2                      # position of the last decode step
    shapes = {
        # name: (Sq, Sk, qpos, kpos, calls per serving run, buffers, iters)
        "prefill": (P, P, ar[:P], ar[:P], L, 2, 50),
        # several K/V buffers in turn, as the layers' caches are: the 18 MB
        # of one would otherwise stay in the 50 MB L2 between launches
        "decode": (1, C, ar[last:last + 1],
                   torch.where(ar <= last, ar, -1).to(torch.int32),
                   L * (GEN - 1), 8, 400),
    }
    per = {}
    for name, (Sq, Sk, qpos, kpos, n_calls, nbuf, iters) in shapes.items():
        bufs = [(rand((N_REQ, Sq, H, D), dt, gen),
                 rand((N_REQ, Sk, G, D), dt, gen),
                 rand((N_REQ, Sk, G, D), dt, gen)) for _ in range(nbuf)]
        # SDPA wants (B, H, S, D); the transposed copies are made untimed
        sdpa_bufs = [tuple(t.transpose(1, 2).contiguous() for t in qkv)
                     for qkv in bufs]
        mask = (kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
        kw = dict(causal=True, window=0, qpos=qpos, kpos=kpos)
        sdpa_kw = (dict(is_causal=True) if name == "prefill"
                   else dict(attn_mask=mask))
        kern_in, plain_in = itertools.cycle(bufs), itertools.cycle(bufs)
        lib_in = itertools.cycle(sdpa_bufs)
        ms = time_ms(lambda: fa.flash_attention(*next(kern_in), **kw), iters)
        plain_ms = time_ms(
            lambda: fa.flash_attention_ref(*next(plain_in), **kw),
            max(10, iters // 10))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            *next(lib_in), enable_gqa=True, **sdpa_kw), iters)
        b_ms, b_by, nbytes, flops = bound(N_REQ, H, G, D, qpos, kpos,
                                          True, 2)
        per[name] = dict(shape=[N_REQ, Sq, Sk, H, G, D], dtype="bfloat16",
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=b_by,
                         bytes=nbytes, flops=flops,
                         launches_per_serving_run=n_calls)
        emit(phase="times", kernel="flash_attention", at=name, **per[name])
        del bufs, sdpa_bufs
    torch.cuda.empty_cache()
    return per


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    # f32 comparisons need full f32 matmuls: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    emit(phase="card", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32=False)

    t0 = time.perf_counter()
    libs = build.build_all()
    ptxas = [ln.strip() for p in libs
             for ln in p.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=[p.name for p in libs], ptxas=ptxas)

    errs = phase_kernel()
    phase_wiring()
    launches = phase_serve()
    per = phase_times()

    def total(key):
        return sum(per[s][key] * per[s]["launches_per_serving_run"]
                   for s in per)

    t_bytes = sum(per[s]["bytes"] * per[s]["launches_per_serving_run"]
                  for s in per) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(per[s]["flops"] * per[s]["launches_per_serving_run"]
                for s in per) / BF16_FLOP_PER_S * 1e3
    print(smi, flush=True)
    # times are totals over one serving run's attention calls (36 at the
    # prefill shape, 36 x 31 at the decode shape); per_call has each shape
    emit(kernels=[{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:27",
        "launches": launches,
        "max_abs_err": max(errs["prefill/bfloat16"], errs["decode/bfloat16"]),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": total("library_ms"),
        "per_call": {s: {k: per[s][k] for k in
                         ("ms", "plain_ms", "library_ms", "bound_ms",
                          "bound_by", "launches_per_serving_run")}
                     for s in per},
    }])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
