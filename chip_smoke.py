#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each failing the run with a non-zero exit:
  1. card    - CUDA present; the card's name and power limit (nvidia-smi)
  2. build   - compile every CUDA source of the port with nvcc, in parallel
  mapreduce  - the MapReduce data plane (the paper's FP measurement): the
               five jobs on the card against the CPU on a 2^20-token shard
               of each corpus kind (equal keys and counts, bit-equal FP),
               then 4 shards of one 128 MiB HDFS block per kind: FP mean
               and std, tokens/s, the paper's observations
  fill       - the batched progressive fill kernel's two variants (reg,
               the chosen one, and smem, the first design) against its
               plain version on the card and the scalar reference on the
               CPU, bit for bit, on fill problems captured from the
               simulator and on boundary corpora made from a seed; both
               variants timed in turns on two batches of 64 problems
  lockstep   - the scheduler's lockstep sweep (480 cells) through the fill
               kernel against the scalar inline path; launches by variant
  3. kernel  - flash_attention (each case on the kernel the wrapper
               chooses, tc / split / simt; split at several n_split; the
               simt kernel also at the bf16 serving shapes) and gla_scan
               (bf16 cases on tc and on simt, f32 cases on simt) against
               their plain versions on the card, at the serving and
               training shapes of every family and at edge cases
  4. wiring  - qwen3-4b, rwkv6-7b, hymba-1.5b, dbrx-132b, internvl2-26b
               and whisper-medium at full width, 1-2 layers, f32: prefill
               + one decode step with the kernels vs with the plain
               versions (attn_impl="ref"/"chunked", gla_impl="chunked");
               and rwkv6-7b and hymba-1.5b in bf16, gla_impl="kernel" (the
               tc kernel) vs "chunked", beside two control readings: the
               plain model with a GLA scan broken on purpose
  5. serve   - the main paths: JoSS routing -> prefill -> greedy decode of
               qwen3-4b, rwkv6-7b, hymba-1.5b, internvl2-26b and
               whisper-medium at full width and depth, dbrx-132b (8 of 40
               layers) and arctic-480b (2 of 35) at full width, bf16;
               counts each kernel's launches in each run, and the launches
               by variant (flash: prefill tc, decode split; GLA: tc)
  6. times   - each kernel, its plain version and (for attention) SDPA as
               a yardstick, at the serving shapes, beside the least time
               the card could take: eager calls timed by CUDA events (ms)
               and the host's cost a call, and in CUDA graphs (device_ms);
               the chosen kernel and the simt kernel (the first design) in
               turns in the same run
  7. grad    - gradients through the kernels' autograd Functions (kernel
               forward, the caller's plain backward) against autograd of
               the plain functions, at the serving and training shapes and
               a ragged one; the raw wrappers must refuse grad-requiring
               inputs
  8. train_wiring - qwen3-4b and hymba-1.5b at full width, 2 layers, f32:
               loss, every gradient and three make_train_step steps with
               the kernels vs the all-plain model (attn_impl="chunked",
               gla_impl="chunked") from the same weights, beside a
               control with attention's q/k/v gradients zeroed
  9. train   - the training main paths in bf16: qwen3-4b, hymba-1.5b and
               whisper-medium at full width and depth, rwkv6-7b at 8
               layers, each on batches of the JoSS policy-B pipeline (and
               whisper's seeded audio frames) and then one batch repeated
               (its loss must fall); launches counted per run, one step
               profiled; then qwen3-4b at 4 layers: n_micro 2 vs 1, int8
               compression, a checkpoint round trip
Each phase prints JSON lines; the run ends with the nvidia-smi line, the
kernels line and, last, the device line. Imports nothing of JAX or of the
JAX package.
"""
import dataclasses
import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import mapreduce as mr  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.topology import VirtualCluster  # noqa: E402
from repro_torch.data import JossDataPipeline, TokenStore  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import fill as fk  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gla_scan as gs  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.autograd import BACKWARD_SPANS  # noqa: E402
from repro_torch.models import (build_model, prefix_len,  # noqa: E402
                                side_inputs)
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models.recurrence import gla_chunked  # noqa: E402
from repro_torch.serve.lm import serve  # noqa: E402
from repro_torch.sweep import lockstep  # noqa: E402
from repro_torch.sweep import vmap_fill as vf  # noqa: E402
from repro_torch.train import (OptConfig, TrainConfig, adamw_init,  # noqa: E402
                               init_train_state, make_train_step)
from repro_torch.train.checkpoint import AsyncCheckpointer  # noqa: E402
from repro_torch.train.checkpoint import restore as ckpt_restore  # noqa: E402

DEV = "cuda"  # the phases run on the card
# H100 SXM data sheet (dense): HBM3 rate and bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# float64 outside the tensor cores (the fill kernel's arithmetic)
FP64_FLOP_PER_S = 34e12
# tolerances of tests/test_kernels.py: flash (atol, rtol), then GLA
TOL = {torch.float32: (2e-5, 1e-2), torch.bfloat16: (2e-2, 1e-2)}
GLA_TOL = {torch.float32: (7e-4, 2e-3), torch.bfloat16: (0.15, 5e-2)}
# the serving runs (the main paths): arch -> (requests, prompt, generated).
# hymba's prompt is twice its 1024-token window, so the window, the ring
# wrap and the unsorted ring kpos are all on its path
SERVE = {"qwen3-4b": (8, 512, 32), "rwkv6-7b": (8, 512, 32),
         "hymba-1.5b": (8, 2048, 32), "dbrx-132b": (8, 512, 32),
         "arctic-480b": (8, 512, 32), "internvl2-26b": (8, 512, 32),
         "whisper-medium": (8, 224, 32)}
# depth cut only where one card forces it, bf16: 8 of dbrx-132b's 40
# layers (6.5 GB each) and 2 of arctic-480b's 35 (27.3 GB each) fill ~55
# GB; internvl2-26b (~40 GB, its vision frontend a stub) and
# whisper-medium run at full depth
SERVE_LAYERS = {"dbrx-132b": 8, "arctic-480b": 2}
# whisper-medium: 30 s of audio, 3000 log-mel frames (1500 encoder
# positions), a prompt of half its 448-token text context; internvl2-26b's
# 256 patch tokens come ahead of its 512-token prompt
SERVE_FRAMES = {"whisper-medium": 3000}
# logits of the f32 wiring checks: the kernels and the plain versions
# differ only by f32 summation order (TF32 off), so 1e-3 on O(1) logits is
# ample
WIRING_ATOL = 1e-3
# logits of the bf16 GLA wiring checks, as ||kernel - plain|| / ||plain||
# over all logits: the tc kernel's y is a few bf16 ulps from the plain
# version's, which moved two layers' logits by 1.0-1.6% on an H100
# (PERF.md); 5e-2 leaves three times that. Each bf16 line also reads two
# wrong GLA scans in the plain model (CONTROLS), the first of which must
# land above the limit, or the line could not fail
WIRING_BF16_RTOL = 5e-2


def n_sm() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def rand(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def ar(n, off=0):
    return torch.arange(n, dtype=torch.int32, device=DEV) + off


def ring_kpos(C, last):
    """kpos of a C-slot ring after positions 0..last: slot p % C holds the
    newest p, -1 where nothing was written."""
    kpos = torch.full((C,), -1, dtype=torch.int32, device=DEV)
    p = ar(min(C, last + 1), max(0, last + 1 - C))
    kpos[p % C] = p
    return kpos


def within(out, ref, atol, rtol):
    """(max abs error, whether every element is within atol + rtol|ref|)."""
    diff = (out.float() - ref.float()).abs()
    excess = (diff - atol - rtol * ref.float().abs()).max().item()
    return diff.max().item(), excess <= 0


def serve_cfg(arch):
    """The serving run's config: the arch's, cut to SERVE_LAYERS."""
    cfg = get_config(arch)
    return cfg.scaled(n_layers=SERVE_LAYERS[arch]) if arch in SERVE_LAYERS \
        else cfg


def attn_calls(cfg):
    """Attention calls (a forward over a sequence, a decode step): one a
    layer, and for encdec one an encoder layer and two a decoder layer
    (self- and cross-attention); none for rwkv6."""
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    return cfg.n_layers, cfg.n_layers


def with_side(cfg, batch, seed, n_frames=None):
    """``batch`` plus the family's side inputs (encdec frames, vlm
    patches), drawn by ``models.side_inputs``, on the card in cfg's
    dtype."""
    B = batch["tokens"].shape[0]
    for name, x in side_inputs(cfg, B, seed=seed, n_frames=n_frames).items():
        batch[name] = torch.as_tensor(x, device=DEV).to(cfg.tdtype)
    return batch


# ------------------------------------------------------------ mapreduce --
# the MapReduce data plane, the paper's FP measurement: the card against
# the CPU on one shard of 2^20 tokens per corpus kind (keys, counts and
# n_unique equal, FP bit-equal), then the real size: per kind, shards of
# one 128 MiB HDFS block each (Hadoop 2's default dfs.blocksize) at the
# kind's mean word length, every int32 byte sum below 2^31
MR_EQ_TOKENS = 1 << 20
MR_SHARDS, MR_BLOCK_BYTES = 4, 128 << 20
MR_KINDS = ("web", "non-web")


def host_runs(fn, runs=3):
    """Host seconds of each of ``runs`` calls of ``fn``, whose result is on
    the host (so each call ends when the card is done)."""
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def block_shard(kind, seed, mean_len):
    """A shard of ``kind`` whose word bytes fill one block: the longest
    prefix of a seeded corpus within MR_BLOCK_BYTES (a corpus's prefix does
    not depend on how many tokens were drawn)."""
    n = int(1.2 * MR_BLOCK_BYTES / mean_len)
    tok, lng = mr.corpus(kind, n, seed=seed)
    cut = int(np.searchsorted(np.cumsum(lng, dtype=np.int64), MR_BLOCK_BYTES,
                              side="right"))
    check(cut < n, f"a {kind} corpus of {n} tokens does not fill a block")
    return tok[:cut], lng[:cut]


def phase_mapreduce():
    mean_len = {}
    for kind in MR_KINDS:
        tok, lng = mr.corpus(kind, MR_EQ_TOKENS, seed=2000)
        mean_len[kind] = float(lng.mean())
        host = (torch.from_numpy(tok), torch.from_numpy(lng))
        card = tuple(t.to(DEV) for t in host)
        for name, spec in mr.JOBS.items():
            (kc, vc, nc), (kg, vg, ng) = (mr.local_mapreduce(spec, *x)
                                          for x in (host, card))
            fc, fg = (mr.measure_fp(spec, t[None], l[None])
                      for t, l in (host, card))
            equal = (int(nc) == int(ng) and torch.equal(kc, kg.cpu())
                     and torch.equal(vc, vg.cpu()))
            bits = bool((fc.view("int32") == fg.view("int32")).all())
            emit(phase="mapreduce", check="cuda_vs_cpu", kind=kind, job=name,
                 tokens=MR_EQ_TOKENS, n_unique=int(ng),
                 keys_counts_equal=equal, fp=float(fg[0]), fp_bit_equal=bits)
            check(equal and bits, f"mapreduce {name} on {kind}: the card "
                                  f"and the CPU disagree")
    fp = {}
    for kind in MR_KINDS:
        t0 = time.perf_counter()
        shards = [block_shard(kind, 3000 + s, mean_len[kind])
                  for s in range(MR_SHARDS)]
        corpus_s = time.perf_counter() - t0
        # shards of one block differ in length by a few words: a batch of
        # shards is padded to the longest with token -1, which every job
        # ignores and FP does not count
        n = max(len(t) for t, _ in shards)
        st = torch.full((MR_SHARDS, n), -1, dtype=torch.int32)
        sl = torch.zeros((MR_SHARDS, n), dtype=torch.int32)
        for i, (t, l) in enumerate(shards):
            st[i, :len(t)] = torch.from_numpy(t)
            sl[i, :len(l)] = torch.from_numpy(l)
        st, sl = st.to(DEV), sl.to(DEV)
        block = [int(l.sum()) for _, l in shards]
        tokens = [len(t) for t, _ in shards]
        del shards
        for name, spec in mr.JOBS.items():
            fps = mr.measure_fp(spec, st, sl)          # returns on the host
            uniq = [int(mr.local_mapreduce(spec, t, l)[2])
                    for t, l in zip(st, sl)]
            # then timed, warm: the first calls also grow the allocator's
            # pool to this job's sizes
            fp_s = host_runs(lambda: mr.measure_fp(spec, st, sl))
            mr_s = host_runs(lambda: [int(mr.local_mapreduce(spec, t, l)[2])
                                      for t, l in zip(st, sl)])
            fp[(name, kind)] = (float(np.mean(fps)), float(np.std(fps)))
            emit(phase="mapreduce", check="real_size", kind=kind, job=name,
                 shards=MR_SHARDS, tokens_per_shard=tokens,
                 block_bytes=block,
                 corpus_host_s=corpus_s, fp=fps.tolist(),
                 fp_mean=fp[(name, kind)][0], fp_std=fp[(name, kind)][1],
                 max_byte_sum=int(float(fps.max()) * max(block)),
                 fp_s_runs=fp_s,
                 fp_tokens_per_s=sum(tokens) / statistics.median(fp_s),
                 mapreduce_s_runs=mr_s,
                 mapreduce_tokens_per_s=(sum(tokens)
                                         / statistics.median(mr_s)),
                 n_unique=uniq)
            check(bool(np.isfinite(fps).all())
                  and float(fps.max()) * max(block) < 2 ** 31,
                  f"mapreduce {name} on {kind}: FP or byte sums out of "
                  f"range")
        del st, sl
        torch.cuda.empty_cache()
    # benchmarks/bench_filtering.py's paper observations, at the real size
    obs = {"grep_web_below_0.5": fp[("Grep", "web")][0] < 0.5,
           "permu_non_web_near_3": abs(fp[("Permu", "non-web")][0] - 3.0)
           < 0.3,
           "std_under_20pct_but_grep": all(
               sd < 0.2 * max(mean, 1e-9) for (job, _), (mean, sd)
               in fp.items() if job != "Grep")}
    emit(phase="mapreduce", check="paper_observations", **obs)
    check(all(obs.values()), f"the paper's FP observations fail at the "
                             f"128 MiB block size: {obs}")


# ----------------------------------------------------------------- fill --
# the batched progressive fill kernel against its plain version, both on
# the card, and against the scalar fill_reference on the CPU, on fill
# problems captured from the port's own simulator: two cells of the
# lockstep gate point (8 pods x 8 hosts, 24 jobs), a 16-pod cell whose 33
# links pass the JAX solver's link floor of 24 (and whose classes pass its
# class floor of 48), and the degenerate snapshots of the CPU tests
FILL_CELLS = {
    "gate_joss-t_oversub8": ("joss-t", "oversub8", 24, (8,) * 8),
    "gate_fifo_oversub24": ("fifo", "oversub24", 24, (8,) * 8),
    "gate_fifo_uncontended": ("fifo", "uncontended", 24, (8,) * 8),
    "pods16_fifo_oversub24": ("fifo", "oversub24", 48, (8,) * 16),
}
FILL_LIMIT = 3000
FILL_FLOORS = {"classes": 48, "links": 24}
# the timed batches: 64 problems of a gate-point corpus past INLINE_C (the
# executor's gang, and the problems it sends to the kernel)
FILL_BATCH, FILL_ITERS = 64, 200
FILL_TIMED = {"contended": "gate_fifo_oversub24",
              "uncontended": "gate_fifo_uncontended"}


def _snap(links, *classes):
    return {"links": links,
            "classes": [{"path": path, "cap": cap, "n": n, "vdone": vd,
                         "target": tg} for path, cap, n, vd, tg in classes]}


FILL_DEGENERATE = [
    _snap([["wan", 0, 10.0]]),
    _snap([["wan", 0, 6.0]], ([["wan", 0]], 100.0, 1, 1.0, 4.0)),
    _snap([["wan", 0, 100.0]], ([["wan", 0]], 2.0, 2, 0.0, 8.0),
          ([["wan", 0]], 3.0, 1, 1.0, None)),
    _snap([["wan", 0, 10.0]], ([["wan", 0]], 100.0, 1, 0.0, 5.0),
          ([["wan", 0]], 100.0, 1, 2.5, 5.0)),
    _snap([["wan", 0, 10.0]], ([["wan", 0]], 2.0, 1, 0.0, 4.0),
          ([["wan", 0]], 100.0, 1, 0.0, None)),
    _snap([["down", 0, 1e6], ["wan", 0, 29.37]],
          ([["down", 0], ["wan", 0]], 1.667, 4, 0.0, 3.0),
          ([["wan", 0]], 1.667, 4, 0.0, 2.0),
          ([["wan", 0]], 1000.0, 3, 0.0, 9.0)),
    _snap([["down", 0, 7.3], ["wan", 0, 9.1]],
          ([["down", 0], ["wan", 0]], 1.7, 2, 0.0, 3.0),
          ([["wan", 0]], 1.7, 1, 0.5, 2.0),
          ([["down", 0]], 50.0, 3, 0.0, 9.0)),
]


# boundary corpora, made from a seed: (C classes, L links) at the edges of
# the reg kernel's templates (64 classes a word, 32 links a lane) and at its
# largest shape
FILL_BOUNDARY_C = (63, 64, 65, 129)
FILL_BOUNDARY_L = (31, 32, 33, 65)
FILL_BOUNDARY_TOP = (256, 128)


def boundary_snaps(C, L, seed):
    """Four snapshots padded to (C, L) in one batch: random classes of 1-3
    links; one where class 0 crosses every link and every class crosses
    link 0; one of equal link capacities and equal class caps (ties); and a
    padded row of about half the classes and links. Caps of about half the
    classes fall below their links' shares, so both cap and link rounds
    run."""
    rng = np.random.default_rng(seed)

    def snap(nc, nl, full=False, ties=False):
        caps = np.full(nl, 60.0) if ties else rng.uniform(5.0, 100.0, nl)
        classes = []
        for c in range(nc):
            k = int(rng.integers(1, min(3, nl) + 1))
            path = set(rng.choice(nl, size=k, replace=False).tolist())
            if full:
                path = set(range(nl)) if c == 0 else path | {0}
            cap = (3.0 if ties else float(rng.uniform(0.2, 8.0))
                   if rng.random() < 0.5 else 1000.0)
            vdone = float(rng.uniform(0.0, 5.0))
            target = (None if rng.random() < 0.2
                      else vdone + float(rng.uniform(1.0, 50.0)))
            classes.append(([["l", i] for i in sorted(path)], cap,
                            int(rng.integers(1, 5)), vdone, target))
        return _snap([["l", i, float(cap)] for i, cap in enumerate(caps)],
                     *classes)

    return [snap(C, L), snap(C, L, full=True), snap(C, L, ties=True),
            snap(C // 2 + 1, L // 2 + 1)]


def fill_boundary_corpora(seed=18):
    """name -> snapshots, for every pair of FILL_BOUNDARY_C x
    FILL_BOUNDARY_L and for FILL_BOUNDARY_TOP."""
    shapes = [*itertools.product(FILL_BOUNDARY_C, FILL_BOUNDARY_L),
              FILL_BOUNDARY_TOP]
    return {f"boundary_C{C}_L{L}": boundary_snaps(C, L, seed + i)
            for i, (C, L) in enumerate(shapes)}


def tied_ranks(cap_rank, n, seed):
    """Ranks that keep each row's order of (cap_rank, index) over its live
    classes (n > 0) but are not integers and often tie: a class whose index
    is above the one before it in that order may take its rank (the lower
    index wins the tie). The fill, and so its answers, do not change."""
    rng = np.random.default_rng(seed)
    out = np.array(cap_rank, dtype=np.float64)
    for r in range(out.shape[0]):
        live = np.flatnonzero(n[r] > 0)
        order = live[np.lexsort((live, cap_rank[r, live]))]
        v = 0.5
        for i, c in enumerate(order):
            if i and not (c > order[i - 1] and rng.random() < 0.5):
                v += 0.37
            out[r, c] = v
    return out


def fill_args(snaps):
    """The kernel's inputs for a batch of snapshots, on the card."""
    p = vf.PackedProblems(snaps)
    arrays = (p.caps, p.members.astype(np.uint8), p.n, p.fcap, p.cap_rank,
              p.target - p.vdone)
    return p, tuple(torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
                    for a in arrays)


def fill_problem(snap):
    """A ``NetworkFabric.fill_problem()`` dict from a snapshot."""
    p = vf.PackedProblems([snap])
    C = max(1, len(snap["classes"]))
    L = max(1, len(snap["links"]))
    return {"caps": p.caps[0, :L], "members": p.members[0, :C, :L],
            "n": p.n[0, :C], "fcap": p.fcap[0, :C],
            "cap_rank": p.cap_rank[0, :C],
            "remaining": p.target[0, :C] - p.vdone[0, :C]}


def fill_work(args):
    """(bytes, float64 operations, rounds) of one kernel call on these
    inputs: every input read once (members as bytes) and rates, dt and
    status written once; per problem C L for the member counts, for each
    of its rounds 3 L + 2 C (shares, the least share, the next cap, the
    newly fixed), C L over the whole fill for the debits' sums, and 2 C
    for dt."""
    caps, members, n, fcap, cap_rank, remaining = args
    S, C, L = members.shape
    nbytes = (8 * S * L + S * C * L + 4 * 8 * S * C) + 8 * (S * C + 2 * S)
    rounds = int(fk.fill_rounds(caps, members, n, fcap, cap_rank).sum())
    ops = S * (2 * C * L + 2 * C) + rounds * (3 * L + 2 * C)
    return nbytes, ops, rounds


def phase_fill():
    out = {"max_abs_err": 0.0}
    corpora = {}
    for name, (algo, scen, n_jobs, hosts) in FILL_CELLS.items():
        t0 = time.perf_counter()
        corpora[name] = vf.contention_snapshots(
            algo, scen, n_jobs=n_jobs, hosts_per_pod=hosts, limit=FILL_LIMIT)
        emit(phase="fill", corpus=name, captured=len(corpora[name]),
             capture_host_s=time.perf_counter() - t0)
    corpora["degenerate"] = FILL_DEGENERATE
    corpora.update(fill_boundary_corpora())
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=DEV)
    for name, snaps in corpora.items():
        ref = vf.batched_fill_reference(snaps)          # scalar, on the CPU
        p, args = fill_args(snaps)
        S, C, L = p.members.shape
        # the boundary corpora also run with ranks that tie and are not
        # integers but keep the order, so the reference's answers hold; and
        # with n halved, which the reg kernel sums class by class (not over
        # bit planes), held to the plain version alone
        caps, members, n, fcap, cap_rank, remaining = args
        cases = {"packed": (n, cap_rank)}
        if name.startswith("boundary"):
            cases["tied"] = (n, torch.from_numpy(
                tied_ranks(p.cap_rank, p.n, seed=7)).to(DEV))
            cases["half_n"] = (n * 0.5, cap_rank)
        for inputs, (n_in, rank_in) in cases.items():
            a = (caps, members, n_in, fcap, rank_in, remaining)
            p_rates, p_dt = fk.fill_rates_dt_ref(*a)
            line = dict(phase="fill", corpus=name, inputs=inputs, problems=S,
                        classes=C, links=L,
                        class_floor=FILL_FLOORS["classes"],
                        link_floor=FILL_FLOORS["links"],
                        beyond_floors=[C > FILL_FLOORS["classes"],
                                       L > FILL_FLOORS["links"]],
                        chosen=fk.choose_variant(C, L))
            for v in fk.VARIANTS:
                rates, dt = fk.fill_rates_dt(*a, variant=v)
                torch.cuda.synchronize()
                plain_equal = (torch.equal(rates, p_rates)
                               and torch.equal(dt, p_dt))
                ref_equal = None if inputs == "half_n" else (
                    np.array_equal(rates.cpu().numpy(), ref["rates"])
                    and np.array_equal(dt.cpu().numpy(), ref["dt_next"]))
                err = float((rates - p_rates).abs().max())
                out["max_abs_err"] = max(out["max_abs_err"], err)
                check(plain_equal and ref_equal is not False,
                      f"fill kernel ({v}) on {name} ({inputs}): not "
                      f"bit-equal to its plain version and the scalar "
                      f"reference")
                # control: every link capacity and every class cap one ulp
                # up (a rate is a share of some link's capacity or a
                # class's cap) must move some rate or dt, and the
                # comparison must see it
                c_rates, c_dt = fk.fill_rates_dt(
                    torch.nextafter(caps, inf), members, n_in,
                    torch.nextafter(fcap, inf), rank_in, remaining,
                    variant=v)
                caught = not (torch.equal(c_rates, rates)
                              and torch.equal(c_dt, dt))
                check(caught, f"fill control ({v}) on {name}: one ulp of "
                              f"every capacity moved nothing")
                line[v] = dict(max_abs_err=err, bit_equal_plain=plain_equal,
                               bit_equal_reference=ref_equal,
                               control_caught=caught)
            emit(**line)
    check(max(len(s["classes"]) for s in corpora["pods16_fifo_oversub24"])
          > FILL_FLOORS["classes"], "no fill corpus passed the class floor")
    # the timed batches: warm eager launches by CUDA events (ms, the host's
    # cost a launch beside it) and in a CUDA graph (device_ms), of the
    # chosen kernel (reg) and the first design (smem_*) in turns, reg, smem,
    # smem, reg, each the lesser of its two readings; the plain version;
    # and the solver a call: pack, copy in, launch, copy out, wait. The
    # contended batch is the kernels line's; the uncontended one, where
    # every class is capped, takes one round a class. The batch takes as
    # long as its longest problem, so us_per_round is device_ms over the
    # most rounds any of its problems takes
    for name, cell in FILL_TIMED.items():
        sel = [s for s in corpora[cell]
               if len(s["classes"]) > lockstep.INLINE_C][:FILL_BATCH]
        check(len(sel) == FILL_BATCH, f"too few {cell} fill problems")
        p, args = fill_args(sel)
        S, C, L = p.members.shape
        chosen = fk.choose_variant(C, L)
        res = torch.empty(S * C + 2 * S, dtype=torch.float64, device=DEV)
        runs = {v: {"ms": [], "host_us": [], "device_ms": []}
                for v in fk.VARIANTS}
        for v in ("reg", "smem", "smem", "reg"):
            def fn(v=v):
                fk.launch(*args, res, variant=v)
            ms, host_us = time_ms(fn, FILL_ITERS)
            runs[v]["ms"].append(ms)
            runs[v]["host_us"].append(host_us)
            runs[v]["device_ms"].append(graph_ms(fn, 20, 10))
        times = {}
        for v, got in runs.items():
            prefix = "" if v == chosen else f"{v}_"
            for key, vals in got.items():
                times[prefix + key] = min(vals)
                times[prefix + key + "_runs"] = vals
        plain_ms, plain_host_us = time_ms(
            lambda: fk.fill_rates_dt_ref(*args), 20)
        probs = [fill_problem(s) for s in sel]
        solver = vf.BatchedFillSolver()
        solve_s = host_runs(lambda: solver.solve(probs), FILL_ITERS)
        nbytes, ops, rounds = fill_work(args)
        max_rounds = int(fk.fill_rounds(*args[:5]).max())
        bound, bound_by = least_ms(nbytes, ops, FP64_FLOP_PER_S)
        out[name] = dict(
            corpus=cell, shape=[S, C, L], variant=chosen, **times,
            us_per_round=times["device_ms"] * 1e3 / max_rounds,
            smem_us_per_round=times["smem_device_ms"] * 1e3 / max_rounds,
            plain_ms=plain_ms, plain_host_us=plain_host_us,
            solver_call_ms=statistics.median(solve_s) * 1e3, bytes=nbytes,
            ops=ops, rounds=rounds, max_rounds=max_rounds, bound_ms=bound,
            bound_by=bound_by)
        emit(phase="fill", timed=name, iters=FILL_ITERS, **out[name],
             library="none: no PyTorch call computes a progressive fill")
    return out


# ------------------------------------------------------------- lockstep --
def phase_lockstep():
    """The lockstep gate matrix (480 cells) on the card, batched through the
    fill kernel, against the scalar inline path in the same process; the
    fill kernel's launch counts are read around the run."""
    fk.fill_rates_dt.launches = 0
    fk.fill_rates_dt.launches_by_variant = {v: 0 for v in fk.VARIANTS}
    r = lockstep.run_gate(lockstep.GATE_SEEDS, device=DEV, profile=True)
    launches = fk.fill_rates_dt.launches
    by_variant = dict(fk.fill_rates_dt.launches_by_variant)
    bench = json.loads((Path(__file__).resolve().parent
                        / "BENCH_sweep.json").read_text())
    want_sha = bench["lockstep"]["aggregate_sha256"]
    b = r["batched"]
    emit(phase="lockstep", cells=r["cells"], device=r["device"],
         batched=b, scalar=r["scalar"], deferred=r["deferred"],
         profile=r["profile"], launches=launches,
         launches_by_variant=by_variant,
         cells_equal=r["cells_equal"],
         cells_differing=r["cells_differing"],
         deferred_equal=r["deferred_equal"],
         aggregate_equal=r["aggregate_equal"],
         aggregate_sha256=r["aggregate_sha256"],
         bench_sha256=want_sha)
    check(r["cells_equal"] and r["aggregate_equal"] and r["deferred_equal"]
          and r["profile"]["equal"],
          "lockstep on the card differs from the scalar path")
    check(r["aggregate_sha256"] == want_sha
          and r["scalar_aggregate_sha256"] == want_sha,
          "lockstep aggregate sha differs from BENCH_sweep.json's")
    want = b["batches"] + r["profile"]["batches"]
    check(launches == want and b["batches"] > 0,
          f"fill kernel launches {launches} != batches {want}")
    check(by_variant == {"reg": launches, "smem": 0},
          f"fill launches on the gate runs not all reg: {by_variant}")
    return r, launches, by_variant


# ---------------------------------------------------------------- phase 3 --
def flash_cases():
    """(name, B, Sq, Sk, H, G, D, causal, window, qpos, kpos, dtype,
    variant): variant None is the one the wrapper chooses."""
    _, P, GEN = SERVE["qwen3-4b"]
    C = P + GEN
    last = P + GEN - 2                      # position of the last decode step
    ring = torch.where(ar(C) <= last, ar(C), -1).to(torch.int32)
    half = torch.where(ar(C) <= P, ar(C), -1).to(torch.int32)
    _, HP, HGEN = SERVE["hymba-1.5b"]
    hlast = HP + HGEN - 2
    hring = ring_kpos(1024, hlast)          # wrapped: not sorted
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for dt in (bf16, f32):
        cases += [
            ("prefill", 8, P, P, 32, 8, 128, True, 0, ar(P), ar(P), dt, None),
            ("decode", 8, 1, C, 32, 8, 128, True, 0, ar(1, last), ring, dt,
             None),
            ("decode_first", 8, 1, C, 32, 8, 128, True, 0,
             ar(1, P), half, dt, None),
            # decode: one key; keys below one tile; a ragged last tile; a row
            # with every key masked (must be exactly 0)
            ("split_sk1", 2, 1, 1, 8, 2, 64, True, 0, ar(1), ar(1), dt, None),
            ("split_short", 2, 1, 40, 8, 2, 128, True, 0, ar(1, 39), ar(40),
             dt, None),
            ("split_ragged", 3, 1, 200, 32, 8, 128, True, 0, ar(1, 199),
             ar(200), dt, None),
            ("split_all_masked", 2, 1, 300, 10, 2, 64, True, 0, ar(1, -5),
             ar(300), dt, None),
        ]
    _, TB, TS = TRAIN["qwen3-4b"][:3]
    cases += [
        # qwen3-4b's training step (forward and remat recompute)
        ("qwen3_train", TB, TS, TS, 32, 8, 128, True, 0, ar(TS), ar(TS),
         bf16, None),
        # hymba's serving shapes: 5 q heads per kv head, window 1024
        ("hymba_prefill", 8, HP, HP, 25, 5, 64, True, 1024, ar(HP), ar(HP),
         bf16, None),
        ("hymba_prefill", 2, HP, HP, 25, 5, 64, True, 1024, ar(HP), ar(HP),
         f32, None),
        ("hymba_decode", 8, 1, 1024, 25, 5, 64, True, 1024, ar(1, hlast),
         hring, bf16, None),
        ("hymba_decode", 8, 1, 1024, 25, 5, 64, True, 1024, ar(1, hlast),
         hring, f32, None),
        ("window", 2, 256, 256, 4, 2, 64, True, 64, ar(256), ar(256), f32,
         None),
        ("window_bf16", 2, 256, 256, 4, 2, 64, True, 48, ar(256), ar(256),
         bf16, None),
        ("cross", 1, 128, 384, 2, 1, 64, False, 0, ar(128), ar(384), f32,
         None),
        ("ragged", 2, 77, 203, 6, 3, 32, True, 0, ar(77, 126), ar(203), f32,
         None),
        ("ragged_bf16", 3, 45, 100, 8, 2, 64, True, 0, ar(45, 55), ar(100),
         bf16, None),
        ("masked_rows", 1, 40, 64, 2, 2, 32, True, 0, ar(40, -10),
         ar(64), f32, None),
        ("masked_rows_bf16", 1, 40, 64, 2, 2, 32, True, 0, ar(40, -10),
         ar(64), bf16, None),
        ("head_dim_16", 2, 64, 64, 4, 2, 16, True, 0, ar(64), ar(64), f32,
         None),
        ("head_dim_16_bf16", 2, 32, 96, 4, 1, 16, False, 0, ar(32), ar(96),
         bf16, None),
        # the tensor-core kernel at each head dim, 5 q heads a kv head
        # (fragments span positions), ragged Sq and Sk
        ("tc_d16", 2, 100, 100, 10, 2, 16, True, 0, ar(100), ar(100), bf16,
         None),
        ("tc_d32", 3, 77, 150, 10, 2, 32, True, 0, ar(77, 73), ar(150),
         bf16, None),
        ("tc_d64", 2, 130, 200, 10, 2, 64, True, 40, ar(130, 70), ar(200),
         bf16, None),
        ("tc_d128", 1, 200, 300, 10, 2, 128, True, 100, ar(200, 251),
         ring_kpos(300, 450), bf16, None),
    ]
    # the moe, vlm and encdec serving shapes: decode at H/G 6 (dbrx,
    # internvl2: the split kernel's 8-row block with 2 empty rows), 7
    # (arctic, 1 empty row) and 1 (whisper: the 4-row block with 3 empty
    # rows), prefill at H/G 6 and 7; whisper's encoder (non-causal bf16 at
    # D 64 on tensor cores, a ragged last tile at 1500) and its
    # cross-attention at prefill and decode (non-causal, qpos = kpos = 0)
    _, VP, VGEN = SERVE["internvl2-26b"]
    VS = get_config("internvl2-26b").vis_tokens + VP
    _, MP, MGEN = SERVE["dbrx-132b"]
    _, WP, WGEN = SERVE["whisper-medium"]
    WE = SERVE_FRAMES["whisper-medium"] // 2

    def filled(C, last):                    # a C-slot cache up to last
        return torch.where(ar(C) <= last, ar(C), -1).to(torch.int32)

    def zeros(n):                           # cross-attention positions
        return torch.zeros(n, dtype=torch.int32, device=DEV)

    vlast, mlast, wlast = VS + VGEN - 2, MP + MGEN - 2, WP + WGEN - 2
    cases += [
        ("internvl2_prefill", 8, VS, VS, 48, 8, 128, True, 0, ar(VS),
         ar(VS), bf16, None),
        ("internvl2_decode", 8, 1, VS + VGEN, 48, 8, 128, True, 0,
         ar(1, vlast), filled(VS + VGEN, vlast), bf16, None),
        ("internvl2_decode", 2, 1, VS + VGEN, 48, 8, 128, True, 0,
         ar(1, vlast), filled(VS + VGEN, vlast), f32, None),
        ("dbrx_prefill", 8, MP, MP, 48, 8, 128, True, 0, ar(MP), ar(MP),
         bf16, None),
        ("dbrx_decode", 8, 1, MP + MGEN, 48, 8, 128, True, 0, ar(1, mlast),
         filled(MP + MGEN, mlast), bf16, None),
        ("arctic_prefill", 8, MP, MP, 56, 8, 128, True, 0, ar(MP), ar(MP),
         bf16, None),
        ("arctic_decode", 8, 1, MP + MGEN, 56, 8, 128, True, 0,
         ar(1, mlast), filled(MP + MGEN, mlast), bf16, None),
        ("whisper_encoder", 8, WE, WE, 16, 16, 64, False, 0, ar(WE), ar(WE),
         bf16, None),
        ("whisper_encoder", 2, WE, WE, 16, 16, 64, False, 0, ar(WE), ar(WE),
         f32, None),
        ("whisper_prefill", 8, WP, WP, 16, 16, 64, True, 0, ar(WP), ar(WP),
         bf16, None),
        ("whisper_cross_prefill", 8, WP, WE, 16, 16, 64, False, 0,
         zeros(WP), zeros(WE), bf16, None),
        ("whisper_decode", 8, 1, WP + WGEN, 16, 16, 64, True, 0,
         ar(1, wlast), filled(WP + WGEN, wlast), bf16, None),
        ("whisper_cross_decode", 8, 1, WE, 16, 16, 64, False, 0, zeros(1),
         zeros(WE), bf16, None),
    ]
    # the simt kernel (the first design) at the bf16 serving shapes, as
    # phase 6 times it
    cases += [c[:-1] + ("simt",) for c in cases
              if c[0] in ("prefill", "decode", "hymba_prefill",
                          "hymba_decode") and c[11] == bf16]
    return cases


def split_counts(B, G, Sk):
    """The split kernel's n_split in phase 3: 1, the chosen one, and more
    ranges than tiles (empty ranges)."""
    chosen = fa.decode_splits(B, G, Sk, n_sm())
    return sorted({1, chosen, -(-Sk // fa.TILE_KEYS) + 3})


def gla_cases():
    """(name, B, T, H, K, V, u, initial state, logw, dtype). logw None is
    test_kernels.py's draw -exp(clip(randn, -3, 1)); a number is a constant
    log decay (-60, and -exp(6), RWKV6's strongest); "wide" is
    -exp(clip(2 randn, -3, 3)), whose sub-chunks of 16 steps decay by more
    than 2^64 in some places and not in others (the tc kernel's two ways to
    the pairs of a sub-chunk)."""
    f32, bf16 = torch.float32, torch.bfloat16
    exp6 = -403.4287934927351
    _, TB, TT = TRAIN["rwkv6-7b"][:3]
    return [
        # the serving shapes: rwkv6 (u-bonus) and hymba's SSM heads (no u)
        ("rwkv6_prefill", 8, 512, 64, 64, 64, True, False, None, bf16),
        # rwkv6-7b's training step
        ("rwkv6_train", TB, TT, 64, 64, 64, True, False, None, bf16),
        ("hymba_prefill", 8, 2048, 25, 16, 64, False, False, None, bf16),
        ("rwkv6_prefill", 2, 512, 64, 64, 64, True, False, None, f32),
        ("hymba_prefill", 2, 2048, 25, 16, 64, False, False, None, f32),
        ("ragged", 2, 77, 3, 16, 32, True, True, None, f32),
        ("ragged_bf16", 3, 77, 4, 64, 64, True, True, None, bf16),
        ("short", 1, 5, 2, 32, 16, True, True, None, f32),
        ("initial_state", 2, 128, 4, 64, 64, True, True, None, f32),
        ("decay_60", 1, 64, 2, 8, 8, True, False, -60.0, f32),
        ("decay_exp6", 2, 96, 4, 64, 64, True, True, -403.4287934927351,
         f32),
        ("kv_8", 2, 64, 3, 8, 8, False, False, None, f32),
        ("k32_v8_bf16", 2, 100, 2, 32, 8, False, True, None, bf16),
        # the tc kernel at the extreme decays, ragged T, initial state
        ("decay_60_bf16", 2, 77, 4, 64, 64, True, True, -60.0, bf16),
        ("decay_exp6_bf16", 2, 77, 4, 64, 64, True, True, exp6, bf16),
        ("decay_exp6_k16_bf16", 2, 77, 5, 16, 64, False, True, exp6, bf16),
        ("wide_decay_bf16", 2, 200, 4, 64, 64, True, True, "wide", bf16),
        ("wide_decay_k16_bf16", 2, 200, 5, 16, 64, False, False, "wide",
         bf16),
        # K = 8 and a single short chunk (the tc kernel pads K to 16)
        ("k8_v16_bf16", 2, 50, 3, 8, 16, True, True, None, bf16),
        ("one_chunk_bf16", 3, 20, 2, 16, 32, True, True, None, bf16),
    ]


def gla_inputs(B, T, H, K, V, use_u, init, logw_const, dt, gen):
    r = rand((B, T, H, K), dt, gen)
    k = (0.3 * torch.randn((B, T, H, K), generator=gen, device=DEV)).to(dt)
    v = rand((B, T, H, V), dt, gen)
    if logw_const is None:
        logw = -torch.exp(torch.randn((B, T, H, K), generator=gen,
                                      device=DEV).clamp(-3, 1))
    elif logw_const == "wide":
        logw = -torch.exp((2 * torch.randn((B, T, H, K), generator=gen,
                                           device=DEV)).clamp(-3, 3))
    else:
        logw = torch.full((B, T, H, K), logw_const, device=DEV)
    u = (0.1 * torch.randn((H, K), generator=gen, device=DEV)
         if use_u else None)
    s0 = (torch.randn((B, H, K, V), generator=gen, device=DEV)
          if init else None)
    return r, k, v, logw, u, s0


def phase_kernel():
    gen = torch.Generator(device=DEV).manual_seed(1)
    errs = {}
    for (name, B, Sq, Sk, H, G, D, causal, window, qpos, kpos, dt,
         variant) in flash_cases():
        q = rand((B, Sq, H, D), dt, gen)
        k = rand((B, Sk, G, D), dt, gen)
        v = rand((B, Sk, G, D), dt, gen)
        kw = dict(causal=causal, window=window, qpos=qpos, kpos=kpos)
        ref = fa.flash_attention_ref(q, k, v, **kw)
        variant = variant or fa.choose_variant(dt, Sq)
        counts = split_counts(B, G, Sk) if variant == "split" else [None]
        for n_split in counts:
            out = fa.flash_attention(q, k, v, variant=variant,
                                     n_split=n_split, **kw)
            torch.cuda.synchronize()
            atol, rtol = TOL[dt]
            err, ok = within(out, ref, atol, rtol)
            tag = f"{name}/{str(dt).split('.')[-1]}/{variant}"
            if n_split:
                tag += f"/{n_split}"
            emit(phase="kernel", kernel="flash_attention", case=tag,
                 variant=variant, n_split=n_split,
                 shape=[B, Sq, Sk, H, G, D], causal=causal, window=window,
                 max_abs_err=err, atol=atol, rtol=rtol)
            check(ok, f"flash_attention disagrees with its plain version: "
                      f"{tag}")
            check(bool(torch.isfinite(out).all()), f"non-finite output: "
                                                   f"{tag}")
            if name.startswith("masked_rows"):  # qpos < 0: no valid key
                check(bool((out[:, :10] == 0).all()), f"masked rows not "
                                                      f"zero: {tag}")
            if name == "split_all_masked":
                check(bool((out == 0).all()), f"masked row not zero: {tag}")
            errs[f"flash_attention:{tag}"] = err
            del out
        del q, k, v, ref
    for (name, B, T, H, K, V, use_u, init, logw_const,
         dt) in gla_cases():
        r, k, v, logw, u, s0 = gla_inputs(B, T, H, K, V, use_u, init,
                                          logw_const, dt, gen)
        y_ref, s_ref = gs.gla_scan_ref(r, k, v, logw, u, initial_state=s0)
        torch.cuda.synchronize()
        runs = ("tc", "simt") if dt == torch.bfloat16 else ("simt",)
        for variant in runs:
            y, s = gs.gla_scan(r, k, v, logw, u, initial_state=s0,
                               variant=variant)
            torch.cuda.synchronize()
            atol, rtol = GLA_TOL[dt]
            err_y, ok_y = within(y, y_ref, atol, rtol)
            err_s, ok_s = within(s, s_ref, atol, rtol)
            tag = f"{name}/{str(dt).split('.')[-1]}/{variant}"
            emit(phase="kernel", kernel="gla_scan", case=tag,
                 variant=variant, shape=[B, T, H, K, V],
                 u=use_u, initial_state=init, logw=logw_const,
                 y_max_abs_err=err_y, state_max_abs_err=err_s, atol=atol,
                 rtol=rtol)
            check(ok_y and ok_s, f"gla_scan disagrees with its plain "
                                 f"version: {tag}")
            check(bool(torch.isfinite(y).all() and torch.isfinite(s).all()),
                  f"non-finite gla_scan output: {tag}")
            check(y.dtype == v.dtype and s.dtype == torch.float32,
                  f"gla_scan output dtypes: {tag}")
            errs[f"gla_scan:{tag}"] = max(err_y, err_s)
            del y, s
        del r, k, v, logw, y_ref, s_ref
    torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------- phase 4 --
WIRING = [
    # (arch, dtype, B, S, kernel build kwargs, plain build kwargs); 2
    # layers unless WIRING_CUT says otherwise
    ("qwen3-4b", "float32", 2, 128, dict(attn_impl="flash"),
     dict(attn_impl="ref")),
    ("rwkv6-7b", "float32", 2, 128, dict(gla_impl="kernel"),
     dict(gla_impl="chunked")),
    # S = 2 x window: the plain side takes the banded path, the decode
    # step sees the wrapped 1024-slot ring
    ("hymba-1.5b", "float32", 2, 2048,
     dict(attn_impl="flash", gla_impl="kernel"),
     dict(attn_impl="ref", gla_impl="chunked")),
    # bf16: the GLA scan on the tc kernel against gla_chunked, attention
    # the same on both sides
    ("rwkv6-7b", "bfloat16", 2, 128, dict(gla_impl="kernel"),
     dict(gla_impl="chunked")),
    ("hymba-1.5b", "bfloat16", 2, 2048,
     dict(attn_impl="flash", gla_impl="kernel"),
     dict(attn_impl="flash", gla_impl="chunked")),
    # the moe, vlm and encdec families, f32, the kernel against JAX's
    # attention_chunked (the call sites' own plain function); whisper at
    # its serving frames (1500 encoder positions)
    ("dbrx-132b", "float32", 2, 128, dict(attn_impl="flash"),
     dict(attn_impl="chunked")),
    ("internvl2-26b", "float32", 2, 128, dict(attn_impl="flash"),
     dict(attn_impl="chunked")),
    ("whisper-medium", "float32", 2, 128, dict(attn_impl="flash"),
     dict(attn_impl="chunked")),
]
# one f32 layer of dbrx-132b is 13 GB and its embeddings 4.9 GB: two
# copies of one layer are ~36 GB. arctic-480b has no line: one f32 layer
# is 55 GB. whisper-medium: 2 encoder layers beside its 2 decoder layers
WIRING_CUT = {"dbrx-132b": dict(n_layers=1),
              "whisper-medium": dict(encoder_layers=2)}


def gla_state_dropped(r, k, v, logw, u=None, *, initial_state=None):
    """A wrong GLA scan: each chunk of 32 starts from a zero state, as a
    kernel that forgets to carry S would (the final state is right, so the
    decode step starts from the true cache). T must be a multiple of 32."""
    B, T, H, _ = r.shape
    n = T // gs.CHUNK
    y, _ = gla_chunked(*(x.reshape(B * n, gs.CHUNK, H, x.shape[-1])
                         for x in (r, k, v, logw)), u, chunk=gs.CHUNK)
    _, state = gla_chunked(r, k, v, logw, u, chunk=gs.CHUNK,
                           initial_state=initial_state)
    return y.reshape(v.shape), state


def gla_state_bf16(r, k, v, logw, u=None, *, initial_state=None):
    """A GLA scan in a lower precision: the state carried from chunk to
    chunk is rounded to bf16 each time, as a kernel that keeps S in bf16
    would (subtler than dropping it)."""
    ys, state = [], initial_state
    for t0 in range(0, r.shape[1], gs.CHUNK):
        y, state = gla_chunked(
            *(x[:, t0:t0 + gs.CHUNK] for x in (r, k, v, logw)), u,
            chunk=gs.CHUNK, initial_state=None if state is None
            else state.bfloat16().float())
        ys.append(y)
    return torch.cat(ys, dim=1), state


# the wrong scans of the bf16 wiring lines, read in the plain model; the
# first must move the logits past WIRING_BF16_RTOL
CONTROLS = {"state_dropped": gla_state_dropped,
            "state_bf16": gla_state_bf16}


def run_model(model, toks, S, vocab, side=None):
    """(prefill logits, decode-step logits) as f32, vocab columns only;
    ``side`` holds the family's frames or patches."""
    off = prefix_len(model.cfg)
    lg, cache = model.prefill(dict(side or {}, tokens=toks[:, :S]),
                              cache_len=off + S + 4)
    ld, _ = model.decode_step(cache, toks[:, S:S + 1], off + S)
    return lg[..., :vocab].float(), ld[..., :vocab].float()


def rel_err(out, ref):
    """max over prefill and decode of ||out - ref|| / ||ref||."""
    return max(((o - r).norm() / r.norm()).item() for o, r in zip(out, ref))


def phase_wiring():
    for arch, dtype, B, S, kern_kw, plain_kw in WIRING:
        cfg = get_config(arch).scaled(**dict(dict(n_layers=2, dtype=dtype),
                                             **WIRING_CUT.get(arch, {})))
        kern = build_model(cfg, device=DEV, **kern_kw)
        kern.init_params(torch.Generator(device=DEV).manual_seed(2))
        plain = build_model(cfg, device=DEV, **plain_kw)
        plain.load_state_dict(kern.state_dict())
        toks = torch.randint(0, cfg.vocab, (B, S + 1), device=DEV,
                             generator=torch.Generator(device=DEV)
                             .manual_seed(3))
        side = with_side(cfg, {"tokens": toks}, 3,
                         SERVE_FRAMES.get(arch))
        del side["tokens"]
        (kp, kd), (pp, pd) = (run_model(m, toks, S, cfg.vocab, side)
                              for m in (kern, plain))
        controls = {}
        if dtype == "bfloat16":
            for name, fn in CONTROLS.items():
                plain.gla = fn
                controls[name] = rel_err(run_model(plain, toks, S,
                                                   cfg.vocab), (pp, pd))
        torch.cuda.synchronize()
        err_pf = (kp - pp).abs().max().item()
        err_dec = (kd - pd).abs().max().item()
        rel_pf = ((kp - pp).norm() / pp.norm()).item()
        rel_dec = ((kd - pd).norm() / pd.norm()).item()
        limit = (dict(atol=WIRING_ATOL) if dtype == "float32"
                 else dict(rtol=WIRING_BF16_RTOL))
        emit(phase="wiring", arch=cfg.name, n_layers=cfg.n_layers,
             encoder_layers=cfg.encoder_layers or None,
             d_model=cfg.d_model, dtype=cfg.dtype, batch=B, prompt_len=S,
             side_inputs={k: list(v.shape) for k, v in side.items()},
             kernel=kern_kw, plain=plain_kw, prefill_max_abs_err=err_pf,
             decode_max_abs_err=err_dec, prefill_rel_err=rel_pf,
             decode_rel_err=rel_dec, control_rel_err=controls, **limit)
        ok = (max(err_pf, err_dec) <= WIRING_ATOL if dtype == "float32"
              else max(rel_pf, rel_dec) <= WIRING_BF16_RTOL)
        finite = bool(torch.isfinite(kp).all() and torch.isfinite(kd).all())
        check(ok and finite, f"{arch} ({dtype}): the kernels and the plain "
                             f"versions disagree inside the model")
        check(not controls
              or controls["state_dropped"] > WIRING_BF16_RTOL,
              f"{arch} ({dtype}): a GLA scan that drops the state moves "
              f"the logits by {controls.get('state_dropped')}, inside "
              f"{WIRING_BF16_RTOL}: the wiring line cannot fail")
        del kern, plain
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 5 --
def phase_serve():
    """Each serving run with every launch count set to 0 just before it and
    read just after; returns {arch: {kernel: launches}} and {arch:
    {kernel: {variant: launches}}}."""
    launches, variants = {}, {}
    for arch, (N, P, GEN) in SERVE.items():
        cfg = serve_cfg(arch)
        gla = cfg.family in ("ssm", "hybrid")
        # attention: each call of the prefill (tc: a layer; encdec's
        # encoder layers and its decoder's self- and cross-attention) and
        # of each of the G-1 decode steps (split); GLA scan: every layer
        # at prefill (decode runs gla_step)
        at_prefill, a_step = attn_calls(cfg)
        want = {"flash_attention": at_prefill + a_step * (GEN - 1),
                "gla_scan": cfg.n_layers if gla else 0}
        want_variants = {"simt": 0, "tc": at_prefill,
                         "split": a_step * (GEN - 1)}
        want_gla = {"tc": cfg.n_layers if gla else 0, "simt": 0}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in (fa.flash_attention, gs.gla_scan):
            fn.launches = 0
            for name in fn.launches_by_variant:
                fn.launches_by_variant[name] = 0
        res = serve(cfg, N, P, GEN, device=DEV, seed=0,
                    n_frames=SERVE_FRAMES.get(arch))
        got = {"flash_attention": fa.flash_attention.launches,
               "gla_scan": gs.gla_scan.launches}
        got_variants = dict(fa.flash_attention.launches_by_variant)
        got_gla = dict(gs.gla_scan.launches_by_variant)
        finite = bool(torch.isfinite(res.logits).all())
        tok_ok = bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all())
        emit(phase="serve", arch=cfg.name, n_layers=cfg.n_layers,
             full_depth=arch not in SERVE_LAYERS,
             encoder_layers=cfg.encoder_layers or None,
             d_model=cfg.d_model, dtype=cfg.dtype, requests=N,
             prompt_len=P, gen_len=GEN, prefix=prefix_len(cfg) or None,
             frames=SERVE_FRAMES.get(arch),
             routes=[[d.rid, d.pod, d.policy, d.cache_hit]
                     for d in res.decisions],
             cache_hit_rate=res.cache_hit_rate,
             load_imbalance=res.load_imbalance, prefill_s=res.prefill_s,
             decode_s=res.decode_s, decode_tok_s=res.decode_tok_s,
             launches=got, expected_launches=want,
             flash_variants=got_variants,
             expected_flash_variants=want_variants, gla_variants=got_gla,
             expected_gla_variants=want_gla,
             logits_shape=list(res.logits.shape), logits_finite=finite,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             tokens_req0=res.tokens[0].tolist())
        check(got == want, f"{arch}: kernel launches {got}, expected {want}")
        check(got_variants == want_variants,
              f"{arch}: flash_attention launches by variant {got_variants}, "
              f"expected {want_variants}")
        check(got_gla == want_gla, f"{arch}: gla_scan launches by variant "
                                   f"{got_gla}, expected {want_gla}")
        check(finite, f"{arch}: non-finite logits on the serving path")
        check(tuple(res.logits.shape) == (N, GEN - 1, cfg.padded_vocab),
              f"{arch}: unexpected logits shape")
        check(tuple(res.tokens.shape) == (N, GEN) and tok_ok,
              f"{arch}: generated tokens out of shape or vocab")
        launches[arch] = got
        variants[arch] = {"flash_attention": got_variants,
                          "gla_scan": got_gla}
        del res
    torch.cuda.empty_cache()
    return launches, variants


# ---------------------------------------------------------------- phase 6 --
def time_ms(fn, iters: int):
    """(ms, host us) per call of ``iters`` eager calls after a warm-up. ms:
    CUDA events around the calls, the device's time unless the host takes
    longer to issue a call; host us: the host clock around the same calls,
    before the wait for the card, the host's cost of issuing one (or the
    device's time, where the host waits for a full launch queue)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_s / iters * 1e6


def graph_ms(fn, calls: int, replays: int) -> float:
    """Per call, CUDA events around ``replays`` replays of a CUDA graph of
    ``calls`` calls: the device time alone, without the host's cost of
    issuing each call (a decode kernel takes less time than its Python
    wrapper)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm up: build, smem limits, SM count
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


def least_ms(nbytes, flops, flop_per_s=BF16_FLOP_PER_S):
    """(least time in ms, what bounds it): bytes over the HBM rate or
    flops over the peak (by default bf16 on the tensor cores), whichever
    is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_work(B, H, G, D, qpos, kpos, causal, window, itemsize):
    """Bytes of q, o and the valid keys' k/v, and 4*D flops for each valid
    (q, k) pair, on these inputs."""
    ok = (kpos[None, :] >= 0).expand(qpos.shape[0], -1)   # every (q, k)
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if window:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    pairs = int(ok.sum().item()) * B * H
    n_keys = int((ok.any(dim=0)).sum().item())
    Sq = qpos.shape[0]
    nbytes = (2 * B * Sq * H * D + 2 * B * n_keys * G * D) * itemsize \
        + 4 * (Sq + kpos.shape[0])
    return nbytes, 4 * D * pairs


def gla_work(B, T, H, K, V, use_u, itemsize, chunk=gs.CHUNK):
    """Bytes of r, k, v, y (itemsize), logw, u and the final state (f32),
    and the flops of the chunked form: per chunk of n rows 2nKV inter-chunk,
    2nKV state update, n(n-1)/2 pairs of 2K (A) and 2V (A @ v), and 2n(K+V)
    for the diagonal term."""
    nbytes = (B * T * H * (2 * K + 2 * V) * itemsize + 4 * B * T * H * K
              + 4 * B * H * K * V + (4 * H * K if use_u else 0))
    flops = 0
    for t0 in range(0, T, chunk):
        n = min(chunk, T - t0)
        flops += 4 * n * K * V + n * (n - 1) * (K + V) + 2 * n * (K + V)
    return nbytes, flops * B * H


def phase_times():
    gen = torch.Generator(device=DEV).manual_seed(4)
    dt = torch.bfloat16
    per = {}
    # flash_attention: name -> (arch, Sq, Sk, window, causal, qpos, kpos,
    # calls per serving run, buffers, iters)
    qcfg, hcfg = get_config("qwen3-4b"), get_config("hymba-1.5b")
    wcfg, vcfg = get_config("whisper-medium"), get_config("internvl2-26b")
    _, P, GEN = SERVE["qwen3-4b"]
    _, HP, HGEN = SERVE["hymba-1.5b"]
    VS = vcfg.vis_tokens + SERVE["internvl2-26b"][1]
    WE = SERVE_FRAMES["whisper-medium"] // 2
    C = P + GEN
    last, hlast = P + GEN - 2, HP + HGEN - 2    # the last decode steps
    flash = {
        "qwen3_prefill": (qcfg, P, P, 0, True, ar(P), ar(P), qcfg.n_layers,
                          2, 50),
        # several K/V buffers in turn, as the layers' caches are: the 18 MB
        # of one would otherwise stay in the 50 MB L2 between launches
        "qwen3_decode": (qcfg, 1, C, 0, True, ar(1, last),
                         torch.where(ar(C) <= last, ar(C), -1)
                         .to(torch.int32), qcfg.n_layers * (GEN - 1), 8,
                         400),
        "hymba_prefill": (hcfg, HP, HP, 1024, True, ar(HP), ar(HP),
                          hcfg.n_layers, 2, 20),
        "hymba_decode": (hcfg, 1, 1024, 1024, True, ar(1, hlast),
                         ring_kpos(1024, hlast),
                         hcfg.n_layers * (HGEN - 1), 8, 400),
        # the shapes this slice launches most work at: whisper-medium's
        # encoder (non-causal, 1500 positions, H = G = 16, D 64) and
        # internvl2-26b's prefill (256 patches + 512 tokens, H 48, G 8)
        "whisper_encoder": (wcfg, WE, WE, 0, False, ar(WE), ar(WE),
                            wcfg.encoder_layers, 2, 30),
        "internvl2_prefill": (vcfg, VS, VS, 0, True, ar(VS), ar(VS),
                              vcfg.n_layers, 2, 30),
    }
    for name, (cfg, Sq, Sk, window, causal, qpos, kpos, n_calls, nbuf,
               iters) in flash.items():
        N = SERVE[cfg.name][0]
        H, G, D = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
        bufs = [(rand((N, Sq, H, D), dt, gen), rand((N, Sk, G, D), dt, gen),
                 rand((N, Sk, G, D), dt, gen)) for _ in range(nbuf)]
        # SDPA wants (B, H, S, D); the transposed copies are made untimed
        sdpa_bufs = [tuple(t.transpose(1, 2).contiguous() for t in qkv)
                     for qkv in bufs]
        mask = (kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
        if window:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        kw = dict(causal=causal, window=window, qpos=qpos, kpos=kpos)
        sdpa_kw = (dict() if not causal else
                   dict(is_causal=True) if Sq == Sk and not window
                   else dict(attn_mask=mask))
        variant = fa.choose_variant(dt, Sq)
        cyc = {key: itertools.cycle(bufs) for key in ("", "simt", "plain")}
        lib_in = itertools.cycle(sdpa_bufs)
        fns = {
            "": lambda: fa.flash_attention(*next(cyc[""]), **kw),
            "simt": lambda: fa.flash_attention(*next(cyc["simt"]),
                                               variant="simt", **kw),
            "library": lambda: F.scaled_dot_product_attention(
                *next(lib_in), enable_gqa=True, **sdpa_kw)}
        calls, replays = 2 * nbuf, max(2, iters // (2 * nbuf))
        # the chosen kernel, the simt kernel and SDPA in turns, twice: eager
        # calls (ms, what a caller issuing one call at a time pays: the
        # yardstick of every PR) and CUDA graphs (device_ms, the card's
        # time alone)
        runs = {key: [] for key in ("ms", "host_us", "device_ms")}
        for _ in range(2):
            for key in ("ms", "host_us", "device_ms"):
                runs[key].append({})
            for fn_name, fn in fns.items():
                ms, host_us = time_ms(fn, iters)
                runs["ms"][-1][fn_name] = ms
                runs["host_us"][-1][fn_name] = host_us
                runs["device_ms"][-1][fn_name] = graph_ms(fn, calls, replays)
        times = {}
        for key, rounds in runs.items():
            for fn_name in fns:
                field = "_".join(filter(None, (fn_name, key)))
                times[field] = min(r[fn_name] for r in rounds)
                times[field + "_runs"] = [r[fn_name] for r in rounds]
        plain_ms, _ = time_ms(
            lambda: fa.flash_attention_ref(*next(cyc["plain"]), **kw),
            max(10, iters // 10))
        nbytes, flops = flash_work(N, H, G, D, qpos, kpos, causal, window,
                                   2)
        b_ms, b_by = least_ms(nbytes, flops)
        per[("flash_attention", name)] = dict(
            shape=[N, Sq, Sk, H, G, D], window=window, causal=causal,
            dtype="bfloat16",
            variant=variant,
            n_split=(fa.decode_splits(N, G, Sk, n_sm())
                     if variant == "split" else None),
            **times, plain_ms=plain_ms, bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=b_by, bytes=nbytes,
            flops=flops, launches_per_serving_run=n_calls)
        emit(phase="times", kernel="flash_attention", at=name,
             **per[("flash_attention", name)])
        del bufs, sdpa_bufs
        torch.cuda.empty_cache()
    # gla_scan at the two prefill shapes; one set of inputs is ~160-210 MB,
    # so two in turn keep every launch out of the 50 MB L2. The chosen
    # kernel (tc) and the simt kernel in turns, twice, eager and in CUDA
    # graphs
    for arch, use_u in (("rwkv6-7b", True), ("hymba-1.5b", False)):
        cfg = get_config(arch)
        N, T, _ = SERVE[arch]
        H = cfg.n_heads
        K = cfg.ssm_state if cfg.family == "hybrid" else cfg.hdim
        V = cfg.hdim
        bufs = [gla_inputs(N, T, H, K, V, use_u, False, None, dt, gen)[:5]
                for _ in range(2)]
        kws = {"": dict(), "simt": dict(variant="simt")}
        cyc = {key: itertools.cycle(bufs) for key in (*kws, "plain")}
        fns = {key: (lambda key=key: gs.gla_scan(*next(cyc[key]),
                                                 **kws[key]))
               for key in kws}
        runs = {key: [] for key in ("ms", "host_us", "device_ms")}
        for _ in range(2):
            for key in runs:
                runs[key].append({})
            for fn_name, fn in fns.items():
                ms, host_us = time_ms(fn, 20)
                runs["ms"][-1][fn_name] = ms
                runs["host_us"][-1][fn_name] = host_us
                runs["device_ms"][-1][fn_name] = graph_ms(fn, 4, 5)
        times = {}
        for key, rounds in runs.items():
            for fn_name in fns:
                field = "_".join(filter(None, (fn_name, key)))
                times[field] = min(r[fn_name] for r in rounds)
                times[field + "_runs"] = [r[fn_name] for r in rounds]
        plain_ms, _ = time_ms(lambda: gs.gla_scan_ref(*next(cyc["plain"])),
                              5)
        nbytes, flops = gla_work(N, T, H, K, V, use_u, 2)
        b_ms, b_by = least_ms(nbytes, flops)
        name = arch.split("-")[0] + "_prefill"
        per[("gla_scan", name)] = dict(
            shape=[N, T, H, K, V], u=use_u, dtype="bfloat16",
            variant=gs.choose_variant(dt), **times,
            plain_ms=plain_ms, library_ms=None,
            library="none: no single PyTorch call computes a GLA scan",
            bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=b_by, bytes=nbytes,
            flops=flops,
            launches_per_serving_run=cfg.n_layers)
        emit(phase="times", kernel="gla_scan", at=name,
             **per[("gla_scan", name)])
        del bufs
        torch.cuda.empty_cache()
    return per


# ---------------------------------------------------------------- phase 7 --
# gradients through the kernels' autograd Functions (kernel forward, the
# plain version's backward) against autograd of the plain functions, as
# ||g_fn - g_plain|| / ||g_plain|| for each input. The upstream gradient
# is out - target, so each side's own forward output enters its gradient:
# f32 differs only by summation order; bf16 by the kernel's f32
# accumulation against the plain versions' bf16 (attention) and the tc
# kernel's bf16 operands (GLA), as in the bf16 wiring lines
GRAD_RTOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}


def grad_cases():
    """flash: (name, B, S, H, G, D, window, dtype[, causal, block_k]);
    gla: (name, B, T, H, K, V, u, initial state, dtype). The serving
    shapes (bf16 at the serving batch, f32 at B = 2), the training shapes
    of phase 9 (hymba's differ from its serving one only in B) and a small
    ragged shape. whisper-medium's training shapes pass its call sites'
    block_k of 512: the encoder non-causal at 1500 positions, the decoder
    causal at 448."""
    f32, bf16 = torch.float32, torch.bfloat16
    _, P, _ = SERVE["qwen3-4b"]
    _, HP, _ = SERVE["hymba-1.5b"]
    _, QB, QS = TRAIN["qwen3-4b"][:3]
    _, RB, RT = TRAIN["rwkv6-7b"][:3]
    _, WB, WS = TRAIN["whisper-medium"][:3]
    WE = TRAIN_FRAMES["whisper-medium"] // 2
    flash = [("qwen3_prefill", 8, P, 32, 8, 128, 0, bf16),
             ("qwen3_train", QB, QS, 32, 8, 128, 0, bf16),
             ("qwen3_prefill", 2, P, 32, 8, 128, 0, f32),
             # 2 x window: the banded backward
             ("hymba_prefill", 8, HP, 25, 5, 64, 1024, bf16),
             ("hymba_prefill", 2, HP, 25, 5, 64, 1024, f32),
             ("ragged", 3, 77, 6, 3, 32, 0, f32),
             ("ragged_window", 2, 150, 10, 2, 64, 40, bf16),
             ("whisper_encoder", WB, WE, 16, 16, 64, 0, bf16, False, 512),
             ("whisper_encoder", 2, WE, 16, 16, 64, 0, f32, False, 512),
             ("whisper_decoder", WB, WS, 16, 16, 64, 0, bf16, True, 512)]
    gla = [("rwkv6_prefill", 8, P, 64, 64, 64, True, False, bf16),
           ("rwkv6_train", RB, RT, 64, 64, 64, True, False, bf16),
           ("rwkv6_prefill", 2, P, 64, 64, 64, True, False, f32),
           ("hymba_prefill", 8, HP, 25, 16, 64, False, False, bf16),
           ("hymba_prefill", 2, HP, 25, 16, 64, False, False, f32),
           ("ragged", 2, 77, 3, 16, 32, True, True, f32),
           ("ragged_bf16", 3, 77, 4, 64, 64, True, True, bf16)]
    return flash, gla


def grads_of(fn, leaves, target):
    """Gradients of 0.5 ||out - target||^2 (out: the first output)."""
    out = fn(*leaves)
    out = out[0] if isinstance(out, tuple) else out
    loss = 0.5 * (out.float() - target).square().sum()
    return torch.autograd.grad(loss, [t for t in leaves if t is not None])


def grad_line(kernel, tag, dt, names, g_fn, g_plain, extra):
    rel = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
           for n, a, b in zip(names, g_fn, g_plain)}
    norms = {n: a.float().norm().item() for n, a in zip(names, g_fn)}
    emit(phase="grad", kernel=kernel, case=tag, rel_err=rel, grad_norm=norms,
         rtol=GRAD_RTOL[dt], **extra)
    check(all(v > 0 for v in norms.values()), f"{kernel} {tag}: a zero "
                                              f"gradient")
    check(all(torch.isfinite(a).all() for a in g_fn), f"{kernel} {tag}: "
                                                       f"non-finite gradient")
    check(max(rel.values()) <= GRAD_RTOL[dt], f"{kernel} {tag}: gradients "
                                               f"through the kernel's "
                                               f"Function disagree")


def phase_grad():
    gen = torch.Generator(device=DEV).manual_seed(5)
    flash_cases_, gla_cases_ = grad_cases()
    # the control: the raw wrappers on grad-requiring inputs must raise
    q = rand((1, 8, 2, 64), torch.bfloat16, gen).requires_grad_()
    raised = {}
    try:
        fa.flash_attention(q, q.detach()[:, :, :1], q.detach()[:, :, :1])
        raised["flash_attention"] = False
    except RuntimeError:
        raised["flash_attention"] = True
    r = rand((1, 8, 2, 16), torch.bfloat16, gen)
    logw = (-torch.ones((1, 8, 2, 16), device=DEV)).requires_grad_()
    try:
        gs.gla_scan(r, r, r, logw)
        raised["gla_scan"] = False
    except RuntimeError:
        raised["gla_scan"] = True
    emit(phase="grad", control="raw wrapper on grad-requiring inputs",
         raised=raised)
    check(all(raised.values()), f"a raw wrapper took grad-requiring inputs "
                                f"and handed back a detached output: "
                                f"{raised}")
    for name, B, S, H, G, D, window, dt, *site in flash_cases_:
        causal, block_k = site or (True, None)
        qkv = [rand(shape, dt, gen) for shape in
               ((B, S, H, D), (B, S, G, D), (B, S, G, D))]
        pos = ar(S)
        target = torch.randn((B, S, H, D), generator=gen, device=DEV)
        kw = dict(causal=causal, window=window, qpos=pos, kpos=pos,
                  self_attention=True, block_k=block_k)
        g_fn = grads_of(lambda q, k, v: kops.flash_attention(q, k, v, **kw),
                        [t.clone().requires_grad_() for t in qkv], target)
        g_plain = grads_of(lambda q, k, v: cm.attention_plain(q, k, v, **kw),
                           [t.clone().requires_grad_() for t in qkv], target)
        torch.cuda.synchronize()
        banded = bool(window and S % window == 0 and S >= 2 * window)
        grad_line("flash_attention", f"{name}/{str(dt).split('.')[-1]}", dt,
                  "qkv", g_fn, g_plain,
                  dict(shape=[B, S, S, H, G, D], window=window,
                       causal=causal, block_k=block_k,
                       backward="banded" if banded else "chunked"))
        del qkv, g_fn, g_plain
    for name, B, T, H, K, V, use_u, init, dt in gla_cases_:
        r, k, v, logw, u, s0 = gla_inputs(B, T, H, K, V, use_u, init, None,
                                          dt, gen)
        target = torch.randn((B, T, H, V), generator=gen, device=DEV)
        ins = [r, k, v, logw, u, s0]
        names = [n for n, t in zip(("r", "k", "v", "logw", "u", "s0"), ins)
                 if t is not None]

        def leaves():
            return [None if t is None else t.clone().requires_grad_()
                    for t in ins]

        g_fn = grads_of(lambda r, k, v, w, u, s: kops.gla(
            r, k, v, w, u, initial_state=s), leaves(), target)
        g_plain = grads_of(lambda r, k, v, w, u, s: gs.gla_scan_ref(
            r, k, v, w, u, initial_state=s), leaves(), target)
        torch.cuda.synchronize()
        grad_line("gla_scan", f"{name}/{str(dt).split('.')[-1]}", dt, names,
                  g_fn, g_plain, dict(shape=[B, T, H, K, V], u=use_u,
                                      initial_state=init))
        del ins, g_fn, g_plain
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 8 --
# train steps of the model with the kernels against the all-plain model
# from the same weights, f32, 2 layers at full width. Gradients differ by
# f32 summation order (TF32 off): each parameter's gradient within
# TRAIN_GRAD_RTOL of the plain one in norm; loss and grad norm closer.
# Params after TRAIN_WIRING_STEPS steps on one batch, as ||p_kernel -
# p_plain|| / ||p_plain - p_0|| over all params: AdamW moves each param by
# ~lr * sign(g) whatever the gradient's size, so one step's max abs change
# stays within 2 lr for any gradients; the norm over all params after a
# few steps, where the moments weigh the gradients, sees a wrong gradient.
# The control reading (the gradients that reach q/k/v only through the
# attention zeroed, as a detached kernel output would give) must exceed
# TRAIN_PARAM_RTOL, or the check could not fail. On an H100 the sound
# runs read 2.2e-5 and 1.8e-4, the controls 0.24-0.26 (PERF.md): 1e-2
# sits well apart from both
TRAIN_WIRING = [
    # (arch, B, S): hymba at S = 2 x window, so its backward is banded
    ("qwen3-4b", 2, 512),
    ("hymba-1.5b", 2, 2048),
]
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4, 1e-3
TRAIN_PARAM_RTOL = 1e-2
TRAIN_WIRING_STEPS = 3
WIRING_LR = 1e-4
CONTROL_ZEROED = ("attn.wq", "attn.wk", "attn.wv", "attn.q_norm",
                  "attn.k_norm", "attn.bq", "attn.bk", "attn.bv")


def wiring_steps(cfg, batch, kw, zeroed=()):
    """The loss and gradients of the first batch, then TRAIN_WIRING_STEPS
    make_train_step steps on it: (loss, grads, step metrics, param change).
    Params whose names end in ``zeroed`` get zero gradients."""
    model = build_model(cfg, device=DEV, **kw)
    model.init_params(torch.Generator(device=DEV).manual_seed(7))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        if n.endswith(zeroed):
            p.register_hook(torch.zeros_like)
    loss, _ = model.loss(batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    state = adamw_init(dict(model.named_parameters()))
    step = make_train_step(model, TrainConfig(opt=OptConfig(
        lr=WIRING_LR, warmup_steps=0)))
    mets = []
    for _ in range(TRAIN_WIRING_STEPS):
        state, met = step(state, batch)
        mets.append({k: v.item() for k, v in met.items()})
    delta = {n: p.detach() - before[n] for n, p in model.named_parameters()}
    return loss.item(), grads, mets, delta


def tree_rel(a, b):
    """||a - b|| / ||b|| over every leaf of two dicts of tensors."""
    num = sum((a[n].double() - b[n].double()).square().sum() for n in b)
    return math.sqrt(num / sum(t.double().square().sum() for t in b.values()))


def phase_train_wiring():
    for arch, B, S in TRAIN_WIRING:
        cfg = get_config(arch).scaled(n_layers=2, dtype="float32")
        toks = torch.randint(0, cfg.vocab, (B, S), device=DEV,
                             generator=torch.Generator(device=DEV)
                             .manual_seed(6))
        batch = {"tokens": toks}
        plain = dict(attn_impl="chunked", gla_impl="chunked")
        k_loss, k_g, k_met, k_d = wiring_steps(
            cfg, batch, dict(attn_impl="flash", gla_impl="kernel"))
        p_loss, p_g, p_met, p_d = wiring_steps(cfg, batch, plain)
        grad_rel = {n: ((k_g[n] - g).norm() / g.norm()).item()
                    for n, g in p_g.items() if g.norm() > 0}
        worst = max(grad_rel, key=grad_rel.get)
        zero_grads = sorted(set(p_g) - set(grad_rel))
        del k_g, p_g
        param_rel = tree_rel(k_d, p_d)
        dp_diff = max((k_d[n] - d).abs().max().item() for n, d in p_d.items())
        dp_max = max(d.abs().max().item() for d in p_d.values())
        del k_d
        c_d = wiring_steps(cfg, batch, plain, CONTROL_ZEROED)[3]
        control_rel = tree_rel(c_d, p_d)
        del c_d, p_d
        loss_rel = abs(k_loss - p_loss) / abs(p_loss)
        gn_k, gn_p = k_met[0]["grad_norm"], p_met[0]["grad_norm"]
        emit(phase="train_wiring", arch=cfg.name, n_layers=cfg.n_layers,
             d_model=cfg.d_model, dtype=cfg.dtype, batch=B, seq_len=S,
             kernel="attn_impl=flash, gla_impl=kernel",
             plain="attn_impl=chunked, gla_impl=chunked",
             loss=[k_loss, p_loss], loss_rel_err=loss_rel,
             step_loss=[[m["loss"] for m in k_met],
                        [m["loss"] for m in p_met]],
             grad_norm=[gn_k, gn_p], grad_norm_rel_err=abs(gn_k - gn_p) / gn_p,
             grad_rel_err_max=grad_rel[worst], grad_rel_err_worst=worst,
             zero_grads=zero_grads,
             steps=TRAIN_WIRING_STEPS, param_rel_err=param_rel,
             control="plain, zero gradients into " + "/".join(CONTROL_ZEROED),
             control_param_rel_err=control_rel, param_change_max=dp_max,
             param_change_max_abs_diff=dp_diff, lr=WIRING_LR,
             loss_rtol=TRAIN_LOSS_RTOL, grad_norm_rtol=TRAIN_GNORM_RTOL,
             grad_rtol=TRAIN_GRAD_RTOL, param_rtol=TRAIN_PARAM_RTOL)
        check(math.isfinite(k_loss) and loss_rel <= TRAIN_LOSS_RTOL
              and abs(gn_k - gn_p) / gn_p <= TRAIN_GNORM_RTOL
              and grad_rel[worst] <= TRAIN_GRAD_RTOL,
              f"{arch}: the train step with the kernels disagrees with the "
              f"plain model")
        check(dp_max > 0 and param_rel <= TRAIN_PARAM_RTOL,
              f"{arch}: params moved differently: {param_rel}")
        check(control_rel > TRAIN_PARAM_RTOL,
              f"{arch}: the control's params are within TRAIN_PARAM_RTOL "
              f"({control_rel}): the param check could not fail")
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 9 --
# the training main paths, bf16: steps on batches of the JoSS policy-B
# pipeline over VirtualCluster([4, 4]), then one batch repeated, whose
# loss must fall. rwkv6-7b at 8 of its 32 layers: its f32 AdamW moments
# alone (7.6 B params x 8 bytes) would fill the card's 80 GB
TRAIN = {
    # arch -> (layers (None = the full depth), batch, seq len, steps on
    # pipeline batches, steps on the last of them repeated, layers of the
    # profiled step). hymba-1.5b takes ~9-10 s a step (its plain GLA
    # backward loops over 64 chunks a layer from the host, ~400 k small
    # ops a step), and its step is profiled at 4 layers: the profiler's
    # Python side took 211 s over the 32
    "qwen3-4b": (None, 4, 1024, 5, 3, None),
    "hymba-1.5b": (None, 4, 2048, 5, 3, 4),
    "rwkv6-7b": (8, 4, 1024, 5, 3, None),
    # full depth (24 + 24 layers), 30 s of audio a sequence and its whole
    # 448-token text context
    "whisper-medium": (None, 8, 448, 5, 3, None),
}
TRAIN_FRAMES = {"whisper-medium": 3000}
TRAIN_OPT = OptConfig(lr=1e-3, warmup_steps=0, total_steps=1000)
# the 4-layer qwen3-4b runs: n_micro 2 against 1 on one batch (loss and
# grad norm: bf16 matmuls on half the rows, f32 accumulation against the
# bf16 gradient), compression, and a checkpoint round trip
MICRO_LOSS_RTOL, MICRO_GNORM_RTOL = 5e-3, 2e-2
CKPT_DIR = Path(__file__).resolve().parent / "build" / "smoke_ckpt"


def reset_counts():
    for fn in (fa.flash_attention, gs.gla_scan):
        fn.launches = 0
        for name in fn.launches_by_variant:
            fn.launches_by_variant[name] = 0


def timed_step(step, state, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, met = step(state, batch)
    torch.cuda.synchronize()
    return state, met, time.perf_counter() - t0


def profile_step(step, state, batch):
    """One train step under torch.profiler: device ms of every kernel, of
    the kernels' forward launches and of the Functions' backward spans
    (the plain recompute)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    spans = set(BACKWARD_SPANS.values())
    out = {"step_device_ms": 0.0, "flash_forward_device_ms": 0.0,
           "gla_forward_device_ms": 0.0}
    out.update({f"{k}_backward_device_ms": 0.0 for k in BACKWARD_SPANS})
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name in spans or e.name.startswith("Command Buffer"):
                continue
            us = e.time_range.elapsed_us()
            out["step_device_ms"] += us / 1e3
            if "attn_fwd" in e.name or "attn_decode" in e.name:
                out["flash_forward_device_ms"] += us / 1e3
            elif "gla_fwd" in e.name:
                out["gla_forward_device_ms"] += us / 1e3
        elif e.name in spans:
            kernel = next(k for k, v in BACKWARD_SPANS.items() if v == e.name)
            out[f"{kernel}_backward_device_ms"] += e.device_time_total / 1e3
    return state, out


def run_train(arch):
    layers, B, S, pipe_steps, repeat_steps, prof_layers = TRAIN[arch]
    cfg = get_config(arch)
    cfg = cfg.scaled(n_layers=layers) if layers else cfg
    gla = cfg.family in ("ssm", "hybrid")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=DEV)
    tcfg = TrainConfig(opt=TRAIN_OPT)
    state = init_train_state(model, torch.Generator(device=DEV)
                             .manual_seed(8), tcfg)
    step = make_train_step(model, tcfg)
    store = TokenStore(VirtualCluster([4, 4]), n_shards=32, seqs_per_shard=8,
                       seq_len=S, vocab=cfg.vocab, seed=0)
    pipe = JossDataPipeline(store, global_batch=B, seed=1)
    # each pipeline batch with the family's side inputs (whisper's frames)
    batches = [with_side(cfg, {"tokens": torch.as_tensor(b, device=DEV)},
                         i, TRAIN_FRAMES.get(arch))
               for i, b in enumerate(pipe.batches(pipe_steps))]
    batches += [batches[-1]] * repeat_steps
    n_steps = len(batches)
    reset_counts()
    losses, gnorms, secs = [], [], []
    for batch in batches:
        state, met, s = timed_step(step, state, batch)
        losses.append(met["loss"].item())
        gnorms.append(met["grad_norm"].item())
        secs.append(s)
    got = {"flash_attention": fa.flash_attention.launches,
           "gla_scan": gs.gla_scan.launches}
    variants = {"flash_attention": dict(fa.flash_attention
                                        .launches_by_variant),
                "gla_scan": dict(gs.gla_scan.launches_by_variant)}
    peak = torch.cuda.max_memory_allocated() / 1e9
    # each attention call's kernel runs twice a step: the forward and the
    # remat recompute in the backward (the backward itself is plain)
    want = {"flash_attention": 2 * attn_calls(cfg)[0] * n_steps,
            "gla_scan": 2 * cfg.n_layers * n_steps if gla else 0}
    med = statistics.median(secs[1:])
    rep = pipe.locality_report()
    n_params = sum(p.numel() for p in model.parameters())
    if prof_layers:  # the same step on a shallower copy, after a warm-up
        del model, state, step
        model = build_model(cfg.scaled(n_layers=prof_layers), device=DEV)
        state = init_train_state(model, torch.Generator(device=DEV)
                                 .manual_seed(8), tcfg)
        step = make_train_step(model, tcfg)
        state, _ = step(state, batches[-1])
    t0 = time.perf_counter()
    state, prof = profile_step(step, state, batches[-1])
    prof["seconds"] = time.perf_counter() - t0
    prof["n_layers"] = prof_layers or cfg.n_layers
    emit(phase="train", arch=cfg.name, n_layers=cfg.n_layers,
         encoder_layers=cfg.encoder_layers or None,
         full_depth=layers is None, d_model=cfg.d_model, dtype=cfg.dtype,
         params=n_params, batch=B, seq_len=S,
         frames=TRAIN_FRAMES.get(arch), n_micro=1, steps=n_steps,
         pipeline_steps=pipe_steps, repeated_steps=repeat_steps,
         s_per_step=secs, median_s_per_step=med,
         tokens_per_s=B * S / med, peak_mem_gb=peak, losses=losses,
         grad_norms=gnorms, launches=got, expected_launches=want,
         launches_by_variant=variants,
         locality={"host": rep.host_rate, "pod": rep.pod_rate,
                   "off_pod": rep.off_pod_rate},
         profile=prof)
    check(all(map(math.isfinite, losses + gnorms)),
          f"{arch}: non-finite loss or grad norm")
    rep_losses = losses[pipe_steps:]
    check(rep_losses[-1] < rep_losses[0], f"{arch}: the loss on the "
                                          f"repeated batch did not fall: "
                                          f"{rep_losses}")
    check(got == want, f"{arch}: train launches {got}, expected {want}")
    check(variants["flash_attention"]["tc"] == want["flash_attention"]
          and variants["gla_scan"]["tc"] == want["gla_scan"],
          f"{arch}: bf16 training should launch only tc kernels: "
          f"{variants}")
    del model, state, step
    torch.cuda.empty_cache()
    return got, prof


def equal_trees(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal_trees(a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def run_train_small():
    """qwen3-4b at 4 layers, bf16: n_micro 2 against n_micro 1 on one
    batch from the same weights, one step with int8 compression and bf16
    moments, and an AsyncCheckpointer round trip of its params and
    optimizer state (moments and error feedback)."""
    B, S = 4, 1024
    cfg = get_config("qwen3-4b").scaled(n_layers=4)
    toks = torch.randint(0, cfg.vocab, (B, S), device=DEV,
                         generator=torch.Generator(device=DEV)
                         .manual_seed(9))
    batch = {"tokens": toks}
    model = build_model(cfg, device=DEV)
    res = {}
    bf16_state = dataclasses.replace(TRAIN_OPT, state_dtype="bfloat16")
    for name, kw in (("n_micro1", {}), ("n_micro2", dict(n_micro=2)),
                     ("compress", dict(compress_grads=True,
                                       opt=bf16_state))):
        tcfg = TrainConfig(**dict(dict(opt=TRAIN_OPT), **kw))
        state = init_train_state(model, torch.Generator(device=DEV)
                                 .manual_seed(10), tcfg)
        state, met, s = timed_step(make_train_step(model, tcfg), state, batch)
        res[name] = {"loss": met["loss"].item(),
                     "grad_norm": met["grad_norm"].item(), "s": s,
                     "has_ef": "ef" in state}
        if name == "n_micro1":
            p1 = {n: p.detach().clone() for n, p in model.named_parameters()}
        elif name == "n_micro2":
            res[name]["param_max_abs_diff_vs_n_micro1"] = max(
                (p.detach().float() - p1[n].float()).abs().max().item()
                for n, p in model.named_parameters())
            del p1
    tree = {"params": model.state_dict(), "opt": state}
    t0 = time.perf_counter()
    saver = AsyncCheckpointer(str(CKPT_DIR), keep=1)
    saver.submit(1, tree)
    submit_s = time.perf_counter() - t0
    saver.wait()
    save_s = time.perf_counter() - t0
    back, step = ckpt_restore(str(CKPT_DIR), tree)
    restore_s = time.perf_counter() - t0 - save_s
    bit_equal = step == 1 and equal_trees(back, tree)
    nbytes = sum(f.stat().st_size for f in CKPT_DIR.rglob("*") if f.is_file())
    shutil.rmtree(CKPT_DIR)
    m1, m2 = res["n_micro1"], res["n_micro2"]
    emit(phase="train", arch=cfg.name, n_layers=cfg.n_layers, batch=B,
         seq_len=S, dtype=cfg.dtype, runs=res,
         loss_rel_err_n_micro=abs(m2["loss"] - m1["loss"]) / m1["loss"],
         grad_norm_rel_err_n_micro=abs(m2["grad_norm"] - m1["grad_norm"])
         / m1["grad_norm"], loss_rtol=MICRO_LOSS_RTOL,
         grad_norm_rtol=MICRO_GNORM_RTOL,
         checkpoint={"bit_equal": bit_equal, "bytes": nbytes,
                     "submit_s": submit_s, "save_s": save_s,
                     "restore_s": restore_s, "with_ef": "ef" in state})
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
              for r in res.values()), "non-finite loss in the 4-layer runs")
    check(abs(m2["loss"] - m1["loss"]) / m1["loss"] <= MICRO_LOSS_RTOL
          and abs(m2["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"]
          <= MICRO_GNORM_RTOL, "n_micro 2 disagrees with n_micro 1")
    check(res["compress"]["has_ef"], "no error-feedback state")
    check(bit_equal, "the checkpoint round trip did not give back the "
                     "same tensors")
    del model, state, tree, back
    torch.cuda.empty_cache()


def phase_train():
    """The training runs with every launch count set to 0 just before each
    and read just after; returns ({arch: launches}, {arch: profile})."""
    launches, profiles = {}, {}
    for arch in TRAIN:
        launches[arch], profiles[arch] = run_train(arch)
    run_train_small()
    return launches, profiles


PER_CALL_KEYS = ("shape", "variant", "n_split", "ms", "host_us",
                 "device_ms", "simt_ms", "simt_host_us", "simt_device_ms",
                 "plain_ms", "library_ms", "library_host_us",
                 "library_device_ms", "bound_ms", "bound_by",
                 "launches_per_serving_run")


def kernel_entry(kernel, source, replaces, launches, max_abs_err, per):
    """One kernel of the kernels line: times are totals over the serving
    runs' calls (each shape's per-call time x its calls in a run). ms,
    plain_ms and library_ms are eager calls timed by CUDA events, as in
    every PR; device_ms is the kernel's time in CUDA graphs; simt_* are
    the first design's."""
    rows = {name: row for (k, name), row in per.items() if k == kernel}

    def total(key):
        vals = [row[key] for row in rows.values()]
        if any(v is None for v in vals):
            return None
        return sum(row[key] * row["launches_per_serving_run"]
                   for row in rows.values())

    nbytes, flops = total("bytes"), total("flops")
    b_ms, b_by = least_ms(nbytes, flops)
    entry = {
        "name": kernel, "route": "cuda", "source": source,
        "replaces": replaces, "launches": sum(launches.values()),
        "max_abs_err": max_abs_err, "ms": total("ms"),
        "plain_ms": total("plain_ms"), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": total("library_ms"),
        "launches_by_run": launches,
        "per_call": {name: {k: v for k, v in row.items()
                            if k in PER_CALL_KEYS}
                     for name, row in rows.items()},
    }
    for key in ("device_ms", "simt_ms", "simt_device_ms"):
        entry[key] = total(key)
    if kernel == "flash_attention":
        entry["library_device_ms"] = total("library_device_ms")
    if kernel == "gla_scan":
        entry["library"] = "none: no single PyTorch call computes a GLA scan"
    return entry


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
    ptxas = [ln.strip().replace("ptxas info    : ", "") for p in libs
             for ln in p.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=[p.name for p in libs], ptxas=ptxas)

    done = {}
    runs = {"mapreduce": phase_mapreduce, "fill": phase_fill,
            "lockstep": phase_lockstep, "kernel": phase_kernel,
            "wiring": phase_wiring,
            "serve": phase_serve, "times": phase_times, "grad": phase_grad,
            "train_wiring": phase_train_wiring, "train": phase_train}
    for name, run in runs.items():
        t0 = time.perf_counter()
        done[name] = run()
        emit(phase="phase_seconds", name=name,
             seconds=time.perf_counter() - t0)

    print(smi, flush=True)
    emit(kernels=kernels_line(done["kernel"], *done["serve"], done["times"],
                              *done["train"])
         + [fill_entry(done["fill"], *done["lockstep"])])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


# phase 3's cases at the bf16 serving shapes, whose errors the kernels line
# reports
SERVING_CASES = ("prefill", "decode", "hymba_prefill", "hymba_decode",
                 "internvl2_prefill", "internvl2_decode", "dbrx_prefill",
                 "dbrx_decode", "arctic_prefill", "arctic_decode",
                 "whisper_encoder", "whisper_prefill",
                 "whisper_cross_prefill", "whisper_decode",
                 "whisper_cross_decode")


def kernels_line(errs, launches, variants, per, launches_train, profiles):
    def by_kernel(kernel, runs):
        return {arch: n[kernel] for arch, n in runs.items() if n[kernel]}

    def serving_err(tag):  # bf16 serving shapes, the variant chosen there
        name, dtype, variant = tag.split("/")[:3]
        return (name in SERVING_CASES and dtype == "bfloat16"
                and variant != "simt")

    flash = kernel_entry(
        "flash_attention",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:27",
        by_kernel("flash_attention", launches),
        max(v for k, v in errs.items()
            if k.startswith("flash_attention:")
            and serving_err(k.split(":")[1])),
        per)
    gla = kernel_entry(
        "gla_scan", "src/repro_torch/kernels/csrc/gla_scan.cu",
        "src/repro/kernels/gla_scan.py:30", by_kernel("gla_scan", launches),
        max(errs[f"gla_scan:{name}_prefill/bfloat16/tc"]
            for name in ("rwkv6", "hymba")),
        per)
    fwd_key = {"flash_attention": "flash_forward_device_ms",
               "gla_scan": "gla_forward_device_ms"}
    for entry in (flash, gla):
        name = entry["name"]
        entry["launches_by_variant"] = {
            arch: n[name] for arch, n in variants.items()
            if any(n[name].values())}
        # the training runs: launches (forward + remat recompute), and
        # from one profiled step, the kernel's forward device time beside
        # the device time of its plain backward (the recompute)
        entry["launches_train"] = by_kernel(name, launches_train)
        entry["train_step_device_ms"] = {
            arch: {"forward_kernel": prof[fwd_key[name]],
                   "backward_plain": prof[f"{name}_backward_device_ms"],
                   "step": prof["step_device_ms"],
                   "n_layers": prof["n_layers"]}
            for arch, prof in profiles.items() if launches_train[arch][name]}
    return [flash, gla]


def fill_entry(fill, gate, launches, by_variant):
    """The fill kernel in the kernels line: ms and plain_ms (eager, CUDA
    events), device_ms (in a CUDA graph) and bound_ms of one call on the
    contended batch of 64 gate-point problems, the chosen kernel's (reg),
    the first design's (smem_*) beside them, and the uncontended batch's;
    its launches on the lockstep gate runs, the main path (the full matrix
    and the profiled seeds), by variant."""
    c = fill["contended"]
    keys = ("corpus", "shape", "variant", "ms", "host_us", "device_ms",
            "smem_ms", "smem_host_us", "smem_device_ms", "us_per_round",
            "smem_us_per_round", "plain_ms", "plain_host_us",
            "solver_call_ms", "bytes", "ops", "rounds", "max_rounds",
            "bound_ms")
    return {
        "name": "fill", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fill.cu",
        "replaces": "src/repro/sweep/vmap_fill.py:182",
        "launches": launches, "max_abs_err": fill["max_abs_err"],
        "ms": c["ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": None,
        "library": "none: no PyTorch call computes a progressive fill",
        "variant": c["variant"], "launches_by_variant": by_variant,
        "device_ms": c["device_ms"], "smem_ms": c["smem_ms"],
        "smem_device_ms": c["smem_device_ms"],
        "per_call": {name: {k: fill[name][k] for k in keys}
                     for name in FILL_TIMED},
        "main_path": {"batches": gate["batched"]["batches"],
                      "profiled_batches": gate["profile"]["batches"],
                      "per_batch_split": gate["profile"]["per_batch"],
                      "hold_short": gate["profile"]["hold_short"],
                      "fill_s": gate["batched"]["fill_s"],
                      "wall_s": gate["batched"]["wall_s"],
                      "scalar_fill_s": gate["scalar"]["fill_s"],
                      "scalar_wall_s": gate["scalar"]["wall_s"]},
    }


if __name__ == "__main__":
    main()
