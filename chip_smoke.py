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
  mesh       - the multi-device layer at world size 1 on NCCL, over a
               (1, 1) ('pod', 'data') DeviceMesh: each collective returns
               its input bit for bit; _partition_pack on the card equals
               it on the CPU for one shard of each job and corpus kind;
               mesh_mapreduce under JoSS policy A over the mapreduce
               phase's 4 blocks a kind equals the merge of each block's
               local_mapreduce bit for bit, nothing dropped, no record
               across a pod
  fill       - the batched progressive fill kernel's two variants (reg,
               the chosen one, and smem, the first design) against its
               plain version on the card and the scalar reference on the
               CPU, bit for bit, on fill problems captured from the
               simulator and on boundary corpora made from a seed; both
               variants timed in turns on two batches of 64 problems
  lockstep   - the scheduler's lockstep sweep (480 cells) through the fill
               kernel against the scalar inline path; launches by variant
  scheduler  - the fleet, chaos, telemetry and reference-fabric layers held
               to the committed anchors (the 25 golden trajectories with
               telemetry off and on, fast vs reference fabric, the chaos
               gate, the migration probe, the 320-cell elastic claim rows,
               the trace probe), telemetry's overhead at 4096 hosts, the
               paper's §6 comparison, and a mixed matrix through the
               lockstep backend (fabric cells on the fill kernel, elastic
               and chaos cells on the scalar fallback)
  sweep_pool - the sweep's process pool of spawned workers, its result
               store and its selftest family, and the naive dispatch
               reference: bench_sweep's 15-cell determinism matrix
               inline, shuffled and on 4 workers (its aggregate sha
               equal to BENCH_sweep.json's), a cold and a warm store run,
               crashed, hung and poisoned selftest cells on 2 workers, no
               worker with CUDA initialised; the reference against the
               indexed algorithms on the paper workload, and both sides'
               assign rates at BENCH_dispatch.json's sizes (host times)
  3. kernel  - flash_attention (each case on the kernel the wrapper
               chooses, tc / split / simt; split at several n_split; the
               simt kernel also at the bf16 serving shapes) and gla_scan
               (bf16 cases on tc and on simt, f32 cases on simt) against
               their plain versions on the card, at the serving and
               training shapes of every family and at edge cases, every
               head dim the kernels take (16-160: stablelm-12b's 160 at
               its serving and training shapes, and a tp rank's through
               the two-step decode)
  4. wiring  - qwen3-4b, stablelm-12b (head dim 160, layernorm),
               rwkv6-7b, hymba-1.5b, dbrx-132b, internvl2-26b and
               whisper-medium at full width, 1-2 layers, f32: prefill
               + one decode step with the kernels vs with the plain
               versions (attn_impl="ref"/"chunked", gla_impl="chunked");
               and rwkv6-7b and hymba-1.5b in bf16, gla_impl="kernel" (the
               tc kernel) vs "chunked", beside two control readings: the
               plain model with a GLA scan broken on purpose
  5. serve   - the main paths: JoSS routing -> prefill -> greedy decode of
               qwen3-4b, stablelm-12b, qwen2.5-14b, granite-3-2b,
               rwkv6-7b, hymba-1.5b, internvl2-26b and whisper-medium at
               full width and depth, dbrx-132b (8 of 40 layers) and
               arctic-480b (2 of 35) at full width, bf16 (all ten
               configs);
               counts each kernel's launches in each run, and the launches
               by variant (flash: prefill tc, decode split; GLA: tc)
  6. times   - each kernel, its plain version and (for attention) SDPA as
               a yardstick, at the serving shapes, beside the least time
               the card could take: eager calls timed by CUDA events (ms)
               and the host's cost a call, and in CUDA graphs (device_ms);
               the chosen kernel and the simt kernel (the first design) in
               turns in the same run; at qwen3-4b's and stablelm-12b's
               training shape (B 4 x 1024) also the forward plus the plain
               backward a training step runs, and that backward alone,
               beside SDPA's forward plus backward and its backward alone
  7. grad    - gradients through the kernels' autograd Functions (kernel
               forward, the caller's plain backward) against autograd of
               the plain functions, at the serving and training shapes and
               a ragged one; the raw wrappers must refuse grad-requiring
               inputs
  8. train_wiring - qwen3-4b, hymba-1.5b and internvl2-26b at full
               width, 2 layers, and dbrx-132b at 1 layer with 4 of its 16
               experts, f32: loss, every gradient and three
               make_train_step steps with the kernels vs the all-plain
               model (attn_impl="chunked", gla_impl="chunked") from the
               same weights, beside a control with attention's q/k/v
               gradients zeroed
  9. train   - the training main paths in bf16: qwen3-4b, granite-3-2b
               and whisper-medium at full width and depth, hymba-1.5b at
               16 layers, rwkv6-7b at 8, stablelm-12b at 12, qwen2.5-14b
               at 10, dbrx-132b at 1 layer, arctic-480b at 1 layer with
               32 of its 128 experts, internvl2-26b at 10 layers, each on
               batches of the JoSS policy-B pipeline (and whisper's
               frames, internvl2's patches) and then one batch repeated
               (its loss must fall); launches counted per run, one step
               profiled; then qwen3-4b at 4 layers: n_micro 2 vs 1, int8
               compression, a checkpoint round trip; then dbrx-132b's
               one-layer backward twice on one batch, every gradient's
               bits compared (the MoE dispatch's gather backward adds
               each token's k rows)
  moe_ep     - the expert-parallel MoE body (models/moe_ep.py) of
               dbrx-132b at full width (16 experts, top-4), bf16, B 4 x
               1024, for 4 ranks in one process, the all_to_all done as
               the tensor transpose it performs: equal to the dense
               moe_ffn at a capacity factor with no drops; at the config's
               1.25, in f32 on 4 x 256 tokens routed unevenly, the card
               equal to the CPU, the same pairs dropped; time and peak
               memory; the dense fallback at 'model' 1 (data_fallback),
               B 4 x 1024 routed unevenly as 4 data ranks, bf16 and f32:
               the pairs of the one-device dispatch of the whole batch
               kept exactly, beside a control that dispatches each rank's
               rows alone and must drop another count
  train_sharded - the sharded train step (train/sharded.py) at world size
               1 on NCCL, over a (1, 1) ('data', 'model') mesh: qwen3-4b
               at full width, 4 layers, B 4 x 1024, n_micro 2, through the
               flash kernel, three steps bit for bit against the unsharded
               step from the same weights
  tp         - tensor parallelism over 'model' (sharding/tp.py) as 4
               virtual ranks in this process: qwen3-4b at full width, 4
               layers, in f32 and in bf16, a rank's 8 heads and 2 kv heads
               through the flash kernel (attn_fwd_tc in bf16); the forward
               (B 4 x 1024), three train steps and a 512-token prefill with
               32 teacher-forced decode steps (the cache's 544 slots split
               136 a rank, the ranks' decode partials merged) against the
               unsharded model from the same weights (the bf16 steps
               also beside the n_micro control, the ranks' sums in f32 and
               a planted fault the gate must reject); then the other
               families and stablelm-12b (a rank's 8 heads at head dim
               160) at full width, 1-2 layers; the two decode steps
               against their plain versions; the launches by shape, the
               per-rank calls timed and held to their plain versions
  dryrun     - python -m repro_torch.launch.dryrun --all --both-meshes in a
               CPU process started before phase 3 on a core of its own
               (this process keeps the others), read after phase 9: 80
               rows, 16 SKIP, no FAIL
Each phase prints JSON lines; the run ends with the nvidia-smi line, the
kernels line and, last, the device line. Imports nothing of JAX or of the
JAX package.
"""
import contextlib
import dataclasses
import gc
import hashlib
import itertools
import json
import math
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.distributed.device_mesh import init_device_mesh

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import mapreduce as mr  # noqa: E402
from repro_torch.chaos import ChaosConfig, ResponseConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.joss import JossT, make_algorithm  # noqa: E402
from repro_torch.core.reference import (ReferenceJossT,  # noqa: E402
                                        make_reference_algorithm)
from repro_torch.core.topology import (ElasticLinks, HostId,  # noqa: E402
                                       VirtualCluster)
from repro_torch.data import JossDataPipeline, TokenStore  # noqa: E402
from repro_torch.elastic import (BacklogThresholdScaler,  # noqa: E402
                                 ChurnConfig, DurabilityConfig,
                                 ElasticEngine, FixedFleet, MigrationConfig)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import fill as fk  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gla_scan as gs  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.autograd import BACKWARD_SPANS  # noqa: E402
from repro_torch.mapreduce import engine as mre  # noqa: E402
from repro_torch.mapreduce.jobs import EMPTY  # noqa: E402
from repro_torch.models import (build_model, prefix_len,  # noqa: E402
                                side_inputs)
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.recurrence import gla_chunked  # noqa: E402
from repro_torch.obs import TelemetryConfig  # noqa: E402
from repro_torch.serve.lm import serve  # noqa: E402
from repro_torch.models.moe import Experts, moe_ffn  # noqa: E402
from repro_torch.models.moe_ep import (moe_ffn_ep_virtual,  # noqa: E402
                                       moe_ffn_fallback_virtual,
                                       moe_ffn_held)
from repro_torch.models.rwkv6 import TimeMix  # noqa: E402
from repro_torch.models.transformer import (Attention,  # noqa: E402
                                            kv_index, tp_argmax)
from repro_torch.sharding import DEFAULT_RULES  # noqa: E402
from repro_torch.sharding import collectives as col  # noqa: E402
from repro_torch.sharding import tp as tpm  # noqa: E402
from repro_torch.sim import experiment, golden  # noqa: E402
from repro_torch.sim import workloads as wl  # noqa: E402
from repro_torch.sim.cluster_sim import SimConfig, Simulator  # noqa: E402
from repro_torch.sim.network import FabricConfig  # noqa: E402
from repro_torch.sweep import (CellSpec, ResultStore,  # noqa: E402
                               SweepEngine, aggregate_cells, aggregate_json,
                               make_params, matrix, run_cell)
from repro_torch.sweep import lockstep  # noqa: E402
from repro_torch.sweep import vmap_fill as vf  # noqa: E402
from repro_torch.train import (OptConfig, TrainConfig, adamw_init,  # noqa: E402
                               init_train_state, make_train_step)
from repro_torch.train.optimizer import (adamw_leaf,  # noqa: E402
                                         adamw_scalars, decays,
                                         global_norm)
from repro_torch.train.step import accumulate_grads  # noqa: E402
from repro_torch.train.checkpoint import AsyncCheckpointer  # noqa: E402
from repro_torch.train.sharded import ShardedTraining  # noqa: E402
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
SERVE = {"qwen3-4b": (8, 512, 32), "stablelm-12b": (8, 512, 32),
         "qwen2.5-14b": (8, 512, 32), "granite-3-2b": (8, 512, 32),
         "rwkv6-7b": (8, 512, 32),
         "hymba-1.5b": (8, 2048, 32), "dbrx-132b": (8, 512, 32),
         "arctic-480b": (8, 512, 32), "internvl2-26b": (8, 512, 32),
         "whisper-medium": (8, 224, 32)}
# depth cut only where one card forces it, bf16: 8 of dbrx-132b's 40
# layers (6.5 GB each) and 2 of arctic-480b's 35 (27.3 GB each) fill ~55
# GB; internvl2-26b (~40 GB, its vision frontend a stub), whisper-medium
# and the dense configs run at full depth (stablelm-12b's weights ~24.3
# GB, qwen2.5-14b's ~29.5, granite-3-2b's ~5)
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
    """Returns {kind: (tokens, lengths)}, the 4 padded block shards a kind
    on the card, for phase mesh."""
    mean_len = {}
    blocks = {}
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
        blocks[kind] = (st, sl)
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
    return blocks


# ------------------------------------------------------------------ mesh --
# the multi-device layer on one card, world size 1 on NCCL: what a rank
# does is all there (map, pack, all_to_all, reduce), each collective
# returning its input. Policy A shards the blocks over ('pod', 'data') and
# shuffles over 'data'. The pack check buckets by MESH_PACK_DEST
# destinations, as a rank of an 8-rank shuffle would
MESH_PACK_DEST = 8
MESH_SLACK = 4          # mesh_mapreduce's default


def bit_equal(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def merge_local(spec, st, sl):
    """Each block's local_mapreduce, merged by key: (keys, counts)."""
    ks, vs = [], []
    for t, l in zip(st, sl):
        k, v, n = mr.local_mapreduce(spec, t, l)
        ks.append(k[:int(n)])
        vs.append(v[:int(n)])
    k, v = torch.cat(ks), torch.cat(vs)
    del ks, vs
    uk, uv, _, n = mre._sort_reduce(k, v, torch.zeros_like(v),
                                    combined_bytes=False)
    n = int(n)
    return uk[:n].clone(), uv[:n].clone()


def mesh_checks(blocks):
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("pod", "data"))
    x = torch.randn((8, 4096), generator=torch.Generator(device=DEV)
                    .manual_seed(21), device=DEV)
    got = {"hierarchical_psum": col.hierarchical_psum(x, mesh),
           "flat_psum": col.flat_psum(x, mesh),
           "grad_allreduce": col.make_grad_allreduce(mesh)({"g": x})["g"],
           "grad_allreduce_flat": col.make_grad_allreduce(
               mesh, hierarchical=False)({"g": x})["g"],
           "two_hop_all_to_all": col.two_hop_all_to_all(
               x[None], mesh, pod_axis="pod", inner_axis="data")[0]}
    same = {name: bit_equal(y, x) for name, y in got.items()}
    emit(phase="mesh", part="collectives", backend=dist.get_backend(),
         nccl=".".join(map(str, torch.cuda.nccl.version())),
         world_size=dist.get_world_size(), mesh=dict(pod=1, data=1),
         shape=list(x.shape), bit_equal=same)
    check(all(same.values()), f"a collective at world size 1 changed its "
                              f"input: {same}")
    # _partition_pack on the card against the CPU, one shard a job and kind
    for kind in MR_KINDS:
        tok, lng = mr.corpus(kind, MR_EQ_TOKENS, seed=2000)
        host = (torch.from_numpy(tok), torch.from_numpy(lng))
        for name, spec in mr.JOBS.items():
            cap_dest = MESH_SLACK * -(-MR_EQ_TOKENS * spec.cap_mult
                                      // MESH_PACK_DEST)
            packs = []
            for dev in ("cpu", DEV):
                kv = mre.run_map(spec, host[0].to(dev), host[1].to(dev), 0)
                packs.append(mre._partition_pack(kv, MESH_PACK_DEST,
                                                 cap_dest))
            equal = all(bit_equal(a, b.cpu()) for a, b in zip(*packs))
            emit(phase="mesh", part="partition_pack", kind=kind, job=name,
                 tokens=MR_EQ_TOKENS, n_dest=MESH_PACK_DEST,
                 cap_dest=cap_dest, dropped=int(packs[1][2]),
                 bit_equal_cpu=equal)
            check(equal, f"_partition_pack {name} on {kind}: the card and "
                         f"the CPU disagree")
            del packs
    # mesh_mapreduce, policy A, over the blocks
    for kind, (st, sl) in blocks.items():
        for name, spec in mr.JOBS.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = mr.mesh_mapreduce(spec, st, sl, mesh, shuffle_axes=("data",),
                                    shard_axes=("pod", "data"),
                                    slack=MESH_SLACK)
            rows = mr.gather_groups(res, mesh, ("pod", "data"))
            n = int(rows.n_unique[0])
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            slots = rows.unique_keys.shape[1]
            keys = rows.unique_keys[0, :n].clone()
            counts = rows.counts[0, :n].clone()
            tail_empty = bool((rows.unique_keys[0, n:] == EMPTY).all()
                              and (rows.counts[0, n:] == 0).all())
            dropped, cross = int(rows.dropped[0]), int(rows.cross_pod[0])
            records = int(rows.records[0])
            del res, rows
            torch.cuda.empty_cache()
            want_k, want_v = merge_local(spec, st, sl)
            equal = bit_equal(keys, want_k) and bit_equal(counts, want_v)
            emit(phase="mesh", part="mesh_mapreduce", policy="A", kind=kind,
                 job=name, shards=st.shape[0], shard_tokens=st.shape[1],
                 records=records, slots=slots, n_unique=n, dropped=dropped,
                 cross_pod=cross, seconds=secs, peak_mem_gb=peak,
                 equal_local_merge=equal, tail_empty=tail_empty,
                 reduced=[])
            check(equal and tail_empty and dropped == 0 and cross == 0,
                  f"mesh_mapreduce {name} on {kind}: equal {equal}, tail "
                  f"{tail_empty}, dropped {dropped}, cross-pod {cross}")
            del keys, counts, want_k, want_v
            torch.cuda.empty_cache()


def phase_mesh(blocks):
    """World size 1 on NCCL, the rendezvous a file of a temporary
    directory; the process group is destroyed however the phase ends."""
    rendezvous = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}/rv",
                            world_size=1, rank=0)
    try:
        mesh_checks(blocks)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
        blocks.clear()
        torch.cuda.empty_cache()


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


# ---------------------------------------------------------- scheduler --
# The fleet, chaos and telemetry layers and the per-flow reference fabric
# are host code: this phase holds them to the anchors committed beside the
# JAX package (tests/golden/sim_trajectories.json and the BENCH_chaos,
# BENCH_elastic and BENCH_obs files), each gate point restated from the
# JSON it reads, and times the host work at the sizes users run.
SCHED_ALGOS = ("joss-t", "joss-j", "fifo", "fair", "capacity")
# bench_sweep's elastic claim matrix: 5 algorithms x 2 scenarios x 32
# seeds on an 8 + 8 fleet, 40 jobs a cell
SCHED_ELASTIC = dict(scenarios=("flaky", "spot"), seeds=32,
                     fleet=(8, 8), n_jobs=40)
SCHED_ELASTIC_METRICS = ("wtt", "work_lost_mb", "cost_dollars", "n_reexec")
# bench_obs's overhead point: the 4096-host virtual cluster (4 pods of
# 1024 dual-slot hosts, WAN 8x oversubscribed) with a 1536-job burst
# backlog; best of SCHED_OVERHEAD_PAIRS interleaved off/on pairs
SCHED_SCALE = dict(hosts_per_pod=(1024,) * 4, n_jobs=1536, slots=2,
                   wan_oversub=8.0, algo="joss-t", seed=11)
SCHED_OVERHEAD_PAIRS = 3


def sched_e2e(allocator, variant, elastic_links=None):
    """tests/test_fabric_fastpath.py's end-to-end case: 12 jobs on a 4 + 4
    fleet with the fabric at WAN 8x, under one allocator."""
    cluster = wl.make_cluster(
        (4, 4), links=wl.fabric_links((4, 4), wan_oversub=8.0))
    jobs = wl.small_workload(cluster, seed=11, n_jobs=12)
    algo = sched_prep("joss-t", cluster)
    cfg_kw, elastic = {}, None
    if variant in ("churn", "churn+durability"):
        dur = (DurabilityConfig(rereplicate=True, rerep_delay=5.0,
                                checkpoint=True)
               if variant == "churn+durability" else None)
        elastic = ElasticEngine(
            cluster, churn=ChurnConfig(seed=12, fail_rate=4.0,
                                       rejoin_delay=60.0),
            autoscaler=FixedFleet(), durability=dur)
    elif variant == "speculative":
        cfg_kw = dict(speculative=True, slow_hosts={HostId(0, 0): 4.0})
    el = ElasticLinks(**elastic_links) if elastic_links else None
    cfg = SimConfig(fabric=FabricConfig(allocator=allocator, elastic=el),
                    **cfg_kw)
    res = Simulator(cluster, algo, jobs, config=cfg, seed=11,
                    elastic=elastic).run()
    check(len(res.job_finish) == 12, f"fabric case {variant}: jobs lost")
    return res


def sched_prep(algo_name, cluster):
    """The algorithm, its FP registry warmed by the profiling prelude."""
    algo = make_algorithm(algo_name, cluster)
    if hasattr(algo, "registry"):
        for j in wl.profiling_prelude(cluster):
            algo.registry.record(j, j.true_fp)
    return algo


def sched_chaos_probe(algo_name, detect, gate):
    """bench_chaos's gate probe at the point BENCH_chaos.json stores."""
    cluster = wl.make_cluster(tuple(gate["hosts_per_pod"]))
    jobs = wl.small_workload(cluster, seed=gate["seed"],
                             n_jobs=gate["n_jobs"])
    algo = sched_prep(algo_name, cluster)
    response = (ResponseConfig(grace=gate["grace"],
                               quarantine_at=gate["quarantine_at"])
                if detect else None)
    cfg = SimConfig(chaos=ChaosConfig(seed=gate["chaos_seed"],
                                      **gate["campaign"]),
                    response=response)
    res = Simulator(cluster, algo, jobs, config=cfg, seed=gate["seed"]).run()
    check(len(res.job_finish) == len(jobs), f"chaos {algo_name}: jobs lost")
    return res


def sched_migration_probe(algo_name, migrate, probe):
    """bench_migration's gate probe at the point BENCH_elastic.json
    stores: every host 6x slow, heavy spot churn, a 30 s notice."""
    hpp = tuple(probe["hosts_per_pod"])
    cluster = wl.make_cluster(hpp)
    jobs = wl.small_workload(cluster, seed=probe["seed"],
                             n_jobs=probe["n_jobs"])
    algo = sched_prep(algo_name, cluster)
    slow = {HostId(p, i): probe["slow"]
            for p, n in enumerate(hpp) for i in range(n)}
    churn = ChurnConfig(seed=probe["seed"] + 1,
                        spot_fraction=probe["spot_fraction"],
                        spot_preempt_rate=probe["spot_preempt_rate"],
                        preempt_notice=probe["notice"],
                        expire_notice=probe["notice"])
    eng = ElasticEngine(cluster, churn=churn, autoscaler=FixedFleet(),
                        migration=MigrationConfig() if migrate else None)
    res = Simulator(cluster, algo, jobs, config=SimConfig(slow_hosts=slow),
                    seed=probe["seed"], elastic=eng).run()
    check(len(res.job_finish) == len(jobs), f"migration {algo_name}: lost")
    return res


def sched_trace_probe(n_jobs, seed):
    """bench_obs's trace probe: a churny elastic fleet (8 + 8 dual-slot
    hosts) with a backlog-threshold autoscaler on a contended fabric."""
    cluster = wl.make_cluster((8, 8), map_slots=2)
    jobs = wl.small_workload(cluster, seed=seed, n_jobs=n_jobs)
    cfg = SimConfig(fabric=FabricConfig(links=wl.fabric_links((8, 8))),
                    telemetry=TelemetryConfig())
    eng = ElasticEngine(
        cluster,
        churn=ChurnConfig(seed=5, fail_rate=0.5, rejoin_delay=90.0),
        autoscaler=BacklogThresholdScaler(min_hosts=4))
    return Simulator(cluster, make_algorithm("joss-t", cluster), jobs,
                     config=cfg, seed=seed, elastic=eng).run()


def sched_scale_run(telemetry):
    """One run of the overhead point: (result, events/s of process time),
    events being the submits and task completions, as bench_obs counts."""
    p = SCHED_SCALE
    hpp = p["hosts_per_pod"]
    cluster = wl.make_cluster(hpp, links=wl.fabric_links(
        hpp, wan_oversub=p["wan_oversub"]), map_slots=p["slots"],
        reduce_slots=p["slots"])
    jobs = wl.small_workload(cluster, seed=p["seed"], n_jobs=p["n_jobs"])
    for j in jobs:
        j.submit_time = 0.0
    algo = sched_prep(p["algo"], cluster)
    cfg = SimConfig(fabric=FabricConfig(log_limit=0), telemetry=telemetry)
    n_events = p["n_jobs"] + sum(j.m + len(j.reduce_tasks) for j in jobs)
    t0 = time.process_time()
    res = Simulator(cluster, algo, jobs, config=cfg, seed=p["seed"]).run()
    dt = time.process_time() - t0
    check(len(res.job_finish) == p["n_jobs"], "scale point: jobs lost")
    return res, n_events / dt


def phase_scheduler():
    """The scheduler's fleet, chaos, telemetry and reference-fabric layers
    held to the committed anchors, the paper's §6 comparison, and a mixed
    matrix through the lockstep backend, whose fabric cells batch through
    the fill kernel on the card."""
    root = Path(__file__).resolve().parent
    bench = {k: json.loads((root / f"BENCH_{k}.json").read_text())
             for k in ("chaos", "elastic", "obs")}
    out = {}

    # the 25 golden trajectories, telemetry off and on
    want = golden.load_golden()
    t0 = time.perf_counter()
    bad = [(golden.case_key(a, v), tel is not None)
           for a, v in golden.golden_cases()
           for tel in (None, TelemetryConfig())
           if golden.signature_hash(golden.run_case(a, v, telemetry=tel))
           != want[golden.case_key(a, v)]]
    out["golden_s"] = time.perf_counter() - t0
    emit(phase="scheduler", part="golden", cases=len(want),
         runs=2 * len(want), seconds=out["golden_s"], differing=bad)
    check(len(want) == 25 and not bad, f"golden hashes differ: {bad}")

    # the fast fabric against the per-flow reference, bit for bit
    t0 = time.perf_counter()
    cases = [(v, None) for v in ("static", "churn", "churn+durability",
                                 "speculative")]
    cases.append(("churn+durability", dict(host_up=220.0, host_down=220.0,
                                           wan_per_host=35.0)))
    fabric_eq = {}
    for v, el in cases:
        fast, ref = (sched_e2e(a, v, el) for a in ("fast", "reference"))
        fabric_eq[v + ("+elastic_links" if el else "")] = (
            bool(fast.fabric.completion_log)
            and fast.fabric.completion_log == ref.fabric.completion_log
            and golden.full_signature(fast) == golden.full_signature(ref))
    emit(phase="scheduler", part="fabric_reference", equal=fabric_eq,
         seconds=time.perf_counter() - t0)
    check(all(fabric_eq.values()), f"reference fabric differs: {fabric_eq}")

    # the chaos gate of BENCH_chaos.json, detection on and off
    t0 = time.perf_counter()
    stored = bench["chaos"]
    rows, sig = {}, {}
    for a in SCHED_ALGOS:
        off = sched_chaos_probe(a, False, stored["gate"])
        on = sched_chaos_probe(a, True, stored["gate"])
        rows[a] = dict(off_wtt=off.wtt, off_reexec=off.n_reexec, wtt=on.wtt,
                       reexec=on.n_reexec, n_timeouts=on.n_timeouts,
                       n_quarantined=on.n_quarantined,
                       n_surfaced=on.n_surfaced)
        if a == "joss-t":
            sig = dict(chaos_signature=on.chaos.signature(),
                       response_signature=on.response.signature())
    chaos_eq = {a: rows[a] == stored["algos"][a] for a in SCHED_ALGOS}
    sig_eq = all(sig[k] == stored[k] for k in sig)
    emit(phase="scheduler", part="chaos_gate", rows=rows, equal=chaos_eq,
         signatures_equal=sig_eq, seconds=time.perf_counter() - t0)
    check(all(chaos_eq.values()) and sig_eq,
          f"chaos gate differs from BENCH_chaos.json: {chaos_eq} {sig_eq}")

    # the migration probe of BENCH_elastic.json
    t0 = time.perf_counter()
    stored = bench["elastic"]["migration"]
    rows = {}
    for a in SCHED_ALGOS:
        base = sched_migration_probe(a, False, stored["probe"])
        mig = sched_migration_probe(a, True, stored["probe"])
        rows[a] = dict(base_lost=base.work_lost_mb, base_reexec=base.n_reexec,
                       lost=mig.work_lost_mb, reexec=mig.n_reexec,
                       n_migrated=mig.n_migrated)
        if a == "joss-t":
            mig_sig = mig.migration.signature()
    mig_eq = {a: rows[a] == stored["algos"][a] for a in SCHED_ALGOS}
    emit(phase="scheduler", part="migration_probe", rows=rows, equal=mig_eq,
         signature_equal=mig_sig == stored["signature"],
         seconds=time.perf_counter() - t0)
    check(all(mig_eq.values()) and mig_sig == stored["signature"],
          f"migration probe differs from BENCH_elastic.json: {mig_eq}")

    # the elastic claim matrix (320 cells) against its committed rows
    e = SCHED_ELASTIC
    specs = matrix("elastic_churn", SCHED_ALGOS, e["scenarios"], e["seeds"],
                   fleet=e["fleet"], n_jobs=e["n_jobs"])
    results, st = SweepEngine().run(specs)
    claim = json.loads(json.dumps(aggregate_cells(
        results, metrics=SCHED_ELASTIC_METRICS)))
    stored = bench["elastic"]["claims"]
    claims_eq = claim == stored["rows"] and e["seeds"] == stored["n_seeds"]
    out["elastic_s"] = st.wall_s
    emit(phase="scheduler", part="elastic_matrix", cells=st.n_cells,
         rows=len(claim), equal=claims_eq, seconds=st.wall_s,
         cells_per_s=st.cells_per_s)
    check(claims_eq, "elastic claim rows differ from BENCH_elastic.json")

    # the telemetry trace probe of BENCH_obs.json
    probe = bench["obs"]["probe"]
    tr = sched_trace_probe(probe["n_jobs"], probe["seed"]).telemetry.trace
    got = dict(sha256=tr.sha256(), n_events=len(tr))
    emit(phase="scheduler", part="trace_probe", **got,
         equal=got == dict(sha256=probe["sha256"],
                           n_events=probe["n_events"]))
    check(got == dict(sha256=probe["sha256"], n_events=probe["n_events"]),
          f"trace probe differs from BENCH_obs.json: {got}")

    # telemetry's overhead at the 4096-host point, bench_obs's way: a
    # discarded warmup, gc before every timed run, interleaved pairs
    gate = bench["obs"]["gate"]
    p = SCHED_SCALE
    check(list(p["hosts_per_pod"]) == gate["hosts_per_pod"]
          and p["n_jobs"] == gate["n_jobs"] and p["seed"] == gate["seed"]
          and p["slots"] == gate["map_slots"] and p["algo"] == gate["algo"]
          and p["wan_oversub"] == gate["wan_oversub"],
          "the scale point is not BENCH_obs.json's")
    t0 = time.perf_counter()
    sched_scale_run(None)
    pairs = []
    for _ in range(SCHED_OVERHEAD_PAIRS):
        gc.collect()
        r_off, ev_off = sched_scale_run(None)
        gc.collect()
        r_on, ev_on = sched_scale_run(TelemetryConfig())
        check((r_off.wtt, r_off.int_bytes) == (r_on.wtt, r_on.int_bytes),
              "telemetry moved the scale point's trajectory")
        pairs.append((ev_off, ev_on))
    ev_off, ev_on = max(pairs, key=lambda q: q[1] / q[0])
    ratio = ev_on / ev_off
    out.update(off_events_per_s=ev_off, on_events_per_s=ev_on, ratio=ratio)
    emit(phase="scheduler", part="telemetry_overhead",
         hosts=sum(p["hosts_per_pod"]), n_jobs=p["n_jobs"],
         wtt=r_off.wtt, int_mb=r_off.int_bytes, pairs=pairs,
         off_events_per_s=ev_off, on_events_per_s=ev_on, ratio=ratio,
         floor=gate["floor"], seconds=time.perf_counter() - t0)
    check(ratio >= gate["floor"],
          f"telemetry overhead {ratio:.3f} below {gate['floor']}")

    # the paper's §6 comparison at its full size (python -m
    # repro_torch.sim.experiment --full)
    t0 = time.perf_counter()
    for title, res in experiment.paper_tables(full=True):
        rows = {a: experiment.table_row(s) for a, s in res.items()}
        emit(phase="scheduler", part="paper_table", table=title, rows=rows)
        check(all(math.isfinite(v) for r in rows.values()
                  for v in r.values()), f"{title}: non-finite row")
    out["paper_s"] = time.perf_counter() - t0
    emit(phase="scheduler", part="paper", seconds=out["paper_s"])

    # a mixed matrix through the lockstep backend: one seed of the fabric
    # gate (batched through the fill kernel), elastic_matrix(2) and the
    # chaos campaigns (both on the scalar fallback)
    specs = (lockstep.gate_matrix(1)
             + matrix("elastic_churn", SCHED_ALGOS, e["scenarios"], 2,
                      fleet=e["fleet"], n_jobs=e["n_jobs"])
             + matrix("chaos", SCHED_ALGOS, tuple(wl.chaos_scenarios()), 1))
    n_fallback = sum(s.family != "fabric_contention" for s in specs)
    fk.fill_rates_dt.launches = 0
    fk.fill_rates_dt.launches_by_variant = {v: 0 for v in fk.VARIANTS}
    eng = SweepEngine(backend="lockstep", device=DEV)
    got, st = eng.run(specs)
    launches = fk.fill_rates_dt.launches
    by_variant = dict(fk.fill_rates_dt.launches_by_variant)
    ls = eng.lockstep_stats
    differing = [k for k in got
                 if got[k] != run_cell(CellSpec.from_key(k))]
    out.update(lockstep_s=st.wall_s, lockstep_launches=launches)
    emit(phase="scheduler", part="lockstep_mixed", cells=st.n_cells,
         batched=st.n_cells - ls.n_fallback, n_fallback=ls.n_fallback,
         expected_fallback=n_fallback, batches=ls.batches,
         launches=launches, launches_by_variant=by_variant,
         epochs=ls.epochs, problems=ls.problems,
         fill_s=ls.fill_s, seconds=st.wall_s, cells_differing=differing)
    check(not differing, f"lockstep cells differ from run_cell: {differing}")
    check(ls.n_fallback == n_fallback and st.n_cells == len(specs),
          f"fallback {ls.n_fallback} != {n_fallback}")
    check(launches > 0 and launches == ls.batches,
          f"fill launches {launches} != batches {ls.batches}")
    return out


# ---------------------------------------------------------- sweep_pool --
# The sweep's process pool, its result store and its selftest family, and
# the naive dispatch reference: host code. Every pool worker is spawned:
# it imports this module afresh as __mp_main__ (whose top level makes no
# CUDA call) and runs its cells on the host, never initialising CUDA.
#
# bench_sweep's determinism anchor: seed 0 of its contention matrix (5
# algorithms x 3 scenarios on 8 + 8 hosts, 12 jobs), its aggregate over
# the claim metrics (benchmarks/bench_sweep.py's FABRIC_CLAIM_METRICS)
# hashed, shuffled as bench_sweep shuffles it
POOL_SCENARIOS = ("uncontended", "oversub8", "oversub24")
POOL_MATRIX = dict(hosts_per_pod=(8, 8), n_jobs=12)
POOL_CLAIM_METRICS = ("wtt", "int_mb")
POOL_SHUFFLE_SEED = 0xC0FFEE
POOL_WORKERS = 4
# the selftest runs: 2 workers. A cell's timeout also counts the start-up
# of the pool's spawned workers (each imports torch and this file afresh),
# which took 8-15 s on the card's host and once over 15 s, timing out the
# hung cell's retries as well; 60 s leaves that start-up four times over
SELFTEST_WORKERS = 2
SELFTEST_TIMEOUT_S = 60.0
SELFTEST_FAST = dict(retry_backoff_s=0.05, retry_backoff_cap_s=0.2)
# bench_overhead's assign-rate point: 200 jobs of 8 blocks, best of 3
ASSIGN_JOBS, ASSIGN_BLOCKS, ASSIGN_REPS = 200, 8, 3


def pool_run(engine, specs, worker_cuda):
    """``engine.run(specs)``, its workers' CUDA reports gathered."""
    res, st = engine.run(specs)
    worker_cuda.update(st.worker_cuda)
    return res, st


def selftest_cells(flag_dir, scenario=None):
    ok = [CellSpec("selftest", "a", "ok", i) for i in range(4)]
    if scenario is None:
        return ok
    return ok + [CellSpec("selftest", "a", scenario, 0,
                          make_params(flag_dir=flag_dir, hang_s=600.0))]


def reference_sim(factory, name):
    """tests/test_dispatch_fastpath.py's paper-workload run: 12 jobs on a
    4 + 4 fleet, the FP registry warmed by the profiling prelude; the
    metrics and the assignment sequence, jobs by submission index."""
    cluster = wl.make_cluster((4, 4))
    jobs = wl.small_workload(cluster, seed=5, n_jobs=12)
    idx = {j.job_id: i for i, j in enumerate(jobs)}
    algo = factory(name, cluster)
    if hasattr(algo, "registry"):
        for j in wl.profiling_prelude(cluster):
            algo.registry.record(j, j.true_fp)
    res = Simulator(cluster, algo, jobs, seed=5).run()
    check(len(res.job_finish) == len(jobs), f"reference {name}: jobs lost")
    return (res.wtt, res.int_bytes, res.pod_bytes, res.n_reexec,
            sorted((idx[k], v) for k, v in res.job_finish.items()),
            [((lg.task.tid[0], idx[lg.task.tid[1]], *lg.task.tid[2:]),
              lg.host, lg.start, lg.finish) for lg in res.task_logs])


def assign_rate(hosts_per_pod, map_slots, reference):
    """bench_overhead's ``_measure``: tasks assigned a second draining a
    submitted backlog through JoSS-T's ``next_map_task``, slots offered
    pod-major, best of ASSIGN_REPS fresh batches."""
    cluster = VirtualCluster(list(hosts_per_pod), map_slots=map_slots)
    rng = np.random.RandomState(0)
    algo = (ReferenceJossT if reference else JossT)(cluster)
    benches = list(wl.PAPER_BENCHMARKS.values())
    for i, bench in enumerate(benches):
        algo.registry.record(
            wl._mk_job(cluster, bench, 128.0, 0.0, rng, tag=f"p{i}"),
            bench.fp)
    hosts_by_pod = [[h.hid for h in p.hosts] for p in cluster.pods]
    backlog = algo.scheduler.queues.map_backlog
    best = float("inf")
    for rep in range(ASSIGN_REPS):
        for i in range(ASSIGN_JOBS):
            algo.submit(wl._mk_job(cluster, benches[i % len(benches)],
                                   128.0 * ASSIGN_BLOCKS, 0.0, rng,
                                   tag=f"r{rep}-{i}"))
        n = backlog.n
        t0 = time.perf_counter()
        for _ in range(4):
            if not algo.has_map_work():
                break
            for pod_hosts in hosts_by_pod:
                for hid in pod_hosts:
                    if algo.next_map_task(hid) is None:
                        break
        dt = time.perf_counter() - t0
        best = min(best, dt / max(n - backlog.n, 1))
    return 1.0 / best


def phase_sweep_pool():
    root = Path(__file__).resolve().parent
    want_sha = json.loads((root / "BENCH_sweep.json").read_text()
                          )["determinism"]
    dispatch = json.loads((root / "BENCH_dispatch.json").read_text())
    worker_cuda = {}
    out = {}

    # determinism: inline, shuffled, a pool of 4 into a cold store; then
    # the warm run, served from the store without a worker
    t0 = time.perf_counter()
    det = matrix("fabric_contention", SCHED_ALGOS, POOL_SCENARIOS, 1,
                 **POOL_MATRIX)
    shuffled = random.Random(POOL_SHUFFLE_SEED).sample(det, len(det))
    r_inline, st_inline = SweepEngine().run(det)
    r_shuf, _ = SweepEngine().run(shuffled)
    with tempfile.TemporaryDirectory() as store_dir:
        pool = SweepEngine(workers=POOL_WORKERS,
                           store=ResultStore(store_dir))
        r_pool, st_cold = pool_run(pool, det, worker_cuda)
        r_warm, st_warm = pool_run(pool, shuffled, worker_cuda)
        n_entries = sum(1 for _ in Path(store_dir).rglob("*.json"))
    aggs = [aggregate_json(r, metrics=POOL_CLAIM_METRICS)
            for r in (r_inline, r_shuf, r_pool, r_warm)]
    sha = hashlib.sha256(aggs[0].encode()).hexdigest()
    cells_equal = r_inline == r_shuf == r_pool
    warm_equal = (r_warm == r_pool and json.dumps(r_warm, sort_keys=True)
                  == json.dumps(r_pool, sort_keys=True))
    out["determinism_s"] = time.perf_counter() - t0
    emit(phase="sweep_pool", part="determinism", cells=len(det),
         workers=POOL_WORKERS, cells_equal=cells_equal,
         aggregates_identical=len(set(aggs)) == 1, aggregate_sha256=sha,
         bench_sha256=want_sha["aggregate_sha256"],
         inline_s=st_inline.wall_s, pool_s=st_cold.wall_s,
         cold={"executed": st_cold.n_executed, "cached": st_cold.n_cached},
         warm={"executed": st_warm.n_executed, "cached": st_warm.n_cached,
               "s": st_warm.wall_s, "cells_bit_equal": warm_equal},
         store_entries=n_entries, seconds=out["determinism_s"])
    check(len(det) == want_sha["n_cells"] and cells_equal
          and len(set(aggs)) == 1,
          "inline, shuffled and pooled sweeps differ")
    check(sha == want_sha["aggregate_sha256"],
          f"determinism aggregate sha {sha} differs from BENCH_sweep.json's")
    check(st_cold.n_executed == len(det) and st_warm.n_executed == 0
          and st_warm.n_cached == len(det) and warm_equal
          and n_entries == len(det),
          f"the warm store run executed {st_warm.n_executed} cells")

    # the selftest family on 2 workers: a crash retried (beside a
    # crash-free inline run of the same ok cells), a hang charged a
    # timeout and retried, an always-crashing cell poisoned
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as flag_dir:
        crash = selftest_cells(flag_dir, "crash_once")
        noisy, st_crash = pool_run(
            SweepEngine(workers=SELFTEST_WORKERS, **SELFTEST_FAST), crash,
            worker_cuda)
        clean, _ = SweepEngine().run(selftest_cells(flag_dir))
        hang = selftest_cells(flag_dir, "hang_once")
        hung, st_hang = pool_run(
            SweepEngine(workers=SELFTEST_WORKERS,
                        cell_timeout=SELFTEST_TIMEOUT_S, **SELFTEST_FAST),
            hang, worker_cuda)
    poison = [CellSpec("selftest", "a", "crash_always", 0)]
    poisoned, st_poison = pool_run(
        SweepEngine(workers=SELFTEST_WORKERS, max_attempts=2,
                    **SELFTEST_FAST), poison, worker_cuda)
    unaffected = {k: v for k, v in noisy.items() if k in clean}
    agg_identical = (aggregate_json(unaffected, metrics=("ok",))
                     == aggregate_json(clean, metrics=("ok",)))
    rows = {"crash_once": st_crash.cell_report[crash[-1].key()],
            "hang_once": st_hang.cell_report[hang[-1].key()],
            "crash_always": st_poison.cell_report[poison[0].key()]}
    counts = {name: {k: getattr(st, k) for k in (
        "n_retried", "n_poisoned", "n_timeouts", "n_pool_rebuilds")}
        for name, st in (("crash_once", st_crash), ("hang_once", st_hang),
                         ("crash_always", st_poison))}
    out["selftest_s"] = time.perf_counter() - t0
    emit(phase="sweep_pool", part="selftest", workers=SELFTEST_WORKERS,
         cell_timeout_s=SELFTEST_TIMEOUT_S, cells=rows, counts=counts,
         wall_s={"crash_once": st_crash.wall_s, "hang_once": st_hang.wall_s,
                 "crash_always": st_poison.wall_s},
         results={"crash_once": len(noisy), "hang_once": len(hung),
                  "crash_always": len(poisoned)},
         unaffected_aggregate_identical=agg_identical,
         seconds=out["selftest_s"])
    check(len(noisy) == 5 and rows["crash_once"]["status"] == "ok"
          and rows["crash_once"]["crashes"] >= 1
          and st_crash.n_pool_rebuilds >= 1 and st_crash.n_poisoned == 0,
          f"crash_once was not retried to completion: {rows['crash_once']}")
    check(agg_identical, "the crash moved the unaffected cells' aggregate")
    check(len(hung) == 5 and rows["hang_once"]["status"] == "ok"
          and rows["hang_once"]["timeouts"] == 1 and st_hang.n_timeouts == 1,
          f"hang_once was not timed out and retried: {rows['hang_once']}")
    check(poisoned == {} and rows["crash_always"] == {
        "attempts": 2, "crashes": 2, "timeouts": 0, "status": "poisoned"},
        f"crash_always was not poisoned: {rows['crash_always']}")

    emit(phase="sweep_pool", part="workers", workers=len(worker_cuda),
         cuda_initialized=sorted(set(worker_cuda.values())),
         parent_cuda_initialized=torch.cuda.is_initialized())
    check(worker_cuda and not any(worker_cuda.values()),
          f"a pool worker initialised CUDA: {worker_cuda}")

    # the dispatch reference: equal SimResults on the paper workload, and
    # both sides' assign rates at BENCH_dispatch.json's sizes
    t0 = time.perf_counter()
    ref_eq = {a: reference_sim(make_algorithm, a)
              == reference_sim(make_reference_algorithm, a)
              for a in SCHED_ALGOS}
    rates = []
    for point in dispatch["assign"]:
        hpp = [point["hosts"] // point["pods"]] * point["pods"]
        slots = point["map_slots"]
        old = assign_rate(hpp, slots, reference=True)
        new = assign_rate(hpp, slots, reference=False)
        rates.append({"hosts": point["hosts"], "pods": point["pods"],
                      "map_slots": slots, "old_tasks_per_s": old,
                      "new_tasks_per_s": new, "speedup": new / old})
    out["reference_s"] = time.perf_counter() - t0
    emit(phase="sweep_pool", part="dispatch_reference", equal=ref_eq,
         assign=rates, seconds=out["reference_s"])
    check(all(ref_eq.values()),
          f"the reference differs from the indexed algorithms: {ref_eq}")
    return out


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
        ("tc_d160", 1, 200, 300, 10, 2, 160, True, 100, ar(200, 251),
         ring_kpos(300, 450), bf16, None),
    ]
    # stablelm-12b, head dim 160 (H 32, G 8): its prefill (bf16 on tc,
    # f32 on simt), its decode on the 544-slot cache, the decode's ragged
    # and all-masked edges, and its training shape; qwen2.5-14b's (H 40,
    # G 8: the split kernel's 5-row block at D 128) and granite-3-2b's (H
    # 32, G 8, D 64) serving shapes
    stab = get_config("stablelm-12b")
    SH, SG, SD = stab.n_heads, stab.n_kv_heads, stab.hdim
    for dt in (bf16, f32):
        cases += [
            ("stablelm_prefill", 8, P, P, SH, SG, SD, True, 0, ar(P), ar(P),
             dt, None),
            ("stablelm_decode", 8, 1, C, SH, SG, SD, True, 0, ar(1, last),
             ring, dt, None),
            ("stablelm_decode_first", 8, 1, C, SH, SG, SD, True, 0,
             ar(1, P), half, dt, None),
            ("split_ragged_d160", 3, 1, 200, SH, SG, SD, True, 0,
             ar(1, 199), ar(200), dt, None),
            ("split_all_masked_d160", 2, 1, 300, 10, 2, SD, True, 0,
             ar(1, -5), ar(300), dt, None),
        ]
    _, SB, SS = TRAIN["stablelm-12b"][:3]
    cases.append(("stablelm_train", SB, SS, SS, SH, SG, SD, True, 0, ar(SS),
                  ar(SS), bf16, None))
    for arch in ("qwen2.5-14b", "granite-3-2b"):
        c = get_config(arch)
        tag = arch.split("-")[0].replace(".", "")
        cases += [
            (f"{tag}_prefill", 8, P, P, c.n_heads, c.n_kv_heads, c.hdim, True,
             0, ar(P), ar(P), bf16, None),
            (f"{tag}_decode", 8, 1, C, c.n_heads, c.n_kv_heads, c.hdim, True,
             0, ar(1, last), ring, bf16, None)]
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
    # the tp phase's per-rank shapes (qwen3-4b, TP_RANKS 'model' ranks:
    # 8 q heads, 2 kv heads a rank): its forward, a training microbatch
    # and the serving prefill, on the tensor cores in bf16 and the simt
    # kernel in f32, as that phase runs them
    qwen = get_config(SHARDED_ARCH)
    TH, TG = qwen.n_heads // TP_RANKS, qwen.n_kv_heads // TP_RANKS
    TPB, TPS = TP_SHAPE
    for tag, B, S in (("tp_forward", TPB, TPS),
                      ("tp_train", TPB // SHARDED_TCFG.n_micro, TPS),
                      ("tp_prefill", *TP_SERVE[:2])):
        cases += [(tag, B, S, S, TH, TG, qwen.hdim, True, 0, ar(S), ar(S),
                   dt, None) for dt in (bf16, f32)]
    # the other families' rank shapes in the tp phase (TP_FAMILIES, its
    # forward and training rows at (B, S)): a rank's heads, its kv heads
    # or every kv head where they do not divide (kv_index), hymba's 25
    # heads on every rank (gcd(25, 4) = 1), whisper's encoder and
    # cross-attention non-causal over its 1500 encoder positions
    for arch, (cuts, (B, S), _, frames) in TP_FAMILIES.items():
        c = get_config(arch)
        if c.family == "ssm":
            continue
        T = math.gcd(c.n_heads, TP_RANKS)
        Hl = c.n_heads // T
        Gl = (c.n_kv_heads // TP_RANKS if T == TP_RANKS
              and c.n_kv_heads % TP_RANKS == 0 else len(kv_index(c, T, 0)))
        Sx = S + prefix_len(c)
        for dt in (bf16, f32):
            if c.family == "encdec":
                E = frames // 2
                cases += [
                    ("tp_whisper_encoder", B, E, E, Hl, Gl, c.hdim, False,
                     0, ar(E), ar(E), dt, None),
                    ("tp_whisper_cross", B, S, E, Hl, Gl, c.hdim, False, 0,
                     zeros(S), zeros(E), dt, None)]
            cases.append((f"tp_{arch.split('-')[0]}", B, Sx, Sx, Hl, Gl,
                          c.hdim, True, c.sliding_window, ar(Sx), ar(Sx),
                          dt, None))
    # the simt kernel (the first design) at the bf16 serving shapes, as
    # phase 6 times it
    cases += [c[:-1] + ("simt",) for c in cases
              if c[0] in ("prefill", "decode", "hymba_prefill",
                          "hymba_decode", "stablelm_prefill",
                          "stablelm_decode") and c[11] == bf16]
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
    ] + [
        # the tp phase's rank shapes (TP_FAMILIES): rwkv6-7b's 64 / 4
        # heads a rank; hymba-1.5b's 25 SSM heads on every rank
        (name, B, S, H, K, 64, u, False, None, dt)
        for name, (B, S), H, K, u in (
            ("tp_rwkv6", TP_FAMILIES["rwkv6-7b"][1], 64 // TP_RANKS, 64,
             True),
            ("tp_hymba", TP_FAMILIES["hymba-1.5b"][1], 25, 16, False))
        for dt in (bf16, f32)]


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


def rank_decode_checks(arch, gen):
    """The two-step decode at one tp rank's heads of ``arch`` (its heads
    and kv heads over TP_RANKS: stablelm-12b's H 8, G 2, D 160), as
    TP_RANKS ranks of TP_SLOTS / TP_RANKS slots each: every rank's
    flash_decode_partials at n_split 1, the chosen one and 3 against
    flash_decode_partials_ref (f32 partials, TOL's f32 entry), then
    flash_decode_merge of the kernel's partials against its plain version
    (TOL of the type) and against flash_attention_ref over the whole
    cache. Returns {tag: max abs error}."""
    cfg = get_config(arch)
    N, C = TP_SERVE[0], TP_SLOTS // TP_RANKS
    H, G, D = (cfg.n_heads // TP_RANKS, cfg.n_kv_heads // TP_RANKS,
               cfg.hdim)
    name = f"tp_rank_{arch.split('-')[0]}"
    qpos = ar(1, TP_SLOTS - 1)
    errs = {}

    def held(tag, out, ref, dt, **kw):
        atol, rtol = TOL[dt]
        err, ok = within(out, ref, atol, rtol)
        emit(phase="kernel", kernel="flash_attention", case=tag,
             max_abs_err=err, atol=atol, rtol=rtol, **kw)
        check(ok and bool(torch.isfinite(out).all()),
              f"flash_attention disagrees with its plain version: {tag}")
        errs[f"flash_attention:{tag}"] = err

    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        q = rand((N, 1, H, D), dt, gen)
        k, v = (rand((N, TP_SLOTS, G, D), dt, gen) for _ in range(2))
        parts = []
        for r in range(TP_RANKS):
            kr, vr = (t[:, r * C:(r + 1) * C].contiguous() for t in (k, v))
            kw = dict(qpos=qpos, kpos=ar(C, r * C))
            ref = fa.flash_decode_partials_ref(q, kr, vr, **kw)
            for n_split in (1, None, 3):
                out = fa.flash_decode_partials(q, kr, vr, n_split=n_split,
                                               **kw)
                torch.cuda.synchronize()
                held(f"{name}_partials/{dname}/r{r}_{n_split}", out, ref,
                     torch.float32, step="partials", n_split=n_split,
                     shape=[N, 1, C, H, G, D])
            parts.append(out)
        part = torch.stack(parts)
        out = fa.flash_decode_merge(part, dt)
        torch.cuda.synchronize()
        held(f"{name}_merge/{dname}/merge", out,
             fa.flash_decode_merge_ref(part, dt), dt, step="merge",
             shape=list(part.shape))
        held(f"{name}_merged/{dname}/whole_cache", out.reshape(q.shape),
             fa.flash_attention_ref(q, k, v, qpos=qpos, kpos=ar(TP_SLOTS)),
             dt, step="merge", shape=[N, 1, TP_SLOTS, H, G, D])
    return errs


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
            if name.startswith("split_all_masked"):
                check(bool((out == 0).all()), f"masked row not zero: {tag}")
            errs[f"flash_attention:{tag}"] = err
            del out
        del q, k, v, ref
    errs.update(rank_decode_checks("stablelm-12b", gen))
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
    # head dim 160 (simt at prefill, split at decode) and layernorm
    ("stablelm-12b", "float32", 2, 128, dict(attn_impl="flash"),
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


#: the flash shapes of phase 6 that are training shapes: no serving
#: launches (so the kernels line's totals leave them out), and their
#: backward timed too
FLASH_TRAIN = ("qwen3_train", "stablelm_train", "granite_train")


def flash_backward_times(qkv, sdpa_kw, kw, nbytes, flops):
    """At a training shape, eager calls timed by CUDA events, in turns,
    twice: the port's attention as a training step runs it (the kernel's
    forward with its log-sum-exp, then the backward kernels,
    ``FlashAttentionFn``) and that backward alone, the backward the port
    ran before (autograd of the plain attention, ``attention_plain``)
    alone, beside SDPA's forward plus backward and its backward alone; the
    bound of forward plus backward: the forward's bytes and those of a
    backward that reads q, k, v, o and do and writes dq, dk and dv, and
    14 D flops a (q, k) pair (the forward's 4, and 10 for the recompute of
    q k^T and the four products of the backward)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in qkv]
    do = torch.randn_like(qkv[0])
    lib = [t.detach().transpose(1, 2).contiguous().requires_grad_(True)
           for t in qkv]
    lib_do = do.transpose(1, 2).contiguous()

    def port():
        return kops.flash_attention(*leaves, self_attention=True, **kw)

    def sdpa():
        return F.scaled_dot_product_attention(*lib, enable_gqa=True,
                                              **sdpa_kw)

    o, lib_o = port(), sdpa()
    plain_o = cm.attention_plain(*leaves, self_attention=True, **kw)
    fns = {
        "fwd_bwd": lambda: torch.autograd.grad(port(), leaves, do),
        "backward": lambda: torch.autograd.grad(
            o, leaves, do, retain_graph=True),
        "plain_backward": lambda: torch.autograd.grad(
            plain_o, leaves, do, retain_graph=True),
        "library_fwd_bwd": lambda: torch.autograd.grad(sdpa(), lib, lib_do),
        "library_backward": lambda: torch.autograd.grad(
            lib_o, lib, lib_do, retain_graph=True)}
    runs = [{name: time_ms(fn, 10)[0] for name, fn in fns.items()}
            for _ in range(2)]
    B, Sq, H, D = qkv[0].shape
    Sk, G = qkv[1].shape[1], qkv[1].shape[2]
    b_ms, b_by = least_ms(
        nbytes + 2 * (4 * B * Sq * H * D + 4 * B * Sk * G * D),
        flops // 4 * 14)
    times = {f"{name}_ms": min(r[name] for r in runs) for name in fns}
    times.update({f"{name}_ms_runs": [r[name] for r in runs]
                  for name in fns})
    return dict(times, fwd_bwd_bound_ms=b_ms, fwd_bwd_bound_by=b_by)


def phase_times():
    gen = torch.Generator(device=DEV).manual_seed(4)
    dt = torch.bfloat16
    per = {}
    # flash_attention: name -> (arch, Sq, Sk, window, causal, qpos, kpos,
    # calls per serving run, buffers, iters)
    qcfg, hcfg = get_config("qwen3-4b"), get_config("hymba-1.5b")
    wcfg, vcfg = get_config("whisper-medium"), get_config("internvl2-26b")
    scfg, gcfg = get_config("stablelm-12b"), get_config("granite-3-2b")
    _, TS = TRAIN["qwen3-4b"][1:3]
    _, SS = TRAIN["stablelm-12b"][1:3]
    _, GS = TRAIN["granite-3-2b"][1:3]
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
        # qwen3-4b's training shape (B 4 x 1024), no serving launches; its
        # backward timed below (FLASH_TRAIN)
        "qwen3_train": (qcfg, TS, TS, 0, True, ar(TS), ar(TS), 0, 2, 30),
        # stablelm-12b at head dim 160: its serving prefill and decode, and
        # its training shape (B 4 x 1024)
        "stablelm_prefill": (scfg, P, P, 0, True, ar(P), ar(P),
                             scfg.n_layers, 2, 50),
        "stablelm_decode": (scfg, 1, C, 0, True, ar(1, last),
                            torch.where(ar(C) <= last, ar(C), -1)
                            .to(torch.int32), scfg.n_layers * (GEN - 1), 8,
                            400),
        "stablelm_train": (scfg, SS, SS, 0, True, ar(SS), ar(SS), 0, 2, 30),
        # granite-3-2b's training shape (B 4 x 1024, H 32, G 8, D 64), the
        # benchmark's training cell
        "granite_train": (gcfg, GS, GS, 0, True, ar(GS), ar(GS), 0, 2, 30),
    }
    for name, (cfg, Sq, Sk, window, causal, qpos, kpos, n_calls, nbuf,
               iters) in flash.items():
        N = (TRAIN[cfg.name][1] if name in FLASH_TRAIN
             else SERVE[cfg.name][0])
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
        train = (flash_backward_times(bufs[0], sdpa_kw, kw, nbytes, flops)
                 if name in FLASH_TRAIN else {})
        per[("flash_attention", name)] = dict(
            shape=[N, Sq, Sk, H, G, D], window=window, causal=causal,
            dtype="bfloat16",
            variant=variant,
            n_split=(fa.decode_splits(N, G, Sk, n_sm())
                     if variant == "split" else None),
            **times, plain_ms=plain_ms, bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=b_by, bytes=nbytes,
            flops=flops, launches_per_serving_run=n_calls, **train)
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
# gradients through the kernels' autograd Functions against autograd of the
# plain functions, as ||g_fn - g_plain|| / ||g_plain|| for each input: the
# f32 rows through the kernel forward and the plain version's backward, the
# bf16 flash rows through the tc forward and the backward kernels
# (attn_bwd_dq, attn_bwd_dkv), the bf16 GLA rows through the tc forward and
# the plain backward. The upstream gradient is out - target, so each side's
# own forward output enters its gradient: f32 differs only by summation
# order; bf16 by the kernels' f32 accumulation and bf16 P and dS against
# the plain versions' bf16 accumulation (attention) and the tc kernel's
# bf16 operands (GLA), as in the bf16 wiring lines
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
    _, SB, SS = TRAIN["stablelm-12b"][:3]
    _, GB, GS = TRAIN["granite-3-2b"][:3]
    _, RB, RT = TRAIN["rwkv6-7b"][:3]
    _, WB, WS = TRAIN["whisper-medium"][:3]
    WE = TRAIN_FRAMES["whisper-medium"] // 2
    flash = [("qwen3_prefill", 8, P, 32, 8, 128, 0, bf16),
             ("qwen3_train", QB, QS, 32, 8, 128, 0, bf16),
             ("qwen3_prefill", 2, P, 32, 8, 128, 0, f32),
             # the benchmark's training cell: granite-3-2b (D 64)
             ("granite_train", GB, GS, 32, 8, 64, 0, bf16),
             # head dim 160: stablelm-12b's training shape, and f32
             ("stablelm_train", SB, SS, 32, 8, 160, 0, bf16),
             ("stablelm_prefill", 2, P, 32, 8, 160, 0, f32),
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
    # (arch, B, S): hymba at S = 2 x window, so its backward is banded;
    # internvl2-26b's 256 patch tokens come ahead of its 512
    ("qwen3-4b", 2, 512),
    ("hymba-1.5b", 2, 2048),
    ("internvl2-26b", 2, 512),
    ("dbrx-132b", 2, 512),
]
# 2 layers unless cut here: two f32 copies of one full dbrx-132b layer
# (13 GB of params each, and as much again of grads and twice that of
# moments) do not fit, so 1 layer with 4 of its 16 experts, top-4
TRAIN_WIRING_CUT = {"dbrx-132b": dict(n_layers=1, n_experts=4)}
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
        cut = dict(dict(n_layers=2), **TRAIN_WIRING_CUT.get(arch, {}))
        cfg = get_config(arch).scaled(dtype="float32", **cut)
        toks = torch.randint(0, cfg.vocab, (B, S), device=DEV,
                             generator=torch.Generator(device=DEV)
                             .manual_seed(6))
        batch = with_side(cfg, {"tokens": toks}, 6)
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
             reduced=reduced(arch, cfg), d_model=cfg.d_model,
             dtype=cfg.dtype, batch=B, seq_len=S,
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
    # profiled step). hymba-1.5b took ~9.7 s a step at its full 32
    # layers (its plain GLA backward loops over 64 chunks a layer from the
    # host, ~400 k small ops a step), 75 s of the run's time budget, so it
    # trains at 16 of them; its step is profiled at 4 layers: the
    # profiler's Python side took 211 s over the 32
    "qwen3-4b": (None, 4, 1024, 5, 3, None),
    "hymba-1.5b": (16, 4, 2048, 5, 3, 4),
    "rwkv6-7b": (8, 4, 1024, 5, 3, None),
    # full depth (24 + 24 layers), 30 s of audio a sequence and its whole
    # 448-token text context
    "whisper-medium": (None, 8, 448, 5, 3, None),
    # the moe and vlm families at full width, 12 B a param (bf16 params
    # and grads, f32 moments): one dbrx-132b layer (3.26 B params, all 16
    # experts, top-4) is 39 GB beside 14.8 GB of untied embeddings (peak
    # 56.7 GB on an H100, PERF.md); one arctic-480b layer (13.6 B) would
    # be 163 GB, so its expert count is cut to 32 of 128 (each expert's
    # shape, top-2 and the dense residual FFN unchanged), ~48 GB (peak
    # 53.2); internvl2-26b's layers are 0.39 B, 4.7 GB each, beside 13.7
    # GB: 8 layers peaked at 58.7 GB, so 10 (~68 GB) leave 12 GB free
    "dbrx-132b": (1, 4, 1024, 5, 3, None),
    "arctic-480b": (1, 4, 1024, 5, 3, None),
    "internvl2-26b": (10, 4, 1024, 5, 3, None),
    # the dense configs at full width, 12 B a param: a stablelm-12b layer
    # is 0.278 B params (3.3 GB) beside 1.03 B of untied embeddings (12.3
    # GB), so 12 of its 40 layers (~52 GB of state); a qwen2.5-14b layer
    # 0.275 B beside 1.56 B (18.7 GB), so 10 of 48 (~52 GB); granite-3-2b
    # (2.53 B, ~30 GB) at full depth
    "stablelm-12b": (12, 4, 1024, 5, 3, None),
    "qwen2.5-14b": (10, 4, 1024, 5, 3, None),
    "granite-3-2b": (None, 4, 1024, 5, 3, None),
}
# cuts beyond the depth
TRAIN_CUT = {"arctic-480b": dict(n_experts=32)}
TRAIN_FRAMES = {"whisper-medium": 3000}
TRAIN_OPT = OptConfig(lr=1e-3, warmup_steps=0, total_steps=1000)
#: AdamW's rate where TRAIN_OPT's is too large for the width: at 1e-3
#: with no warm-up the 5120-wide dense models' loss on the repeated batch
#: jumps (NVIDIA H100 80GB HBM3, scripts/train_lr_probe.py: qwen2.5-14b
#: 12.67 -> 9.25 -> 12.70 through the kernel, 13.40 -> 9.47 -> 11.02
#: through the plain attention, so the rate's and not the kernel's); at
#: 1e-4 it falls at every step (qwen2.5-14b 10.37 -> 10.07 -> 8.03,
#: stablelm-12b 10.19 -> 9.67 -> 7.99; PERF.md section 6)
TRAIN_LR = {"stablelm-12b": 1e-4, "qwen2.5-14b": 1e-4}
# the 4-layer qwen3-4b runs: n_micro 2 against 1 on one batch (loss and
# grad norm: bf16 matmuls on half the rows, f32 accumulation against the
# bf16 gradient), compression, and a checkpoint round trip
MICRO_LOSS_RTOL, MICRO_GNORM_RTOL = 5e-3, 2e-2
CKPT_DIR = Path(__file__).resolve().parent / "build" / "smoke_ckpt"


def reset_counts():
    fa.flash_attention_backward.launches = 0
    fa.flash_attention_backward.plain_calls = 0
    for fn in (fa.flash_attention, gs.gla_scan):
        fn.launches = 0
        for name in fn.launches_by_variant:
            fn.launches_by_variant[name] = 0
    for name in fa.flash_attention.launches_by_step:
        fa.flash_attention.launches_by_step[name] = 0
    fa.flash_attention.launches_by_shape.clear()


def timed_step(step, state, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, met = step(state, batch)
    torch.cuda.synchronize()
    return state, met, time.perf_counter() - t0


def profile_step(step, state, batch):
    """One train step under torch.profiler: device ms of every kernel, of
    the kernels' forward launches and of the Functions' backward spans
    (the attention backward kernels, the plain recompute of the others)."""
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
            # the device-side mirrors of the program's ranges
            # (repro_torch.spans) span kernels and are none themselves
            if e.name.startswith(("repro_torch::", "Command Buffer")):
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


def reduced(arch, cfg):
    """The cuts of ``cfg`` against the arch's published config, as
    "field kept of full"."""
    full = get_config(arch)
    return [f"{f} {getattr(cfg, f)} of {getattr(full, f)}"
            for f in ("n_layers", "encoder_layers", "n_experts")
            if getattr(cfg, f) != getattr(full, f)]


def run_train(arch):
    layers, B, S, pipe_steps, repeat_steps, prof_layers = TRAIN[arch]
    cfg = get_config(arch)
    cfg = cfg.scaled(n_layers=layers) if layers else cfg
    cfg = cfg.scaled(**TRAIN_CUT.get(arch, {}))
    gla = cfg.family in ("ssm", "hybrid")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=DEV)
    tcfg = TrainConfig(opt=dataclasses.replace(
        TRAIN_OPT, lr=TRAIN_LR.get(arch, TRAIN_OPT.lr)))
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
    backward = {"launches": fa.flash_attention_backward.launches,
                "plain_calls": fa.flash_attention_backward.plain_calls}
    peak = torch.cuda.max_memory_allocated() / 1e9
    # each attention call's kernel runs twice a step: the forward and the
    # remat recompute in the backward; its backward once, on the kernels
    want = {"flash_attention": 2 * attn_calls(cfg)[0] * n_steps,
            "gla_scan": 2 * cfg.n_layers * n_steps if gla else 0}
    want_backward = {"launches": attn_calls(cfg)[0] * n_steps,
                     "plain_calls": 0}
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
         full_depth=layers is None, reduced=reduced(arch, cfg),
         n_experts=cfg.n_experts or None, d_model=cfg.d_model,
         dtype=cfg.dtype,
         params=n_params, batch=B, seq_len=S,
         frames=TRAIN_FRAMES.get(arch), n_micro=1, lr=tcfg.opt.lr,
         steps=n_steps,
         pipeline_steps=pipe_steps, repeated_steps=repeat_steps,
         s_per_step=secs, median_s_per_step=med,
         tokens_per_s=B * S / med, peak_mem_gb=peak, losses=losses,
         grad_norms=gnorms, launches=got, expected_launches=want,
         launches_by_variant=variants, flash_backward=backward,
         expected_flash_backward=want_backward,
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
    check(backward == want_backward, f"{arch}: flash backward {backward}, "
                                     f"expected {want_backward}")
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


def moe_grad_bits():
    """dbrx-132b at one layer (all 16 experts, top-4), bf16: the loss's
    backward twice on one batch from the same params, every gradient
    leaf compared bit for bit. The dispatch gathers each token k times,
    so autograd's backward of that gather adds k rows a token."""
    arch = "dbrx-132b"
    B, S = TRAIN[arch][1:3]
    cfg = get_config(arch).scaled(n_layers=1)
    model = build_model(cfg, device=DEV)
    model.init_params(torch.Generator(device=DEV).manual_seed(12))
    toks = torch.randint(0, cfg.vocab, (B, S), device=DEV,
                         generator=torch.Generator(device=DEV)
                         .manual_seed(13))
    grads, losses, secs = [], [], []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.loss({"tokens": toks})
        loss.backward()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.detach())
        grads.append({n: p.grad for n, p in model.named_parameters()})
    differ = {n: (g - grads[1][n]).abs().max().item()
              for n, g in grads[0].items() if not bit_equal(g, grads[1][n])}
    emit(phase="train", check="moe_grad_bits", arch=arch,
         n_layers=cfg.n_layers, n_experts=cfg.n_experts, topk=cfg.moe_topk,
         batch=B, seq_len=S, dtype=cfg.dtype, reduced=reduced(arch, cfg),
         leaves=len(grads[0]), loss_bit_equal=bit_equal(*losses),
         leaves_differing=sorted(differ), max_abs_diff=differ,
         seconds=secs)
    check(bit_equal(*losses) and not differ,
          f"{arch}: two backwards of one batch differ in {sorted(differ)}")
    del model, grads, losses
    torch.cuda.empty_cache()


def phase_train():
    """The training runs with every launch count set to 0 just before each
    and read just after; returns ({arch: launches}, {arch: profile})."""
    launches, profiles = {}, {}
    for arch in TRAIN:
        launches[arch], profiles[arch] = run_train(arch)
    run_train_small()
    moe_grad_bits()
    return launches, profiles


# -------------------------------------------------------------- moe_ep --
MOE_EP_ARCH = "dbrx-132b"
MOE_EP_RANKS = 4
MOE_EP_SHAPE = (4, 1024)
#: no (token, choice) pair can drop: a rank's 1024 tokens, a local
#: capacity of 1024 each expert (each token picks an expert once)
MOE_EP_NODROP_CF = 4.0
#: the config's capacity factor, in f32, on 4 x 256 tokens (64 a rank:
#: local capacity 24), card against CPU; every token shares one offset of
#: this scale, so the router favours some experts and pairs drop
MOE_EP_F32_SHAPE = (4, 256)
MOE_EP_SKEW = 1.5
#: bf16 EP against bf16 dense (the same per-expert products, the expert
#: rows in another order); f32 card against f32 CPU
MOE_EP_TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-4, 1e-3)}
#: JAX's dense fallback at 'model' 1 on a batch split over data ranks:
#: MOE_EP_SHAPE as this many virtual data ranks, each 1024 tokens, at the
#: config's capacity factor and MOE_EP_SKEW's routing (global capacity
#: 1280 an expert for 16384 pairs; a rank alone would have 384 for 4096)
MOE_FALLBACK_RANKS = 4
MOE_FALLBACK_CALLS = 3


def moe_experts(cfg, dtype, seed):
    """dbrx's router and experts at full width, from a seed, on the card."""
    e = Experts(dataclasses.replace(cfg, dtype=str(dtype).split(".")[1]),
                torch.device(DEV))
    gen = torch.Generator(device=DEV).manual_seed(seed)
    with torch.no_grad():
        for name, init in e.inits.items():
            cm.init_param(getattr(e, name), init, gen)
    return e.requires_grad_(False)


def phase_moe_ep():
    cfg = get_config(MOE_EP_ARCH)
    M = MOE_EP_RANKS
    e = moe_experts(cfg, torch.bfloat16, 31)
    x = torch.randn(*MOE_EP_SHAPE, cfg.d_model, device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(32)
                    ).to(torch.bfloat16)
    nd = cfg.scaled(capacity_factor=MOE_EP_NODROP_CF)
    secs = {"ep": [], "dense": []}

    def run(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = (moe_ffn_ep_virtual(nd, e, x, M) if name == "ep"
               else moe_ffn(nd, e, x))
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
        return got

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        out, aux, dropped = run("ep")   # the first call: cuBLAS warm-up
        peak = torch.cuda.max_memory_allocated() / 1e9
        for name in ("dense", "ep", "ep", "dense"):
            got = run(name)
        dense, dense_aux = got
    atol, rtol = MOE_EP_TOL[torch.bfloat16]
    err, ok = within(out, dense, atol, rtol)
    emit(phase="moe_ep", check="nodrop", arch=MOE_EP_ARCH, ranks=M,
         d_model=cfg.d_model, n_experts=cfg.n_experts, topk=cfg.moe_topk,
         d_ff=cfg.d_ff, batch=MOE_EP_SHAPE[0], seq_len=MOE_EP_SHAPE[1],
         dtype="bfloat16", capacity_factor=MOE_EP_NODROP_CF,
         expert_gb=sum(t.numel() * t.element_size()
                       for t in (e.wi, e.wo)) / 1e9,
         dropped=dropped, max_abs_err=err, atol=atol, rtol=rtol,
         within=ok, aux=float(aux), dense_aux=float(dense_aux),
         seconds=secs["ep"], dense_seconds=secs["dense"], peak_mem_gb=peak,
         reduced=[])
    check(ok and dropped == 0, f"moe_ep: EP differs from the dense dispatch "
                               f"by {err} (dropped {dropped})")
    del e, x, out, dense
    torch.cuda.empty_cache()
    # the config's capacity factor, f32: the card against the CPU
    e = moe_experts(cfg, torch.float32, 33)
    gen = torch.Generator(device=DEV).manual_seed(34)
    x = (torch.randn(*MOE_EP_F32_SHAPE, cfg.d_model, device=DEV,
                     generator=gen)
         + MOE_EP_SKEW * torch.randn(cfg.d_model, device=DEV, generator=gen))
    with torch.no_grad():
        out, aux, dropped = moe_ffn_ep_virtual(cfg, e, x, M)
        e_cpu = Experts(cfg.scaled(dtype="float32"), torch.device("cpu"))
        for name in e.inits:
            getattr(e_cpu, name).data = getattr(e, name).cpu()
        del e
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref, ref_aux, ref_dropped = moe_ffn_ep_virtual(cfg, e_cpu, x.cpu(),
                                                       M)
        cpu_s = time.perf_counter() - t0
    atol, rtol = MOE_EP_TOL[torch.float32]
    err, ok = within(out.cpu(), ref, atol, rtol)
    pairs = MOE_EP_F32_SHAPE[0] * MOE_EP_F32_SHAPE[1] * cfg.moe_topk
    emit(phase="moe_ep", check="card_vs_cpu", arch=MOE_EP_ARCH, ranks=M,
         batch=MOE_EP_F32_SHAPE[0], seq_len=MOE_EP_F32_SHAPE[1],
         dtype="float32", capacity_factor=cfg.capacity_factor,
         skew=MOE_EP_SKEW, pairs=pairs, dropped=dropped,
         cpu_dropped=ref_dropped,
         max_abs_err=err, atol=atol, rtol=rtol, within=ok,
         aux=float(aux), cpu_aux=float(ref_aux), cpu_seconds=cpu_s,
         reduced=["tokens 4 x 256 (f32 on the CPU)"])
    check(ok and dropped == ref_dropped > 0,
          f"moe_ep at capacity {cfg.capacity_factor}: card and CPU differ "
          f"by {err}, drops {dropped} vs {ref_dropped}")
    del e_cpu, x, out, ref
    gc.collect()
    torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        moe_data_fallback(cfg, dtype)


def moe_data_fallback(cfg, dtype):
    """The dense fallback at 'model' 1 (``moe_ffn_fallback_virtual``):
    MOE_FALLBACK_RANKS data ranks, each dispatching its rows after the
    exchange of per-expert counts, against the one-device ``moe_ffn`` of
    the whole batch (JAX's dispatch of the global batch): the same kept
    pairs exactly, the output within MOE_EP_TOL; the control, each rank
    dispatching its rows alone, must drop another count."""
    D = MOE_FALLBACK_RANKS
    e = moe_experts(cfg, dtype, 35)
    gen = torch.Generator(device=DEV).manual_seed(36)
    x = (torch.randn(*MOE_EP_SHAPE, cfg.d_model, device=DEV, generator=gen)
         + MOE_EP_SKEW * torch.randn(cfg.d_model, device=DEV, generator=gen)
         ).to(dtype)
    T, k = MOE_EP_SHAPE[0] * MOE_EP_SHAPE[1], cfg.moe_topk
    secs = {"fallback": [], "dense": []}

    def run(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = (moe_ffn_fallback_virtual(cfg, e, x, D) if name == "fallback"
               else moe_ffn(cfg, e, x))
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
        return got

    def kept_of(xt):  # the pairs moe_ffn keeps of the tokens xt alone
        _, topi, _ = moe_mod.route(cfg, e.router, xt)
        order, _, keep = moe_mod.dispatch(
            cfg, topi, moe_mod.capacity(cfg, xt.shape[0]))
        return moe_mod.kept_pairs(order, keep, k)

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        out, aux, kept = run("fallback")
        peak = torch.cuda.max_memory_allocated() / 1e9
        for name in ("dense", *("fallback",) * (MOE_FALLBACK_CALLS - 1),
                     "dense"):
            got = run(name)
        dense, dense_aux = got
        want = kept_of(x.reshape(T, -1))
        local = torch.cat([kept_of(xr.reshape(-1, cfg.d_model))
                           for xr in x.chunk(D)])
    atol, rtol = MOE_EP_TOL[dtype]
    err, ok = within(out, dense, atol, rtol)
    kept_equal = bool(torch.equal(kept, want))
    dropped, want_dropped = int((~kept).sum()), int((~want).sum())
    local_dropped = int((~local).sum())
    emit(phase="moe_ep", check="data_fallback", arch=MOE_EP_ARCH,
         data_ranks=D, model_ranks=1, batch=MOE_EP_SHAPE[0],
         seq_len=MOE_EP_SHAPE[1], dtype=str(dtype).split(".")[1],
         capacity_factor=cfg.capacity_factor,
         capacity=moe_mod.capacity(cfg, T),
         rank_capacity=moe_mod.capacity(cfg, T // D), skew=MOE_EP_SKEW,
         pairs=T * k, dropped=dropped, one_device_dropped=want_dropped,
         kept_equal=kept_equal, control_dropped=local_dropped,
         control_differs=local_dropped != want_dropped,
         max_abs_err=err, atol=atol, rtol=rtol, within=ok, aux=float(aux),
         one_device_aux=float(dense_aux), seconds=secs["fallback"],
         one_device_seconds=secs["dense"], peak_mem_gb=peak,
         reduced=["B 4 x 1024 tokens as 4 data ranks in one process"])
    check(ok and kept_equal and dropped > 0,
          f"moe_ep data_fallback ({dtype}): kept pairs equal {kept_equal}, "
          f"dropped {dropped} vs {want_dropped}, error {err}")
    check(local_dropped != want_dropped,
          f"moe_ep data_fallback ({dtype}): the rank-local control drops "
          f"{local_dropped} pairs, as many as the global dispatch")
    del e, x, out, dense
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------- train_sharded --
SHARDED_ARCH = "qwen3-4b"
SHARDED_CUT = dict(n_layers=4)
SHARDED_SHAPE = (4, 1024)
SHARDED_STEPS = 3
SHARDED_TCFG = TrainConfig(n_micro=2, opt=TRAIN_OPT)
#: test_torch_train.py::test_three_train_steps_match_jax's tolerance on
#: the parameters' change, where the bits differ
SHARDED_RTOL = 1e-2
#: the gradient norms, where the bits differ: the same gradients summed
#: in another order (AdamW ignores the gradient's scale, so the norm is
#: what shows a wrong scale in the reduction)
SHARDED_NORM_RTOL = 1e-4


def sharded_steps(cfg, p0, toks, mesh):
    """Three steps from p0: unsharded (mesh None) or sharded on mesh.
    Returns (params by name, losses, gradient norms, step seconds, flash
    launches)."""
    model = build_model(cfg, device=DEV)
    model.load_state_dict(p0)
    if mesh is None:
        state = adamw_init(dict(model.named_parameters()))
        params = dict(model.named_parameters())
        step = make_train_step(model, SHARDED_TCFG)
    else:
        sharded = ShardedTraining(model, mesh, DEFAULT_RULES)
        state = sharded.init_opt_state(SHARDED_TCFG.opt.state_dtype)
        params = sharded.params
        step = sharded.make_step(SHARDED_TCFG)
    reset_counts()
    losses, norms, secs = [], [], []
    for _ in range(SHARDED_STEPS):
        state, met, dt = timed_step(step, state, {"tokens": toks})
        losses.append(met["loss"].float().cpu())
        norms.append(met["grad_norm"].float().cpu())
        secs.append(dt)
    launches = fa.flash_attention.launches
    out = {n: p.detach().clone() for n, p in params.items()}
    del model, state, step, params
    torch.cuda.empty_cache()
    return out, losses, norms, secs, launches


def phase_train_sharded():
    """World size 1 on NCCL; the process group is destroyed however the
    phase ends. Returns the sharded run's flash launches."""
    rendezvous = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}/rv",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_config(SHARDED_ARCH).scaled(**SHARDED_CUT)
        model = build_model(cfg, device=DEV)
        model.init_params(torch.Generator(device=DEV).manual_seed(41))
        p0 = {n: t.detach().clone() for n, t in model.state_dict().items()}
        del model
        toks = torch.randint(0, cfg.vocab, SHARDED_SHAPE, device=DEV,
                             generator=torch.Generator(device=DEV)
                             .manual_seed(42))
        torch.cuda.reset_peak_memory_stats()
        want, want_l, want_g, want_s, want_n = sharded_steps(cfg, p0, toks,
                                                             None)
        got, got_l, got_g, got_s, got_n = sharded_steps(cfg, p0, toks, mesh)
        peak = torch.cuda.max_memory_allocated() / 1e9
        differ = {n: (got[n].float() - want[n].float()).abs().max().item()
                  for n in want if not bit_equal(got[n], want[n])}
        num = sum(float(torch.sum(torch.square(got[n].float()
                                               - want[n].float())))
                  for n in want)
        den = sum(float(torch.sum(torch.square(want[n].float()
                                               - p0[n].float())))
                  for n in want)
        rel = math.sqrt(num / den)
        losses_equal = all(bit_equal(a, b) for a, b in zip(got_l, want_l))
        norms_equal = all(bit_equal(a, b) for a, b in zip(got_g, want_g))
        emit(phase="train_sharded", arch=SHARDED_ARCH, n_layers=cfg.n_layers,
             batch=SHARDED_SHAPE[0], seq_len=SHARDED_SHAPE[1],
             n_micro=SHARDED_TCFG.n_micro, steps=SHARDED_STEPS,
             dtype=cfg.dtype, backend=dist.get_backend(),
             world_size=dist.get_world_size(), mesh=dict(data=1, model=1),
             leaves=len(want), bit_equal=not differ,
             losses_bit_equal=losses_equal,
             losses=[float(v) for v in got_l],
             grad_norms_bit_equal=norms_equal,
             grad_norms=[float(v) for v in got_g],
             unsharded_grad_norms=[float(v) for v in want_g],
             leaves_differing=sorted(differ), max_abs_diff=differ,
             param_rel_err=rel, param_rtol=SHARDED_RTOL,
             step_seconds=got_s, unsharded_step_seconds=want_s,
             launches=got_n, unsharded_launches=want_n, peak_mem_gb=peak,
             reduced=reduced(SHARDED_ARCH, cfg))
        check(got_n > 0 and got_n == want_n,
              f"train_sharded: flash launches {got_n} vs {want_n}")
        check(rel <= SHARDED_RTOL and all(
            torch.allclose(a, b, rtol=1e-3) for a, b in zip(got_l, want_l))
            and all(torch.allclose(a, b, rtol=SHARDED_NORM_RTOL)
                    for a, b in zip(got_g, want_g)),
              f"train_sharded: the sharded step left the unsharded one by "
              f"{rel} (leaves {sorted(differ)})")
        return got_n
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ tp --
#: tensor parallelism over 'model' (sharding/tp.py) as TP_RANKS virtual
#: ranks in this process (tp.place_virtual: each rank's pieces are views
#: of the whole leaves, a sum over the ranks the sum of their parts in
#: rank order): qwen3-4b at SHARDED_CUT, a rank's 32 / 4 = 8 heads and
#: 8 / 4 = 2 kv heads through the flash kernel (attn_fwd_tc in bf16)
TP_RANKS = 4
TP_SHAPE = (4, 1024)
#: serving: (requests, prompt length, decode steps), teacher-forced with
#: the unsharded run's greedy tokens; the cache's TP_SLOTS slots split
#: 136 a rank, not a multiple of the kernels' 64-key tile
TP_SERVE = (8, 512, 32)
TP_SLOTS = 544
#: each run in both types. In f32 (TF32 off) the ranks' sums differ from
#: the unsharded model's by f32 order alone, and the run is held to the
#: f32 full-model tolerances: the logits within WIRING_ATOL, the
#: training's parameters and gradient norms within SHARDED_RTOL and
#: SHARDED_NORM_RTOL. In bf16 each rank's part of a row-parallel product
#: (and of a column-parallel input's gradient) rounds to bf16 before the
#: ranks' sum, where the whole product rounds once, and those tolerances,
#: and TOL's elementwise one on the logits, sit below what that gives: the
#: unsharded bf16 steps at n_micro 1 against n_micro 2 (one gradient sum
#: in another f32 order) already leave SHARDED_RTOL (the train line's
#: control_* readings: AdamW's first update is lr * sign(g), and the
#: elements whose gradient is near 0 flip). The bf16 run is held as the
#: repo's bf16 model checks are: the logits within WIRING_BF16_RTOL as
#: ||tp - ref|| / ||ref|| over the vocab's columns, the first step's
#: loss within TP_BF16_LOSS_RTOL and its gradients within GRAD_RTOL; its
#: 3 steps' parameter change and gradient norms within TP_BF16_PARAM_RTOL
#: and TP_BF16_NORM_RTOL. Beside it, from the same weights, the train line
#: reads the control, the ranks' sums taken in f32 (SumF32TP) and a
#: planted fault (DroppedWoTP), which the gate must reject. Greedy tokens
#: must be equal in both wherever the unsharded top-2 margin exceeds TOL
TP_DTYPES = ("float32", "bfloat16")
#: the bf16 first step's loss: train_sharded's loss tolerance
TP_BF16_LOSS_RTOL = 1e-3
#: the bf16 run's 3 steps: the parameters' change (||tp - ref|| over the
#: unsharded change) and the gradient norms, each bound between the
#: sound run's reading and the planted fault's (NVIDIA H100 80GB HBM3:
#: 0.066 and 4.9e-3 sound, 0.063 and 5.7e-3 with the sums in f32, 1.13
#: and 0.90 with the fault; the control 0.013 and 1.6e-4)
TP_BF16_PARAM_RTOL = 0.2
TP_BF16_NORM_RTOL = 0.05


def flash_counts():
    """(launches, by variant or step, by shape) of the flash wrappers
    since the last reset_counts."""
    fn = fa.flash_attention
    return (fn.launches, {k: v for k, v in (*fn.launches_by_variant.items(),
                                            *fn.launches_by_step.items())
                          if v},
            {"/".join(map(str, k)): v
             for k, v in sorted(fn.launches_by_shape.items())})


class _CopyF32(torch.autograd.Function):
    """x as M rank inputs, the ranks' gradients summed in f32 in rank
    order and rounded once."""

    @staticmethod
    def forward(ctx, x, M):
        return tuple(x.clone() for _ in range(M))

    @staticmethod
    def backward(ctx, *grads):
        got = [g for g in grads if g is not None]
        out = got[0].float()
        for g in got[1:]:
            out = out + g.float()
        return out.to(got[0].dtype), None


class SumF32TP(tpm.VirtualTP):
    """The bf16 run's diagnostic: the virtual ranks with every sum over
    the ranks (the row-parallel outputs forward, the column-parallel
    inputs' gradients backward) taken in f32 and rounded once, each
    rank's part still rounded to bf16 as its product gives it."""

    def copy(self, x):
        return list(_CopyF32.apply(x, self.M))

    def reduce(self, xs):
        return super().reduce([x.float() for x in xs]).to(xs[0].dtype)


class DroppedWoTP(tpm.VirtualTP):
    """A planted fault the bf16 gate must reject: the last rank's part of
    every attention's (rwkv6: time-mix's) row-parallel output dropped."""

    def pieces(self, module, leaf):
        out = super().pieces(module, leaf)
        if leaf == "wo" and isinstance(module, (Attention, TimeMix)):
            out[-1] = torch.zeros_like(out[-1])
        return out


def tp_model(cfg, p0, group=None):
    """The model from p0, unsharded (``group`` None) or as TP_RANKS
    virtual ranks of ``group`` (a ``VirtualTP`` class)."""
    model = build_model(cfg, device=DEV)
    model.load_state_dict(p0)
    if group is not None:
        check(tpm.place_virtual(model, TP_RANKS) != {},
              "tp: no leaf went tensor-parallel")
        model.tp = group(TP_RANKS)
    return model


def rel_norm(out, ref):
    return float(torch.linalg.vector_norm((out.float() - ref.float()))
                 / torch.linalg.vector_norm(ref.float()))


def logits_close(out, ref, cfg):
    """Over the vocab's columns (the padding's -1e9 left out): (max abs
    error, relative norm error, whether the one of cfg's type holds)."""
    out, ref = out[..., :cfg.vocab], ref[..., :cfg.vocab]
    err = (out.float() - ref.float()).abs().max().item()
    rel = rel_norm(out, ref)
    return err, rel, (err <= WIRING_ATOL if cfg.tdtype == torch.float32
                      else rel <= WIRING_BF16_RTOL)


def tol_fields(cfg):
    f32 = cfg.tdtype == torch.float32
    return dict(atol=WIRING_ATOL if f32 else None,
                rel_tol=None if f32 else WIRING_BF16_RTOL)


def tp_steps(cfg, p0, toks, group, tcfg=SHARDED_TCFG):
    """The first step's gradients, then SHARDED_STEPS steps of
    make_train_step from p0, on the unsharded model (``group`` None) or
    on TP_RANKS virtual ranks of ``group``: (params by name, losses,
    gradient norms, step seconds, flash counts of the steps, first
    gradients)."""
    model = tp_model(cfg, p0, group)
    params = dict(model.named_parameters())
    _, _, grads = accumulate_grads(model, params, tcfg, {"tokens": toks})
    grads = {n: g.detach().float() for n, g in grads.items()}
    state = adamw_init(params)
    step = make_train_step(model, tcfg)
    reset_counts()
    losses, norms, secs = [], [], []
    for _ in range(SHARDED_STEPS):
        state, met, dt = timed_step(step, state, {"tokens": toks})
        losses.append(met["loss"].float().cpu())
        norms.append(met["grad_norm"].float().cpu())
        secs.append(dt)
    counts = flash_counts()
    out = {n: p.detach().clone() for n, p in params.items()}
    del model, state, step, params
    torch.cuda.empty_cache()
    return out, losses, norms, secs, counts, grads


def change_rel(got, want, p0):
    """||got - want|| / ||want - p0|| over every parameter."""
    num = sum(float(torch.sum(torch.square(got[n].float()
                                           - want[n].float())))
              for n in want)
    den = sum(float(torch.sum(torch.square(want[n].float()
                                           - p0[n].float())))
              for n in want)
    return math.sqrt(num / den)


def tp_forward(cfg, p0, toks, tally):
    dt = cfg.tdtype
    L, M, D = cfg.n_layers, TP_RANKS, cfg.hdim
    H, G = cfg.n_heads // M, cfg.n_kv_heads // M
    with torch.no_grad():
        ref = tp_model(cfg, p0).forward({"tokens": toks})
        model = tp_model(cfg, p0, tpm.VirtualTP)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = model.forward({"tokens": toks})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = flash_counts()
    tally("forward", SHARDED_ARCH, counts[0], 0, counts[1], counts[2])
    err, rel, ok = logits_close(got, ref, cfg)
    B, S = TP_SHAPE
    want = {f"{fa.choose_variant(dt, S)}/{B}/{S}/{S}/{H}/{G}/{D}": L * M}
    emit(phase="tp", check="forward", arch=SHARDED_ARCH, ranks=M,
         n_layers=L, batch=B, seq_len=S, dtype=cfg.dtype, rank_heads=H,
         rank_kv_heads=G, max_abs_err=err, rel_err=rel, **tol_fields(cfg),
         within=ok, seconds=secs, launches=counts[0],
         launches_by_shape=counts[2], expected_launches_by_shape=want,
         reduced=reduced(SHARDED_ARCH, cfg))
    check(ok, f"tp forward ({cfg.dtype}): logits differ from the "
              f"unsharded model's by {err} (relative {rel})")
    check(counts[2] == want, f"tp forward: flash launches {counts[2]}, "
                             f"expected {want}")


def norm_rel(got, want):
    """The largest relative error of a run's gradient norms."""
    return max(abs(float(a) / float(b) - 1) for a, b in zip(got, want))


def tp_train(cfg, p0, toks, tally):
    dt = cfg.tdtype
    L, M, D = cfg.n_layers, TP_RANKS, cfg.hdim
    H, G = cfg.n_heads // M, cfg.n_kv_heads // M
    B, S = TP_SHAPE
    want, want_l, want_g, want_s, want_c, want_gr = tp_steps(cfg, p0, toks,
                                                             None)
    got, got_l, got_g, got_s, got_c, got_gr = tp_steps(cfg, p0, toks,
                                                       tpm.VirtualTP)
    tally("train", SHARDED_ARCH, got_c[0], 0, got_c[1], got_c[2])

    def grad_rel_err(grads):
        return math.sqrt(
            sum(float(torch.sum(torch.square(grads[n] - want_gr[n])))
                for n in want_gr)
            / sum(float(torch.sum(torch.square(want_gr[n])))
                  for n in want_gr))

    rel = change_rel(got, want, p0)
    grad_rel = grad_rel_err(got_gr)
    norm_err = norm_rel(got_g, want_g)
    loss_err = abs(float(got_l[0]) / float(want_l[0]) - 1)
    extra = {}
    if dt == torch.float32:
        ok = rel <= SHARDED_RTOL and norm_err <= SHARDED_NORM_RTOL
    else:
        def holds(param_err, grad_norm_err):
            return (param_err <= TP_BF16_PARAM_RTOL
                    and grad_norm_err <= TP_BF16_NORM_RTOL)

        ok = (loss_err <= TP_BF16_LOSS_RTOL
              and grad_rel <= GRAD_RTOL[torch.bfloat16]
              and holds(rel, norm_err))
        # beside it, from the same weights and batch: the control (the
        # unsharded steps at n_micro 1 against SHARDED_TCFG's 2), the
        # diagnostic (the ranks' sums in f32) and the planted fault
        one = dataclasses.replace(SHARDED_TCFG, n_micro=1)
        for name, group, tcfg in (("control", None, one),
                                  ("sum_f32", SumF32TP, SHARDED_TCFG),
                                  ("fault", DroppedWoTP, SHARDED_TCFG)):
            x_p, _, x_g, _, _, x_gr = tp_steps(cfg, p0, toks, group, tcfg)
            extra[f"{name}_param_rel_err"] = change_rel(x_p, want, p0)
            extra[f"{name}_grad_norm_err"] = norm_rel(x_g, want_g)
            extra[f"{name}_grad_rel_err"] = grad_rel_err(x_gr)
            del x_p, x_gr
            torch.cuda.empty_cache()
        extra["fault_rejected"] = not holds(extra["fault_param_rel_err"],
                                            extra["fault_grad_norm_err"])
    f32 = dt == torch.float32
    mb = B // SHARDED_TCFG.n_micro
    # a layer's forward and its remat recompute, each rank, each
    # microbatch, each step
    shapes = {f"{fa.choose_variant(dt, S)}/{mb}/{S}/{S}/{H}/{G}/{D}":
              2 * L * M * SHARDED_TCFG.n_micro * SHARDED_STEPS}
    emit(phase="tp", check="train", arch=SHARDED_ARCH, ranks=M, n_layers=L,
         batch=B, seq_len=S, n_micro=SHARDED_TCFG.n_micro,
         steps=SHARDED_STEPS, dtype=cfg.dtype, leaves=len(want),
         param_rel_err=rel,
         param_rtol=SHARDED_RTOL if f32 else TP_BF16_PARAM_RTOL,
         grad_norm_err=norm_err,
         norm_rtol=SHARDED_NORM_RTOL if f32 else TP_BF16_NORM_RTOL,
         grad_rel_err=grad_rel, grad_rtol=GRAD_RTOL[torch.bfloat16],
         first_loss_err=loss_err, loss_rtol=TP_BF16_LOSS_RTOL,
         losses=[float(v) for v in got_l],
         unsharded_losses=[float(v) for v in want_l],
         grad_norms=[float(v) for v in got_g],
         unsharded_grad_norms=[float(v) for v in want_g], **extra,
         within=ok, step_seconds=got_s, unsharded_step_seconds=want_s,
         launches=got_c[0], launches_by_shape=got_c[2],
         expected_launches_by_shape=shapes, unsharded_launches=want_c[0],
         reduced=reduced(SHARDED_ARCH, cfg))
    check(ok, f"tp train ({cfg.dtype}): parameters {rel}, gradient norms "
              f"{norm_err}, first gradients {grad_rel}, losses {loss_err} "
              f"off the unsharded steps'")
    check(got_c[2] == shapes, f"tp train: flash launches {got_c[2]}, "
                              f"expected {shapes}")
    check(f32 or extra["fault_rejected"],
          f"tp train (bf16): the gate passes a planted fault (the last "
          f"rank's attention output dropped): parameters "
          f"{extra.get('fault_param_rel_err')}, gradient norms "
          f"{extra.get('fault_grad_norm_err')}")
    del got, want, got_gr, want_gr
    torch.cuda.empty_cache()


def tp_decode(cfg, p0, ptoks, tally):
    """The unsharded run's prefill and greedy decode, then the same
    prompt and tokens through the virtual ranks' split cache."""
    dt = cfg.tdtype
    L, M, D = cfg.n_layers, TP_RANKS, cfg.hdim
    H, G = cfg.n_heads // M, cfg.n_kv_heads // M
    N, P, GEN = TP_SERVE
    atol, rtol = TOL[dt]
    with torch.no_grad():
        model = tp_model(cfg, p0)
        pre, cache = model.prefill({"tokens": ptoks}, cache_len=TP_SLOTS)
        feed = [pre[:, -1:].argmax(dim=-1)]
        ref_steps = []
        for t in range(P, P + GEN):
            lg, cache = model.decode_step(cache, feed[-1], t)
            ref_steps.append(lg[:, 0])
            feed.append(lg[:, -1:].argmax(dim=-1))
        del model, cache
        model = tp_model(cfg, p0, tpm.VirtualTP)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts, cache = model.prefill_split(model.embed_tokens(ptoks),
                                           TP_SLOTS)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        slots = [c.k.shape[2] for c in cache.parts]
        pre_err, pre_rel, pre_ok = logits_close(torch.cat(parts, dim=-1),
                                                pre, cfg)
        del pre, parts
        errs, rels, oks, equal, decided, step_s = [], [], [], [], [], []
        for i, t in enumerate(range(P, P + GEN)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts, cache = model.decode_split(cache, feed[i], t)
            tok = tp_argmax(model.tp, [x[:, -1:] for x in parts])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            lg, ref = torch.cat(parts, dim=-1)[:, 0], ref_steps[i]
            err, rel, ok = logits_close(lg, ref, cfg)
            top = ref.float().topk(2, dim=-1).values
            sure = (top[:, 0] - top[:, 1]) > atol + rtol * top[:, 0].abs()
            errs.append(err)
            rels.append(rel)
            oks.append(ok)
            decided.append(int(sure.sum()))
            equal.append(bool((tok[:, 0] == feed[i + 1][:, 0])[sure].all()))
    counts = flash_counts()
    tally("serve", SHARDED_ARCH, counts[0], 0, counts[1], counts[2])
    C = TP_SLOTS // M
    want = {f"{fa.choose_variant(dt, P)}/{N}/{P}/{P}/{H}/{G}/{D}": L * M,
            f"partials/{N}/1/{C}/{cfg.n_heads}/{cfg.n_kv_heads}/{D}":
            L * M * GEN,
            f"merge/{M}/{N * cfg.n_heads}/{D}": L * GEN}
    emit(phase="tp", check="decode", arch=SHARDED_ARCH, ranks=M, n_layers=L,
         requests=N, prompt_len=P, steps=GEN, slots=TP_SLOTS,
         rank_slots=slots, dtype=cfg.dtype, prefill_max_abs_err=pre_err,
         prefill_rel_err=pre_rel, prefill_within=pre_ok,
         max_abs_err=max(errs), max_rel_err=max(rels), step_within=oks,
         tokens_equal=equal, decided_rows=decided,
         margin_tol=[atol, rtol], **tol_fields(cfg),
         prefill_seconds=pre_s, step_seconds=step_s, launches=counts[0],
         launches_by_shape=counts[2], expected_launches_by_shape=want,
         reduced=reduced(SHARDED_ARCH, cfg) + ["teacher-forced tokens"])
    check(slots == [C] * M, f"tp decode: rank slots {slots}")
    check(pre_ok and all(oks), f"tp decode ({cfg.dtype}): logits differ "
                               f"from the unsharded run's by {max(errs)} "
                               f"(relative {max(rels)}; prefill {pre_err})")
    check(all(equal), f"tp decode: greedy tokens differ where the margin "
                      f"is sure: {equal}")
    check(counts[2] == want, f"tp decode: flash launches {counts[2]}, "
                             f"expected {want}")


def tp_kernel_checks(cfg):
    """flash_decode_partials and flash_decode_merge on the card against
    their plain versions at a decode rank's shape (TP_SLOTS / TP_RANKS
    slots, every head), the cache full and a ring half empty, at n_split
    1, the chosen one and 3; the merge of TP_RANKS partials."""
    gen = torch.Generator(device=DEV).manual_seed(58)
    N, C = TP_SERVE[0], TP_SLOTS // TP_RANKS
    H, G, D = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    for dt in (torch.bfloat16, torch.float32):
        q = rand((N, 1, H, D), dt, gen)
        k, v = rand((N, C, G, D), dt, gen), rand((N, C, G, D), dt, gen)
        for name, kpos in (("full", ar(C, 300)),
                           ("ring", torch.where(ar(C) % 2 == 0, ar(C, 300),
                                                -1).to(torch.int32))):
            qpos = ar(1, 300 + C)
            ref = fa.flash_decode_partials_ref(q, k, v, qpos=qpos, kpos=kpos)
            for n_split in (1, None, 3):
                out = fa.flash_decode_partials(q, k, v, qpos=qpos, kpos=kpos,
                                               n_split=n_split)
                atol, rtol = TOL[torch.float32]
                err, ok = within(out, ref, atol, rtol)
                tag = f"tp_partials_{name}/{str(dt).split('.')[-1]}/{n_split}"
                emit(phase="tp", check="kernel", kernel="flash_attention",
                     case=tag, step="partials", n_split=n_split,
                     shape=[N, 1, C, H, G, D], max_abs_err=err, atol=atol,
                     rtol=rtol)
                check(ok and bool(torch.isfinite(out).all()),
                      f"flash_decode_partials disagrees with its plain "
                      f"version: {tag}")
        part = torch.stack([fa.flash_decode_partials_ref(
            q, rand((N, C, G, D), dt, gen), rand((N, C, G, D), dt, gen),
            qpos=ar(1, 300 + C), kpos=ar(C, 300)) for _ in range(TP_RANKS)])
        out = fa.flash_decode_merge(part, dt)
        ref = fa.flash_decode_merge_ref(part, dt)
        atol, rtol = TOL[dt]
        err, ok = within(out, ref, atol, rtol)
        tag = f"tp_merge/{str(dt).split('.')[-1]}"
        emit(phase="tp", check="kernel", kernel="flash_attention", case=tag,
             step="merge", shape=list(part.shape), max_abs_err=err,
             atol=atol, rtol=rtol)
        check(ok and out.dtype == dt, f"flash_decode_merge disagrees with "
                                      f"its plain version: {tag}")


def tp_family_kernel_checks():
    """flash_decode_partials against its plain version at each family's
    decode rank shape (TP_FAMILIES: slots / TP_RANKS, every head; hymba's
    window; whisper's cross K/V, non-causal over 1500 / TP_RANKS
    positions), bf16 and f32, at the n_split the wrapper chooses."""
    gen = torch.Generator(device=DEV).manual_seed(59)
    zero = torch.zeros((1,), dtype=torch.int32, device=DEV)
    for arch, (_, _, (N, _, _, slots), frames) in TP_FAMILIES.items():
        c = get_config(arch)
        if not slots:
            continue
        C = slots // TP_RANKS
        shapes = [("self", C, True, c.sliding_window, ar(1, slots - 1),
                   ar(C, slots - C))]
        if frames:
            X = frames // 2 // TP_RANKS
            shapes.append(("cross", X, False, 0, zero, zero.repeat(X)))
        H, G, D = c.n_heads, c.n_kv_heads, c.hdim
        for dt in (torch.bfloat16, torch.float32):
            for kind, Sk, causal, window, qpos, kpos in shapes:
                q = rand((N, 1, H, D), dt, gen)
                k, v = (rand((N, Sk, G, D), dt, gen) for _ in range(2))
                kw = dict(causal=causal, window=window, qpos=qpos, kpos=kpos)
                ref = fa.flash_decode_partials_ref(q, k, v, **kw)
                out = fa.flash_decode_partials(q, k, v, **kw)
                atol, rtol = TOL[torch.float32]
                err, ok = within(out, ref, atol, rtol)
                tag = (f"tp_partials_{arch.split('-')[0]}_{kind}/"
                       f"{str(dt).split('.')[-1]}")
                emit(phase="tp", check="kernel", kernel="flash_attention",
                     case=tag, step="partials", causal=causal,
                     window=window, shape=[N, 1, Sk, H, G, D],
                     max_abs_err=err, atol=atol, rtol=rtol)
                check(ok and bool(torch.isfinite(out).all()),
                      f"flash_decode_partials disagrees with its plain "
                      f"version: {tag}")


def tp_times(cfg, P):
    """The per-rank flash calls, timed as phase 6 times the serving shapes
    (eager calls, CUDA events): attn_fwd_tc at the forward's rank shape,
    and one decode step's attention, TP_RANKS ranks' partials over their
    slots and the merge, beside the plain versions and SDPA (over the
    whole cache, for the decode)."""
    gen = torch.Generator(device=DEV).manual_seed(57)
    dt = torch.bfloat16
    H, G, D = cfg.n_heads // TP_RANKS, cfg.n_kv_heads // TP_RANKS, cfg.hdim
    B, S = TP_SHAPE
    q, k, v = (rand((B, S, n, D), dt, gen) for n in (H, G, G))
    kw = dict(causal=True, qpos=ar(S), kpos=ar(S))
    sdpa = tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = {}
    got = fa.flash_attention(q, k, v, **kw)
    ref = fa.flash_attention_ref(q, k, v, **kw)
    atol, rtol = TOL[dt]
    err, ok = within(got, ref, atol, rtol)
    check(ok, f"tp times: attn_fwd_tc at {[B, S, H, G, D]} disagrees with "
              f"its plain version by {err}")
    del got, ref
    ms, host_us = time_ms(lambda: fa.flash_attention(q, k, v, **kw), 20)
    plain_ms, _ = time_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), 5)
    lib_ms, _ = time_ms(lambda: F.scaled_dot_product_attention(
        *sdpa, is_causal=True, enable_gqa=True), 20)
    nbytes, flops = flash_work(B, H, G, D, ar(S), ar(S), True, 0, 2)
    b_ms, b_by = least_ms(nbytes, flops)
    out["prefill_rank"] = dict(
        shape=[B, S, S, H, G, D], variant="tc", ms=ms, host_us=host_us,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        bytes=nbytes, flops=flops, max_abs_err=err, atol=atol, rtol=rtol)
    N = TP_SERVE[0]
    C = TP_SLOTS // TP_RANKS
    H, G = cfg.n_heads, cfg.n_kv_heads
    last = P + TP_SERVE[2] - 1
    q = rand((N, 1, H, D), dt, gen)
    ks, vs = (rand((N, TP_SLOTS, G, D), dt, gen) for _ in range(2))
    kpos, qpos = ar(TP_SLOTS), ar(1, last)
    sl = [slice(r * C, (r + 1) * C) for r in range(TP_RANKS)]

    rank_kv = [(ks[:, s].contiguous(), vs[:, s].contiguous()) for s in sl]

    def step(partials, merge):
        return merge(torch.stack([partials(q, a, b, causal=True, qpos=qpos,
                                           kpos=kpos[s])
                                  for (a, b), s in zip(rank_kv, sl)]), dt)

    got = step(fa.flash_decode_partials, fa.flash_decode_merge)
    ref = step(fa.flash_decode_partials_ref, fa.flash_decode_merge_ref)
    err, ok = within(got, ref, atol, rtol)
    check(ok, f"tp times: the decode step's partials and merge over "
              f"{TP_RANKS} ranks disagree with their plain versions by "
              f"{err}")
    del got, ref
    ms, host_us = time_ms(lambda: step(fa.flash_decode_partials,
                                       fa.flash_decode_merge), 200)
    plain_ms, _ = time_ms(lambda: step(fa.flash_decode_partials_ref,
                                       fa.flash_decode_merge_ref), 20)
    full = tuple(t.transpose(1, 2).contiguous() for t in (q, ks, vs))
    lib_ms, _ = time_ms(lambda: F.scaled_dot_product_attention(
        *full, enable_gqa=True), 200)
    nbytes, flops = flash_work(N, H, G, D, qpos, kpos, True, 0, 2)
    nbytes += TP_RANKS * N * H * (2 + D) * 4 * 2   # partials out and in
    b_ms, b_by = least_ms(nbytes, flops)
    out["decode_step_ranks"] = dict(
        shape=[N, 1, TP_SLOTS, H, G, D], ranks=TP_RANKS, slots_a_rank=C,
        variant="partials+merge", ms=ms, host_us=host_us,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        bytes=nbytes, flops=flops, max_abs_err=err, atol=atol, rtol=rtol,
        library="SDPA over the whole cache (the ranks' merged function)")
    return out


#: the other families' runs as TP_RANKS virtual ranks, at full width and
#: cut depth: arch -> (cuts, (B, S) of the forward and the training,
#: (requests, prompt, decode steps, cache slots) of the serving, encdec
#: frames). Each forward in f32 (TF32 off), held within
#: TP_FAMILY_F32_RTOL of the unsharded model's largest |logit|, and in
#: bf16 (WIRING_BF16_RTOL in norm); the bf16 training's 3 steps on f32
#: master weights under TP_FAMILY_PARAM_RTOL and TP_BF16_NORM_RTOL with
#: the planted fault rejected (TP_FAMILY_TCFG); the prefill and
#: teacher-forced decode over the split caches in f32 (the logits within
#: WIRING_ATOL) and in bf16 (WIRING_BF16_RTOL in norm), tokens equal
#: wherever decided. In bf16 the ranks' sums move a MoE router's input by
#: a bf16 ulp, which flips a token's expert where two are near (arctic-480b
#: on an H100: one decided token of 109 and a step's logits 10% off in
#: norm): a MoE row is decided, and its logits compared, only where the
#: unsharded run's router gap between its k-th and (k+1)-th expert
#: exceeds TP_ROUTER_MARGIN at every MoE layer. The cache's slots split 40
#: a rank (internvl2-26b: 104, its 256 patch tokens ahead of the prompt),
#: ragged against the kernels' 64-key tile; whisper-medium's 1500 cross
#: K/V positions 375 a rank
TP_FAMILIES = {
    "dbrx-132b": (dict(n_layers=1), (2, 256), (4, 128, 32, 160), None),
    "arctic-480b": (dict(n_layers=1, n_experts=32), (2, 256),
                    (4, 128, 32, 160), None),
    "internvl2-26b": (dict(n_layers=2), (2, 256), (4, 128, 32, 416), None),
    "whisper-medium": (dict(n_layers=2, encoder_layers=2), (2, 256),
                       (4, 128, 32, 160), 3000),
    "rwkv6-7b": (dict(n_layers=2), (2, 256), (4, 128, 32, None), None),
    "hymba-1.5b": (dict(n_layers=2), (2, 256), (4, 128, 32, 160), None),
    # a rank's 8 heads and 2 kv heads at head dim 160
    "stablelm-12b": (dict(n_layers=2), (2, 256), (4, 128, 32, 160), None),
}
#: the families' f32 logits against the unsharded model's, TF32 off: the
#: largest error over the unsharded run's largest |logit|, so the bound
#: does not move with a family's logit scale (rwkv6-7b's logits reach
#: several times whisper-medium's, and its absolute error with them).
#: Set between the sound f32 readings and the bf16 runs' (the control
#: beside them in the forward line; PERF.md section 6)
TP_FAMILY_F32_RTOL = 1e-4
#: the families' 3 training steps at lr 1e-5 (tests/test_torch_train.py's
#: one-step rate): at TRAIN_OPT's 1e-3, and still at 1e-4, the one- and
#: two-layer models memorise the batch within 3 steps (on an H100,
#: rwkv6-7b's loss 11.6 -> 0.002) and the unsharded run's own n_micro
#: control parts from it. The model computes in bf16 and each update
#: lands on an f32 master copy of the parameters (``master_steps``): an
#: lr-1e-5 step is under half a bf16 ulp of most weights, so on bf16
#: parameters alone the change would read their rounding, not the
#: update. AdamW's moments in bf16 and one microbatch on both sides (the
#: moe family's f32 moments or accumulators do not fit beside the master
#: copy); the unsharded control (n_micro 2, the f32 sums in another
#: order) runs where it fits, for all but the moe family
TP_FAMILY_LR = 1e-5
TP_FAMILY_TCFG = TrainConfig(n_micro=1, opt=dataclasses.replace(
    TRAIN_OPT, lr=TP_FAMILY_LR, state_dtype="bfloat16"))
#: the families' 3 steps' change (||tp - ref|| over the unsharded change,
#: the master weights' change from p0), set between the sound runs'
#: readings and the planted faults' with room on both sides (NVIDIA H100
#: 80GB HBM3: sound 0.047-0.108, the n_micro controls 0.014-0.055, the
#: faults 0.885-1.157)
TP_FAMILY_PARAM_RTOL = 0.3
#: the leaves left out of the gated gradient norms, by arch: rwkv6-7b's
#: layer-0 ``u``, whose gradient at p0 (~1.8e3) is the norm's whole and
#: moves 11.6% under the ranks' bf16 rounding (its unsharded n_micro
#: control: 1.2%); the norms with it are read beside them. Without it
#: (NVIDIA H100 80GB HBM3): sound 0.016, control 0.012, fault 0.117
TP_FAMILY_NORM_OUT = {"rwkv6-7b": ("layers.0.att.u",)}
#: a MoE row is decided at a decode step where, at every MoE layer, the
#: unsharded run's router log-probability of its k-th expert exceeds its
#: (k+1)-th's by this much: above twice the largest router
#: log-probability difference between the two runs, which the decode line
#: reads beside it (NVIDIA H100 80GB HBM3, bf16: 0.0129 dbrx-132b, 0.0165
#: arctic-480b; f32 ~5e-6)
TP_ROUTER_MARGIN = 5e-2


def launch_counts():
    """(flash launches, gla_scan launches, flash launches by shape) since
    the last reset_counts."""
    return (fa.flash_attention.launches, gs.gla_scan.launches,
            flash_counts()[2])


def family_batch(cfg, toks, seed, frames):
    return with_side(cfg, {"tokens": toks}, seed, n_frames=frames)


def tp_family_forward(arch, cfg, p0, batch, tally):
    """The forward of the unsharded model and of the virtual ranks, in
    cfg's type; for the moe family in f32, a decode step's MoE FFN on
    each rank's E/M experts against the dense dispatch, bit for bit."""
    M = TP_RANKS
    f32 = cfg.tdtype == torch.float32
    L, attn = cfg.n_layers, attn_calls(cfg)[0]
    gla = cfg.family in ("ssm", "hybrid")
    with torch.no_grad():
        ref = tp_model(cfg, p0).forward(batch)
        torch.cuda.empty_cache()
        model = tp_model(cfg, p0, tpm.VirtualTP)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = model.forward(batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        held = {}
        if f32 and cfg.n_experts:
            gen = torch.Generator(device=DEV).manual_seed(61)
            h = rand((TP_FAMILIES[arch][2][0], 1, cfg.d_model), cfg.tdtype,
                     gen)
            experts = model.layers[0].moe
            out, _, dropped = moe_ffn_held(cfg, experts, h, M)
            held = dict(held_bit_equal=bool(torch.equal(
                out, moe_ffn(cfg, experts, h)[0])), held_dropped=dropped,
                rank_experts=cfg.n_experts // M)
    tally("forward", arch, counts[0], counts[1], {}, counts[2])
    err, rel = logits_close(got, ref, cfg)[:2]
    scale = ref[..., :cfg.vocab].float().abs().max().item()
    ok = err / scale <= TP_FAMILY_F32_RTOL if f32 else rel <= WIRING_BF16_RTOL
    want = (attn * M, L * M if gla else 0)
    B, S = batch["tokens"].shape
    emit(phase="tp", check="forward", arch=arch, ranks=M, n_layers=L,
         batch=B, seq_len=S, dtype=cfg.dtype, rank_heads=cfg.n_heads // M,
         max_abs_err=err, max_abs_logit=scale, scaled_err=err / scale,
         scaled_rtol=TP_FAMILY_F32_RTOL if f32 else None, rel_err=rel,
         rel_tol=None if f32 else WIRING_BF16_RTOL, within=ok, **held,
         seconds=secs, launches=counts[0], gla_launches=counts[1],
         expected_launches=list(want), launches_by_shape=counts[2],
         reduced=reduced(arch, cfg))
    check(ok, f"tp forward {arch} ({cfg.dtype}): logits differ from the "
              f"unsharded model's by {err} of {scale} (relative {rel})")
    check(counts[:2] == want, f"tp forward {arch}: launches {counts[:2]}, "
                              f"expected {want}")
    check(not held or held["held_bit_equal"],
          f"tp forward {arch}: the MoE FFN on the ranks' held experts is "
          f"not the dense dispatch's bits")
    del model, ref, got
    torch.cuda.empty_cache()


def pinned(p0):
    """p0's tensors copied to pinned host memory (fast to load back)."""
    return {n: torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t) for n, t in p0.items()}


def master_steps(cfg, p0, batch, group, tcfg, out=()):
    """SHARDED_STEPS steps from p0 (on the host) on the unsharded model
    (``group`` None) or on TP_RANKS virtual ranks of ``group``, as
    make_train_step runs them (accumulate_grads, then global_norm,
    adamw_scalars and adamw_leaf on every leaf), each update landing on
    an f32 master copy of the parameters that the model then takes
    rounded to its type: (the master weights' change from p0 by name,
    f32; losses; gradient norms; the norms without the leaves ``out``;
    step seconds; the share of the model's elements that moved)."""
    model = tp_model(cfg, p0, group)
    params = dict(model.named_parameters())
    master = {n: p.detach().float() for n, p in params.items()}
    state = adamw_init(params, tcfg.opt.state_dtype)
    opt = tcfg.opt
    losses, norms, kept, secs = [], [], [], []
    for _ in range(SHARDED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, grads = accumulate_grads(model, params, tcfg, batch)
        gnorm = global_norm(grads)
        sc = adamw_scalars(opt, state["step"], gnorm)
        with torch.no_grad():
            for n, p in params.items():
                adamw_leaf(opt, opt.weight_decay > 0 and decays(n, p),
                           master[n], grads[n], state["m"][n],
                           state["v"][n], sc)
                p.copy_(master[n])
        state["step"] = sc["step"]
        kept.append(float(global_norm({n: g for n, g in grads.items()
                                       if n not in out})))
        del grads
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        norms.append(float(gnorm))
    del state
    n_moved = 0
    with torch.no_grad():
        for n, m in master.items():
            p = p0[n].to(DEV)
            n_moved += int(torch.count_nonzero(params[n] != p))
            m.sub_(p.float())
    share = n_moved / sum(m.numel() for m in master.values())
    del model, params
    torch.cuda.empty_cache()
    return master, losses, norms, kept, secs, share


def delta_rel(got, want):
    """||got - want|| / ||want|| over every leaf of two changes."""
    num = sum(float(torch.sum(torch.square(got[n] - want[n].float())))
              for n in want)
    den = sum(float(torch.sum(torch.square(want[n].float())))
              for n in want)
    return math.sqrt(num / den)


def tp_family_train(arch, cfg, p0, batch, tally):
    """3 bf16 steps on f32 master weights of the unsharded model and of
    the virtual ranks, of the planted fault, and of the unsharded control
    where it fits, from the same weights (p0 on the host)."""
    M, tcfg = TP_RANKS, TP_FAMILY_TCFG
    out = TP_FAMILY_NORM_OUT.get(arch, ())
    want, want_l, want_g, want_k, want_s, want_moved = master_steps(
        cfg, p0, batch, None, tcfg, out)
    # the unsharded change kept in bf16 (its own scale, ~0.4% an element)
    want = {n: d.to(torch.bfloat16) for n, d in want.items()}
    reset_counts()
    got, got_l, got_g, got_k, got_s, got_moved = master_steps(
        cfg, p0, batch, tpm.VirtualTP, tcfg, out)
    counts = launch_counts()
    tally("train", arch, counts[0], counts[1], {}, counts[2])
    rel = delta_rel(got, want)
    del got
    torch.cuda.empty_cache()
    norm_err = norm_rel(got_k, want_k)
    loss_err = abs(got_l[0] / want_l[0] - 1)
    x_p, _, _, x_k, _, _ = master_steps(cfg, p0, batch, DroppedWoTP, tcfg,
                                        out)
    fault_rel, fault_norm = delta_rel(x_p, want), norm_rel(x_k, want_k)
    del x_p
    torch.cuda.empty_cache()
    control = {}
    if not cfg.n_experts:
        c_p, _, c_g, c_k, _, _ = master_steps(
            cfg, p0, batch, None, dataclasses.replace(tcfg, n_micro=2), out)
        control = dict(control_param_rel_err=delta_rel(c_p, want),
                       control_grad_norm_err=norm_rel(c_k, want_k),
                       control_whole_grad_norm_err=norm_rel(c_g, want_g))
        del c_p
    del want
    torch.cuda.empty_cache()

    def holds(param_err, grad_norm_err):
        return (param_err <= TP_FAMILY_PARAM_RTOL
                and grad_norm_err <= TP_BF16_NORM_RTOL)

    ok = loss_err <= TP_BF16_LOSS_RTOL and holds(rel, norm_err)
    rejected = not holds(fault_rel, fault_norm)
    steps = 2 * tcfg.n_micro * SHARDED_STEPS * M
    want_n = (attn_calls(cfg)[0] * steps,
              cfg.n_layers * steps if cfg.family in ("ssm", "hybrid") else 0)
    B, S = batch["tokens"].shape
    emit(phase="tp", check="train", arch=arch, ranks=M, n_layers=cfg.n_layers,
         batch=B, seq_len=S, n_micro=tcfg.n_micro, steps=SHARDED_STEPS,
         dtype=cfg.dtype, master_dtype="float32",
         opt_state_dtype=tcfg.opt.state_dtype,
         param_rel_err=rel, param_rtol=TP_FAMILY_PARAM_RTOL,
         moved_share=got_moved, unsharded_moved_share=want_moved,
         grad_norm_err=norm_err, norm_leaves_out=list(out),
         whole_grad_norm_err=norm_rel(got_g, want_g),
         norm_rtol=TP_BF16_NORM_RTOL,
         first_loss_err=loss_err, loss_rtol=TP_BF16_LOSS_RTOL,
         losses=got_l, unsharded_losses=want_l, grad_norms=got_g,
         unsharded_grad_norms=want_g, fault_param_rel_err=fault_rel,
         fault_grad_norm_err=fault_norm, **control, lr=tcfg.opt.lr,
         fault_rejected=rejected, within=ok, step_seconds=got_s,
         unsharded_step_seconds=want_s, launches=counts[0],
         gla_launches=counts[1], expected_launches=list(want_n),
         launches_by_shape=counts[2], reduced=reduced(arch, cfg))
    check(ok, f"tp train {arch}: parameters {rel}, gradient norms "
              f"{norm_err}, losses {loss_err} off the unsharded steps'")
    check(rejected, f"tp train {arch}: the gate passes a planted fault: "
                    f"parameters {fault_rel}, gradient norms {fault_norm}")
    check(counts[:2] == want_n, f"tp train {arch}: launches {counts[:2]}, "
                                f"expected {want_n}")


@contextlib.contextmanager
def router_log_probs(out):
    """Every MoE router call made inside, its (T, E) log-probabilities
    appended to ``out`` (the MoE FFNs route through models.moe.route)."""
    plain = moe_mod.route_probs

    def recorded(cfg, router, xt):
        probs, gates, topi = plain(cfg, router, xt)
        out.append(torch.log(probs))
        return probs, gates, topi

    moe_mod.route_probs = recorded
    try:
        yield
    finally:
        moe_mod.route_probs = plain


def router_sure(calls, k):
    """(B,) whether every call's gap between a row's k-th and (k+1)-th
    largest router log-probability exceeds TP_ROUTER_MARGIN."""
    sure = None
    for lp in calls:
        top = lp.topk(k + 1, dim=-1).values
        s = (top[:, k - 1] - top[:, k]) > TP_ROUTER_MARGIN
        sure = s if sure is None else sure & s
    return sure


def tp_family_decode(arch, cfg, p0, batch, tally):
    """The unsharded run's prefill and greedy decode, then the same
    prompt and tokens through the virtual ranks' split caches, in cfg's
    type. A MoE row is compared at a step only where its routing is sure
    (``router_sure``); the step's router calls of the two runs are held
    side by side (one a MoE layer each)."""
    M = TP_RANKS
    N, P, GEN, slots = TP_FAMILIES[arch][2]
    off = prefix_len(cfg)
    atol, rtol = TOL[cfg.tdtype]
    moe = bool(cfg.n_experts)
    with torch.no_grad():
        model = tp_model(cfg, p0)
        pre, cache = model.prefill(batch, cache_len=slots)
        feed = [pre[:, -1:].argmax(dim=-1)]
        ref_steps, ref_routes = [], []
        for t in range(P, P + GEN):
            calls = []
            with router_log_probs(calls):
                lg, cache = model.decode_step(cache, feed[-1], off + t)
            ref_steps.append(lg[:, 0])
            ref_routes.append(calls)
            feed.append(lg[:, -1:].argmax(dim=-1))
        del model, cache
        torch.cuda.empty_cache()
        model = tp_model(cfg, p0, tpm.VirtualTP)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts, cache = model.prefill_parts(batch, slots)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        held = {f: [tuple(getattr(c, f).shape[2:3]) for c in cache.parts]
                for f in ("k", "xk", "state", "ssm")
                if hasattr(cache.parts[0], f)}
        pre_err, pre_rel, pre_ok = logits_close(torch.cat(parts, dim=-1),
                                                pre, cfg)
        del pre, parts
        rels, oks, equal, decided, step_s = [], [], [], [], []
        unsure, route_diff = [], 0.0
        for i, t in enumerate(range(P, P + GEN)):
            calls = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with router_log_probs(calls):
                parts, cache = model.decode_split(cache, feed[i], off + t)
            tok = tp_argmax(model.tp, [x[:, -1:] for x in parts])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            lg, ref = torch.cat(parts, dim=-1)[:, 0], ref_steps[i]
            rows = torch.ones(ref.shape[0], dtype=torch.bool,
                              device=ref.device)
            if moe:
                check(len(calls) == len(ref_routes[i]) == cfg.n_layers,
                      f"tp decode {arch}: {len(calls)} and "
                      f"{len(ref_routes[i])} router calls at a step")
                route_diff = max(route_diff, max(
                    float((a - b).abs().max())
                    for a, b in zip(calls, ref_routes[i])))
                rows = router_sure(ref_routes[i], cfg.moe_topk)
                unsure.append(int((~rows).sum()))
            _, rel, ok = (logits_close(lg[rows], ref[rows], cfg)
                          if rows.any() else (0.0, 0.0, True))
            top = ref.float().topk(2, dim=-1).values
            sure = ((top[:, 0] - top[:, 1]) > atol + rtol * top[:, 0].abs()
                    ) & rows
            rels.append(rel)
            oks.append(ok)
            decided.append(int(sure.sum()))
            equal.append(bool((tok[:, 0] == feed[i + 1][:, 0])[sure].all()))
        counts = launch_counts()
        del model, cache
    torch.cuda.empty_cache()
    tally("serve", arch, counts[0], counts[1], {}, counts[2])
    L = cfg.n_layers
    pre_calls, step_calls = attn_calls(cfg)
    want = (pre_calls * M + GEN * step_calls * (M + 1),
            L * M if cfg.family in ("ssm", "hybrid") else 0)
    H, hl = cfg.n_heads, cfg.n_heads // math.gcd(cfg.n_heads, M)
    want_held = {"k": [((slots or 0) // M,)] * M,
                 "xk": [((TP_FAMILIES[arch][3] or 0) // 2 // M,)] * M,
                 "state": [(hl,)] * M, "ssm": [(hl,)] * M}
    want_held = {f: v for f, v in want_held.items() if f in held}
    route = (dict(router_unsure_rows=unsure, router_margin=TP_ROUTER_MARGIN,
                  router_max_abs_diff=route_diff) if moe else {})
    emit(phase="tp", check="decode", arch=arch, ranks=M, n_layers=L,
         requests=N, prompt_len=P, steps=GEN, slots=slots, rank_held=held,
         dtype=cfg.dtype, prefill_max_abs_err=pre_err,
         prefill_rel_err=pre_rel, prefill_within=pre_ok,
         max_rel_err=max(rels), step_within=oks, tokens_equal=equal,
         decided_rows=decided, margin_tol=[atol, rtol], **route,
         **tol_fields(cfg), prefill_seconds=pre_s, step_seconds=step_s,
         launches=counts[0], gla_launches=counts[1],
         expected_launches=list(want), launches_by_shape=counts[2],
         reduced=reduced(arch, cfg) + ["teacher-forced tokens"])
    check(held == want_held, f"tp decode {arch}: ranks hold {held}, "
                             f"expected {want_held} (of {H} heads)")
    check(pre_ok and all(oks), f"tp decode {arch} ({cfg.dtype}): logits "
                               f"differ from the unsharded run's by "
                               f"{max(rels)} (prefill {pre_rel})")
    check(all(equal), f"tp decode {arch} ({cfg.dtype}): greedy tokens "
                      f"differ where the margin is sure: {equal}")
    check(counts[:2] == want, f"tp decode {arch}: launches {counts[:2]}, "
                              f"expected {want}")


def tp_family(arch, tally):
    """One family's run: its weights drawn once (bf16), the forward in
    f32 and bf16, the bf16 training (the weights on the host beside it),
    the decode in f32 and bf16."""
    cuts, (B, S), (N, P, _, _), frames = TP_FAMILIES[arch]
    cfg = get_config(arch).scaled(**cuts)
    model = build_model(cfg, device=DEV)
    model.init_params(torch.Generator(device=DEV).manual_seed(71))
    p0 = {n: t.detach().clone() for n, t in model.state_dict().items()}
    del model
    gen = torch.Generator(device=DEV).manual_seed(72)
    toks = torch.randint(0, cfg.vocab, (B, S), device=DEV, generator=gen)
    ptoks = torch.randint(0, cfg.vocab, (N, P), device=DEV, generator=gen)
    for dtype in ("float32", "bfloat16"):
        c = cfg.scaled(dtype=dtype)
        p = {n: t.to(c.tdtype) for n, t in p0.items()}
        tp_family_forward(arch, c, p, family_batch(c, toks, 73, frames),
                          tally)
        del p
        torch.cuda.empty_cache()
    host = pinned(p0)
    del p0
    torch.cuda.empty_cache()
    tp_family_train(arch, cfg, host, family_batch(cfg, toks, 73, frames),
                    tally)
    for dtype in ("float32", "bfloat16"):
        c = cfg.scaled(dtype=dtype)
        p = {n: t.to(DEV, c.tdtype) for n, t in host.items()}
        tp_family_decode(arch, c, p, family_batch(c, ptoks, 74, frames),
                         tally)
        del p
        torch.cuda.empty_cache()


def phase_tp():
    """Forward, training and teacher-forced decode of TP_RANKS virtual
    'model' ranks against the unsharded model from the same weights, in
    each of TP_DTYPES, then each of TP_FAMILIES; the two-step decode
    kernel against its plain versions; the per-rank calls timed. Returns
    the launches of the tensor-parallel runs (the main path), flash and
    gla_scan by run, flash by variant and by shape, and the times."""
    t_start = time.perf_counter()
    cfg = get_config(SHARDED_ARCH).scaled(**SHARDED_CUT)
    model = build_model(cfg, device=DEV)
    model.init_params(torch.Generator(device=DEV).manual_seed(51))
    p0 = {n: t.detach().clone() for n, t in model.state_dict().items()}
    del model
    gen = torch.Generator(device=DEV).manual_seed(52)
    toks = torch.randint(0, cfg.vocab, TP_SHAPE, device=DEV, generator=gen)
    N, P, _ = TP_SERVE
    ptoks = torch.randint(0, cfg.vocab, (N, P), device=DEV, generator=gen)
    torch.cuda.reset_peak_memory_stats()
    launches, by_run, by_variant, by_shape = 0, {}, {}, {}

    def tally(run, arch, flash, gla, variants, shapes):
        nonlocal launches
        launches += flash + gla
        got = by_run.setdefault(f"tp:{run}:{arch}",
                                {"flash_attention": 0, "gla_scan": 0})
        got["flash_attention"] += flash
        got["gla_scan"] += gla
        for src, dst in ((variants, by_variant), (shapes, by_shape)):
            for k, v in src.items():
                dst[k] = dst.get(k, 0) + v

    for dtype in TP_DTYPES:
        c = cfg.scaled(dtype=dtype)
        p = {n: t.to(c.tdtype) for n, t in p0.items()}
        tp_forward(c, p, toks, tally)
        tp_train(c, p, toks, tally)
        tp_decode(c, p, ptoks, tally)
        del p
        torch.cuda.empty_cache()
    del p0
    torch.cuda.empty_cache()
    for arch in TP_FAMILIES:
        t0 = time.perf_counter()
        tp_family(arch, tally)
        emit(phase="tp", check="family_seconds", arch=arch,
             seconds=time.perf_counter() - t0,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    peak = torch.cuda.max_memory_allocated() / 1e9
    tp_kernel_checks(cfg)
    tp_family_kernel_checks()
    times = tp_times(cfg, P)
    for name, row in times.items():
        emit(phase="tp", check="times", at=name, **row)
    emit(phase="tp", check="summary", seconds=time.perf_counter() - t_start,
         peak_mem_gb=peak, launches=launches, launches_by_run=by_run,
         launches_by_variant=by_variant, launches_by_shape=by_shape)
    return {"launches": launches, "by_run": by_run,
            "by_variant": by_variant, "by_shape": by_shape, "times": times}


# -------------------------------------------------------------- dryrun --
DRYRUN_ROWS, DRYRUN_SKIPS = 80, 16
DRYRUN_LIMIT_S = 600
#: a serving rank's memory at decode_32k must fit the card (80 GB)
DRYRUN_DECODE_GIB = 80


def pin_threads(cores):
    """Every thread of this process on ``cores`` (threads made later
    inherit the main thread's set)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cores)
        except ProcessLookupError:  # the thread has ended
            pass


def start_dryrun(out_dir):
    """The dry run of every cell on both meshes in a CPU process of its
    own (no card: CUDA_VISIBLE_DEVICES empty), beside the card phases. It
    gets the last core of this process's set and this process keeps the
    others until the dry run is read, so the host-timed phases beside it
    share no core with it (on a one-core host nothing is pinned)."""
    cores = sorted(os.sched_getaffinity(0))
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    log = open(Path(out_dir) / "dryrun.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--both-meshes", "--json", str(Path(out_dir) / "dryrun.json")],
        stdout=log, stderr=subprocess.STDOUT, env=env,
        cwd=Path(__file__).resolve().parent)
    if len(cores) > 1:
        os.sched_setaffinity(proc.pid, {cores[-1]})
        pin_threads(set(cores[:-1]))
    emit(phase="dryrun", check="start", cores=len(cores),
         dryrun_core=cores[-1] if len(cores) > 1 else None)
    return proc, log, time.perf_counter(), set(cores)


def phase_dryrun(started):
    """Wait for the dry run (killed past DRYRUN_LIMIT_S from its start),
    print its rows, hold its counts."""
    proc, log, t0, cores = started
    out_dir = Path(log.name).parent
    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_LIMIT_S
                                   - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    finally:
        log.close()
        pin_threads(cores)
    text = (out_dir / "dryrun.log").read_text()
    rows = (json.loads((out_dir / "dryrun.json").read_text())
            if (out_dir / "dryrun.json").exists() else [])
    shutil.rmtree(out_dir, ignore_errors=True)
    for r in rows:
        emit(phase="dryrun", **{k: r.get(k) for k in (
            "arch", "shape", "status", "mesh", "n_devices", "n_params",
            "n_active_params", "model_flops_global", "compute_s",
            "memory_s", "collective_s", "dominant", "useful_flop_fraction",
            "roofline_fraction", "count_s")},
             per_device_gib=(r["memory"]["per_device_total"] / 2**30
                             if "memory" in r else None),
             reason=r.get("reason") or r.get("error"))
    status = [r["status"] for r in rows]
    summary = [ln for ln in text.splitlines() if ln.startswith("dryrun:")]
    emit(phase="dryrun", check="summary", rc=rc, rows=len(rows),
         skip=status.count("SKIP"), fail=status.count("FAIL"),
         line=summary[-1] if summary else None,
         seconds_from_start=time.perf_counter() - t0)
    check(rc == 0 and len(rows) == DRYRUN_ROWS
          and status.count("SKIP") == DRYRUN_SKIPS and "FAIL" not in status,
          f"dryrun: rc {rc}, {len(rows)} rows, {status.count('SKIP')} SKIP, "
          f"{status.count('FAIL')} FAIL; {text[-1500:]}")
    decode = {f"{r['arch']} {r['mesh']}":
              r["memory"]["per_device_total"] / 2**30
              for r in rows if r["shape"] == "decode_32k"
              and r["status"] == "OK"}
    over = {k: v for k, v in decode.items() if v >= DRYRUN_DECODE_GIB}
    emit(phase="dryrun", check="decode_memory", rows=len(decode),
         max_gib=max(decode.values(), default=None),
         limit_gib=DRYRUN_DECODE_GIB, over=over)
    check(decode and not over, f"dryrun: decode_32k rows at or over "
                               f"{DRYRUN_DECODE_GIB} GiB a rank: {over}")


PER_CALL_KEYS = ("shape", "variant", "n_split", "ms", "host_us",
                 "device_ms", "simt_ms", "simt_host_us", "simt_device_ms",
                 "plain_ms", "library_ms", "library_host_us",
                 "library_device_ms", "bound_ms", "bound_by",
                 "launches_per_serving_run", "fwd_bwd_ms", "backward_ms",
                 "plain_backward_ms", "library_fwd_bwd_ms",
                 "library_backward_ms", "fwd_bwd_bound_ms")


def kernel_entry(kernel, source, replaces, launches, max_abs_err, per):
    """One kernel of the kernels line: times are totals over the serving
    runs' calls (each shape's per-call time x its calls in a run). ms,
    plain_ms and library_ms are eager calls timed by CUDA events, as in
    every PR; device_ms is the kernel's time in CUDA graphs; simt_* are
    the first design's. ``launches`` holds each main-path run's count:
    the serving runs by arch, the training runs as "train:<arch>", the
    tp phase's as "tp:<forward, train or serve>:<arch>"."""
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
    # the dry run is host work: it runs beside the card phases 3-9, on a
    # core they do not use
    runs = {"mapreduce": phase_mapreduce,
            "mesh": lambda: phase_mesh(done.pop("mapreduce")),
            "fill": phase_fill,
            "lockstep": phase_lockstep, "scheduler": phase_scheduler,
            "sweep_pool": phase_sweep_pool,
            "dryrun_start": lambda: start_dryrun(tempfile.mkdtemp()),
            "kernel": phase_kernel,
            "wiring": phase_wiring,
            "serve": phase_serve, "times": phase_times, "grad": phase_grad,
            "train_wiring": phase_train_wiring, "train": phase_train,
            "moe_ep": phase_moe_ep, "train_sharded": phase_train_sharded,
            "tp": phase_tp,
            "dryrun": lambda: phase_dryrun(done.pop("dryrun_start"))}
    try:
        for name, run in runs.items():
            t0 = time.perf_counter()
            done[name] = run()
            if name != "dryrun_start":
                emit(phase="phase_seconds", name=name,
                     seconds=time.perf_counter() - t0)
    finally:
        if "dryrun_start" in done:  # a phase failed before the dry run's
            proc, log, _, cores = done.pop("dryrun_start")
            proc.kill()
            proc.wait()
            log.close()
            pin_threads(cores)
    # the sharded step's flash launches beside the training runs', the
    # tensor-parallel runs' (forward, train, serve) beside the serving
    # runs'
    done["train"][0][f"sharded:{SHARDED_ARCH}"] = {
        "flash_attention": done["train_sharded"], "gla_scan": 0}
    for run, n in done["tp"]["by_run"].items():
        done["serve"][0][run] = n

    print(smi, flush=True)
    kernels = kernels_line(done["kernel"], *done["serve"], done["times"],
                           *done["train"])
    kernels[0]["launches_tp"] = {k: done["tp"][k] for k in (
        "by_variant", "by_shape", "times")}
    emit(kernels=kernels + [fill_entry(done["fill"], *done["lockstep"])])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


# phase 3's cases at the bf16 serving shapes, whose errors the kernels line
# reports
SERVING_CASES = ("prefill", "decode", "hymba_prefill", "hymba_decode",
                 "stablelm_prefill", "stablelm_decode", "qwen25_prefill",
                 "qwen25_decode", "granite_prefill", "granite_decode",
                 "internvl2_prefill", "internvl2_decode", "dbrx_prefill",
                 "dbrx_decode", "arctic_prefill", "arctic_decode",
                 "whisper_encoder", "whisper_prefill",
                 "whisper_cross_prefill", "whisper_decode",
                 "whisper_cross_decode")


def kernels_line(errs, launches, variants, per, launches_train, profiles):
    def by_kernel(kernel, runs):
        return {arch: n[kernel] for arch, n in runs.items() if n[kernel]}

    def by_run(kernel):  # the serving runs by arch, the training runs too
        return dict(by_kernel(kernel, launches), **{
            f"train:{arch}": n
            for arch, n in by_kernel(kernel, launches_train).items()})

    def serving_err(tag):  # bf16 serving shapes, the variant chosen there
        name, dtype, variant = tag.split("/")[:3]
        return (name in SERVING_CASES and dtype == "bfloat16"
                and variant != "simt")

    flash = kernel_entry(
        "flash_attention",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:27",
        by_run("flash_attention"),
        max(v for k, v in errs.items()
            if k.startswith("flash_attention:")
            and serving_err(k.split(":")[1])),
        per)
    gla = kernel_entry(
        "gla_scan", "src/repro_torch/kernels/csrc/gla_scan.cu",
        "src/repro/kernels/gla_scan.py:30", by_run("gla_scan"),
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
            arch: dict({"forward_kernel": prof[fwd_key[name]],
                        "backward_plain": prof[f"{name}_backward_device_ms"],
                        "step": prof["step_device_ms"],
                        "n_layers": prof["n_layers"]},
                       **({"moe_dispatch_backward":
                           prof["moe_dispatch_backward_device_ms"]}
                          if prof["moe_dispatch_backward_device_ms"] else {}))
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
