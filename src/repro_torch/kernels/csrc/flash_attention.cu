// Flash attention for Hopper (sm_90a): the forward in f32 and bf16, and
// the bf16 backward of the prefill kernel (attn_bwd_*, at the end).
//
// Replaces repro/kernels/flash_attention.py::_attn_kernel (the Pallas TPU
// kernel) together with the GQA broadcast of repro/kernels/ops.py.
// Same function: scores q.k / sqrt(D) in f32, mask
//   kpos >= 0  and (causal: kpos <= qpos)  and (window: kpos > qpos - window)
// with the finite fill NEG_INF = -1e30, online softmax with f32 m/l/acc,
// masked p zeroed, output acc / max(l, 1e-30) in the input dtype, so a row
// with no valid key is exactly 0.
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, G, D) contiguous, G divides H, and q
// head h reads kv head h / (H/G) by index (GQA copies nothing); qpos (Sq,)
// and kpos (Sk,) int32; o (B, Sq, H, D). D in {16, 32, 64, 128, 160}. A
// block serves packed rows f = position * (H/G) + head of one kv head, so
// each K/V tile is read once for all the q heads that share it. In prefill,
// whole
// key tiles that no row of the block can see (the causal upper triangle,
// the window's far past, empty ring slots) are skipped before they are
// loaded, decided from kpos alone since a ring's positions are not sorted.
// Ragged Sq/Sk are masked inside: rows past Sq are not written, keys past
// Sk count as kpos = -1.
//
// Three kernels behind one C entry point; the wrapper picks one by dtype and
// Sq (repro_torch/kernels/flash_attention.py::choose_variant):
//
// * attn_fwd_tc (bf16, Sq > 1: prefill). At the serving prefill shapes the
//   work is large beside the bytes (hymba-1.5b: 80.6 GFLOP over 126 MB, so
//   bound by operations), so it runs on the tensor cores: mma.sync m16n8k16
//   bf16 with f32 accumulators, Q held in registers as A fragments, K read
//   with ldmatrix and V with ldmatrix.trans from shared-memory rows padded
//   by 16 bytes (conflict-free), K/V tiles of 64 keys staged by cp.async in
//   two stages so the next tile loads while this one computes. 4 warps of
//   2 x 16 rows at D = 128, 4 warps of 16 rows at D = 160, 8 warps of 16
//   rows at D <= 64 (TcCfg). p is rounded to bf16 for P.V
//   and l sums the unrounded f32 p, as the Pallas kernel does; exp runs as
//   ex2 with log2(e) folded into the scale. Tiles that every row sees in
//   full skip the per-element mask. The block's fixed costs were most of
//   its time on the card, so the prologue issues its three loads (key
//   positions for the tile scan, Q, row positions) before waiting on any,
//   and o leaves through shared memory as coalesced 16-byte rows.
// * attn_decode_split + attn_decode_merge (Sq == 1: decode, both dtypes).
//   Decode reads the whole K/V cache for a handful of rows, so it is bound
//   by bytes and must spread the keys over the card: the key tiles are cut
//   into n_split contiguous ranges (grid n_split x G x B), each block's four
//   warps take 16 keys of each 64-key tile, f32 arithmetic on CUDA cores
//   (exact for f32), and each block writes its partial (m, l, acc) in f32 to
//   scratch; the merge kernel rescales the partials by their maxima and
//   writes o. Both launch inside one call. A block loads every tile of its
//   range with no scan first (a decode cache is full or nearly so; the
//   per-key mask keeps empty slots out), its first two tiles before
//   anything else. For a cache split over ranks the two kernels also run
//   apart (repro_flash_decode_partials: the split kernel and a merge into
//   one unnormalised partial a row; repro_flash_decode_merge: the merge of
//   the ranks' packed partials), the exchange between them the caller's.
// * attn_fwd (f32, Sq > 1; and any case on request): the first design, f32
//   on CUDA cores, kept because f32 on the tensor cores would be TF32. Grid
//   (ceil(Sq*H/G / 64), G, B); 8 warps x 8 query rows; per kv tile of 32
//   keys (one key per lane) a warp computes its rows' scores, updates the
//   online softmax in registers, writes p to shared memory and accumulates
//   p @ V with lanes over head dims.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the Pallas kernel's finite NEG_INF
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTileKeys = 32;                      // one key per lane
constexpr unsigned kFull = 0xffffffffu;

// 16-byte vectors of the storage type, converted to f32 on the way to
// shared memory.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void stage(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void stage(const __nv_bfloat16* src, float* dst) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float2 a = __bfloat1622float2(h[0]);
  float2 b = __bfloat1622float2(h[1]);
  float2 c = __bfloat1622float2(h[2]);
  float2 d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

template <int N>
__device__ __forceinline__ void zero(float* dst) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    reinterpret_cast<float4*>(dst)[i / 4] = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Raises a kernel's dynamic shared-memory limit when a launch needs more
// than it was granted so far (48 KB needs no attribute).
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes, size_t* granted) {
  if (bytes <= *granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockRows * D             // Q rows
                          + kTileKeys * (D + 4)      // K tile, padded rows
                          + kTileKeys * D            // V tile
                          + kBlockRows * kTileKeys)  // p per row
         + sizeof(int) * (kBlockRows + kTileKeys);   // qpos, kpos
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const int* __restrict__ qpos,
         const int* __restrict__ kpos, T* __restrict__ o, int Sq, int Sk,
         int H, int G, int causal, int window, float scale) {
  constexpr int KS = D + 4;                  // K row stride: no bank conflicts
  constexpr int DPL = D >= 32 ? D / 32 : 1;  // output dims per lane
  constexpr int VN = Vec<T>::N;
  constexpr int VPR = D / VN;                // 16-byte vectors per row

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockRows * D;
  float* sV = sK + kTileKeys * KS;
  float* sP = sV + kTileKeys * D;
  int* sQp = reinterpret_cast<int*>(sP + kBlockRows * kTileKeys);
  int* sKp = sQp + kBlockRows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, g = blockIdx.y;
  const int hpg = H / G;
  const int n_rows = Sq * hpg;               // rows f = qi * hpg + head-in-group
  const int row0 = blockIdx.x * kBlockRows;

  for (int e = tid; e < kBlockRows * VPR; e += blockDim.x) {
    const int r = e / VPR, c = (e % VPR) * VN, f = row0 + r;
    if (f < n_rows) {
      const int qi = f / hpg, h = g * hpg + f % hpg;
      stage(q + ((size_t)(b * Sq + qi) * H + h) * D + c, sQ + r * D + c);
    } else {
      zero<VN>(sQ + r * D + c);
    }
  }
  for (int r = tid; r < kBlockRows; r += blockDim.x) {
    const int f = row0 + r;
    sQp[r] = f < n_rows ? qpos[f / hpg] : 0;
  }
  __syncthreads();

  // the block's query-position range, for skipping whole kv tiles
  const int last_row = min(kBlockRows, n_rows - row0);
  int qmin = sQp[0], qmax = sQp[0];
  for (int r = 1; r < last_row; ++r) {
    qmin = min(qmin, sQp[r]);
    qmax = max(qmax, sQp[r]);
  }

  const int wrow0 = warp * kRowsPerWarp;
  const bool warp_active = wrow0 < last_row;
  int qp[kRowsPerWarp];
  bool rvalid[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    qp[r] = sQp[wrow0 + r];
    rvalid[r] = wrow0 + r < last_row;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[r][dd] = 0.f;
  }
  float* pw = sP + wrow0 * kTileKeys;

  for (int t0 = 0; t0 < Sk; t0 += kTileKeys) {
    __syncthreads();  // every warp is done with the previous tile
    if (tid < kTileKeys) sKp[tid] = t0 + tid < Sk ? kpos[t0 + tid] : -1;
    __syncthreads();
    const int kp = sKp[lane];
    const bool useful = kp >= 0 && (!causal || kp <= qmax) &&
                        (window <= 0 || kp > qmin - window);
    // same sKp and bounds in every warp: the whole block skips together
    if (!__any_sync(kFull, useful)) continue;

    for (int e = tid; e < kTileKeys * VPR; e += blockDim.x) {
      const int j = e / VPR, c = (e % VPR) * VN;
      if (t0 + j < Sk) {
        const size_t off = ((size_t)(b * Sk + t0 + j) * G + g) * D + c;
        stage(k + off, sK + j * KS + c);
        stage(v + off, sV + j * D + c);
      } else {
        zero<VN>(sK + j * KS + c);
        zero<VN>(sV + j * D + c);
      }
    }
    __syncthreads();
    if (!warp_active) continue;

    // scores: lane = key of the tile, 8 rows at once
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(sK + lane * KS);
    const float4* q4 = reinterpret_cast<const float4*>(sQ + wrow0 * D);
#pragma unroll 4
    for (int c = 0; c < D / 4; ++c) {
      const float4 kk = k4[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = q4[r * (D / 4) + c];  // broadcast read
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // online softmax; l stays a per-lane partial sum until the end
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool ok = rvalid[r] && kp >= 0 && (!causal || kp <= qp[r]) &&
                      (window <= 0 || kp > qp[r] - window);
      const float sc = ok ? s[r] * scale : kNegInf;
      const float mn = fmaxf(m[r], warp_max(sc));
      const float alpha = expf(m[r] - mn);
      const float p = ok ? expf(sc - mn) : 0.f;
      l[r] = l[r] * alpha + p;
      m[r] = mn;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[r][dd] *= alpha;
      pw[r * kTileKeys + lane] = p;
    }
    __syncwarp();

    // acc += p @ V: lane owns dims lane + 32 * dd
#pragma unroll 2
    for (int j = 0; j < kTileKeys; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) {
          const int d = lane + 32 * dd;
          vv[jj][dd] = (D >= 32 || d < D) ? sV[(j + jj) * D + d] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(pw + r * kTileKeys + j);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) {
          float a = acc[r][dd];
          a = fmaf(pp.x, vv[0][dd], a);
          a = fmaf(pp.y, vv[1][dd], a);
          a = fmaf(pp.z, vv[2][dd], a);
          a = fmaf(pp.w, vv[3][dd], a);
          acc[r][dd] = a;
        }
      }
    }
  }

  if (!warp_active) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!rvalid[r]) continue;  // same r in every lane: warp-uniform
    const float den = fmaxf(warp_sum(l[r]), 1e-30f);
    const int f = row0 + wrow0 + r;
    const int qi = f / hpg, h = g * hpg + f % hpg;
    T* dst = o + ((size_t)(b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      const int d = lane + 32 * dd;
      if (D >= 32 || d < D) store(dst + d, acc[r][dd] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* qpos, const int* kpos, void* o, int B, int Sq,
                   int Sk, int H, int G, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static size_t granted = 48 << 10;  // per instantiation and process
  const cudaError_t err = allow_smem(attn_fwd<T, D>, smem, &granted);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)Sq * (H / G);
  const dim3 grid((unsigned)((rows + kBlockRows - 1) / kBlockRows), G, B);
  attn_fwd<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, static_cast<T*>(o), Sq, Sk, H, G,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* qpos, const int* kpos, void* o, int B,
                       int Sq, int Sk, int H, int G, int causal, int window,
                       float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, qpos, kpos, o, B, Sq, Sk, H, G, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, qpos, kpos, o, B, Sq, Sk, H, G, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, qpos, kpos, o, B, Sq, Sk, H, G, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, qpos, kpos, o, B, Sq, Sk, H, G, causal, window, scale, s);
    case 160: return launch<T, 160>(q, k, v, qpos, kpos, o, B, Sq, Sk, H, G, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Shared by attn_fwd_tc and attn_decode_split: cp.async staging and the list
// of key tiles a block has to visit.

constexpr int kTileK = 64;  // keys per tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros (a ragged edge).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kScanBatch = 8;  // key positions a thread loads at once

// kpos of keys t0 * kTileK + j, j = j0 + u * blockDim.x (u < kScanBatch),
// or -1 past nk keys or past Sk.
__device__ __forceinline__ void scan_load(const int* __restrict__ kpos,
                                          int Sk, int t0, int nk, int j0,
                                          int (&kp)[kScanBatch]) {
#pragma unroll
  for (int u = 0; u < kScanBatch; ++u) {
    const int j = j0 + u * blockDim.x, key = t0 * kTileK + j;
    kp[u] = j < nk && key < Sk ? kpos[key] : -1;
  }
}

// Fills list[0..n) with the tiles of [t0, t1) that hold a key some row of
// the block can see, each entry (tile << 1) | partial, where partial says
// some key of the tile is hidden from some row (or lies past Sk), so the
// per-element mask must run. qmin/qmax bound the block's row positions.
// The caller loads the first batch of keys (scan_load at j0 =
// threadIdx.x) early, so that those loads overlap its own. list needs
// 2 * (t1 - t0) ints: first one flag word per 32 keys, written by the warp
// that reads them (no atomics), then the entries. Returns n in every
// thread, after a barrier.
__device__ __forceinline__ int tile_list(const int* __restrict__ kpos,
                                         int Sk, int t0, int t1, int qmin,
                                         int qmax, int causal, int window,
                                         int (&kp)[kScanBatch], int* list,
                                         int* count) {
  const int nt = max(0, t1 - t0), nk = nt * kTileK, lane = threadIdx.x & 31;
  // a warp's 32 keys lie in one tile: blockDim and kTileK are multiples of
  // 32, so j < nk is the same in a whole warp
  for (int j0 = threadIdx.x; j0 < nk; j0 += kScanBatch * blockDim.x) {
    if (j0 != (int)threadIdx.x) scan_load(kpos, Sk, t0, nk, j0, kp);
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j >= nk) break;
      const bool seen = kp[u] >= 0 && (!causal || kp[u] <= qmax) &&
                        (window <= 0 || kp[u] > qmin - window);
      const bool by_all = kp[u] >= 0 && (!causal || kp[u] <= qmin) &&
                          (window <= 0 || kp[u] > qmax - window);
      const unsigned any = __ballot_sync(kFull, seen);
      const unsigned all = __ballot_sync(kFull, by_all);
      if (lane == 0) list[j / 32] = (any ? 1 : 0) | (all != kFull ? 2 : 0);
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // compact in place: entry i lands at n <= i
    int n = 0;
    for (int i0 = 0; i0 < nt; i0 += 32) {
      const int i = i0 + lane;
      const int flags = i < nt ? list[2 * i] | list[2 * i + 1] : 0;
      const unsigned use = __ballot_sync(kFull, flags & 1);
      __syncwarp();  // every lane has read its flags before any write
      if (flags & 1)
        list[n + __popc(use & ((1u << lane) - 1))] = ((t0 + i) << 1) |
                                                     (flags >> 1);
      n += __popc(use);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// ---------------------------------------------------------------------------
// attn_fwd_tc: bf16 prefill on the tensor cores.

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float kLog2e = 1.4426950408889634f;  // scale -> log2 domain

// 2^x in one MUFU instruction (relative error ~2^-22; 0 for x = -1e30)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D>
struct TcCfg {
  // 16-row m-tiles a warp. Two at D = 128: a block of 4 warps then has 128
  // rows, so each K/V tile read from L2 serves twice the rows (at 64 rows
  // a block, qwen3-4b's prefill spent as long on those reads as on the
  // arithmetic) and each K/V fragment feeds four mma; Q is then read from
  // shared memory per use, as its fragments would not fit the registers.
  // One at D <= 64, with 8 warps, Q held in registers. One at D = 160,
  // with 4 warps (64 rows), Q held in registers: two m-tiles would take
  // 2 x 80 f32 registers for O alone, and 128 rows of Q beside two stages
  // of K/V would fit one block an SM, not two; one takes O 80, S 32 and
  // Q's fragments 40, and (64 + 4 x 64) rows x 336 B ~ 105 KB a block.
  static constexpr int kMt = D == 128 ? 2 : 1;
  static constexpr int kWarps = D >= 128 ? 4 : 8;
  static constexpr int kRows = kWarps * kMt * 16;
  static constexpr int kStride = D + 8;  // bf16 row stride: +16 bytes
  static constexpr size_t kSmem =
      sizeof(bf16) * (kRows + 4 * kTileK) * kStride  // Q, 2 x (K, V)
      + sizeof(int) * (2 * kTileK + 2 * kWarps + 1);  // kpos x 2, bounds, n
};

// kLse: also write each row's log-sum-exp in the log2 domain of the
// scaled scores, lse[(b * G + g) * Sq * H/G + f] = m + log2(l) in the
// packed row order f (+inf for a row with no valid key), which the
// backward kernels read (training). kLse = false is the inference path.
template <int D, bool kLse>
__global__ void __launch_bounds__(TcCfg<D>::kWarps * 32, 2)
attn_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const int* __restrict__ qpos,
            const int* __restrict__ kpos, bf16* __restrict__ o,
            float* __restrict__ lse, int Sq, int Sk, int H, int G, int causal,
            int window, float scale_log2) {
  using C = TcCfg<D>;
  constexpr int NW = C::kWarps, MT = C::kMt, BM = C::kRows, RS = C::kStride;
  constexpr int NT = NW * 32, CH = D / 8;  // threads; 16-byte chunks a row
  constexpr int NJ = kTileK / 8;           // 8-key n-tiles of S
  constexpr int ND = D / 8;                // 8-dim n-tiles of O
  constexpr bool kQRegs = MT == 1;         // Q fragments kept in registers

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM * RS;               // [2][kTileK][RS]
  bf16* sV = sK + 2 * kTileK * RS;       // [2][kTileK][RS]
  int* sKp = reinterpret_cast<int*>(sV + 2 * kTileK * RS);  // [2][kTileK]
  int* sBound = sKp + 2 * kTileK;        // [2][NW]: min, max
  int* sCount = sBound + 2 * NW;
  int* sList = sCount + 1;               // [2 * n_tiles]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, g = blockIdx.y;
  const int hpg = H / G, n_rows = Sq * hpg;
  // the last rows see the most causal tiles: start them first
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int n_tiles = (Sk + kTileK - 1) / kTileK;

  // the prologue's three loads (key positions, Q, row positions) are all
  // issued before anything waits on one of them
  int kp[kScanBatch];
  scan_load(kpos, Sk, 0, n_tiles * kTileK, tid, kp);
  for (int e = tid; e < BM * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 8, f = row0 + r;
    const bool ok = f < n_rows;
    const int qi = ok ? f / hpg : 0, h = g * hpg + (ok ? f % hpg : 0);
    cp_async16(sQ + r * RS + c, q + ((size_t)(b * Sq + qi) * H + h) * D + c,
               ok ? 16 : 0);
  }
  cp_async_commit();

  // this thread's fragment rows: wrow + 16 * mt + fr + 8 * h, h = 0, 1
  const int fr = lane >> 2, fc = (lane & 3) * 2, wrow = warp * MT * 16;
  int qp[MT][2];
  bool rv[MT][2];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = row0 + wrow + 16 * mt + fr + 8 * h;
      rv[mt][h] = f < n_rows;
      qp[mt][h] = rv[mt][h] ? qpos[f / hpg] : 0;
      if (rv[mt][h]) {
        lo = min(lo, qp[mt][h]);
        hi = max(hi, qp[mt][h]);
      }
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, off));
    hi = max(hi, __shfl_xor_sync(kFull, hi, off));
  }
  if (lane == 0) {
    sBound[warp] = lo;
    sBound[NW + warp] = hi;
  }
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    qmin = min(qmin, sBound[w]);
    qmax = max(qmax, sBound[NW + w]);
  }
  const int n = tile_list(kpos, Sk, 0, n_tiles, qmin, qmax, causal, window,
                          kp, sList, sCount);

  auto load_tile = [&](int entry, int st) {
    const int key0 = (entry >> 1) * kTileK;
    bf16* dk = sK + st * kTileK * RS;
    bf16* dv = sV + st * kTileK * RS;
    for (int e = tid; e < kTileK * CH; e += NT) {
      const int j = e / CH, c = (e % CH) * 8, key = key0 + j;
      const bool ok = key < Sk;
      const size_t off = ((size_t)(b * Sk + (ok ? key : 0)) * G + g) * D + c;
      cp_async16(dk + j * RS + c, k + off, ok ? 16 : 0);
      cp_async16(dv + j * RS + c, v + off, ok ? 16 : 0);
    }
    for (int j = tid; j < kTileK; j += NT) {
      const bool ok = key0 + j < Sk;
      cp_async4(sKp + st * kTileK + j, kpos + (ok ? key0 + j : 0), ok ? 4 : 0);
    }
  };
  // the A fragment of Q for m-tile mt, k-step kk: lanes 0-15 address rows
  // 0-15 at dims +0, lanes 16-31 the same rows at dims +8
  auto q_frag = [&](int mt, int kk, uint32_t (&a)[4]) {
    ldsm_x4(a, sQ + (wrow + 16 * mt + (lane & 15)) * RS + kk * 16 +
                   (lane >> 4) * 8);
  };

  uint32_t qf[kQRegs ? D / 16 : 1][4];  // loaded at the first tile
  float oacc[MT][ND][4];
  float m[MT][2], l[MT][2];  // l: lane partials over the lane's columns
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = kNegInf;
      l[mt][h] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mt][j][e] = 0.f;
  }

  if (n > 0) load_tile(sList[0], 0);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    const int st = i & 1, entry = sList[i];
    if (i + 1 < n) load_tile(sList[i + 1], st ^ 1);
    cp_async_commit();  // maybe empty: keeps the group count uniform
    cp_async_wait<1>();  // all but the newest group have landed
    __syncthreads();
    if constexpr (kQRegs) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) q_frag(0, kk, qf[kk]);
      }
    }
    const bf16* tk = sK + st * kTileK * RS;
    const bf16* tv = sV + st * kTileK * RS;

    // S = Q K^T: lanes 0-7 / 8-15 / 16-23 / 24-31 address the 8x8 blocks
    // (keys +0, dims +0), (+0, +8), (+8, +0), (+8, +8) of K
    float s[MT][NJ][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (kQRegs) {
#pragma unroll
          for (int x = 0; x < 4; ++x) a[mt][x] = qf[kk][x];
        } else {
          q_frag(mt, kk, a[mt]);
        }
      }
#pragma unroll
      for (int nj = 0; nj < NJ / 2; ++nj) {
        uint32_t bk[4];
        ldsm_x4(bk, tk + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                        kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * nj], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * nj + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // online softmax in the log2 domain; element e of n-tile j is row
    // fr + 8 * (e >> 1), key 8 * j + fc + (e & 1) of the m-tile
    const bool partial = entry & 1;
    const int key0 = (entry >> 1) * kTileK;
    const int* kps = sKp + st * kTileK;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t okb = 0xffffffffu;
      if (partial) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, key = j * 8 + fc + (e & 1);
            const int kq = key0 + key < Sk ? kps[key] : -1;
            const int qq = qp[mt][h];
            const bool ok = rv[mt][h] && kq >= 0 && (!causal || kq <= qq) &&
                            (window <= 0 || kq > qq - window);
            if (!ok) okb &= ~(1u << (4 * j + e));
          }
      }
      // the row max of the raw scores (scale > 0), then p = 2^(s * scale -
      // m) in one FMA and one ex2; a row with no valid key so far keeps m
      // near NEG_INF and its masked p are zeroed by the bits
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((okb >> (4 * j + e)) & 1)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the 4 lanes of a quad share a row
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
        const float mn = fmaxf(m[mt][h], mx[h] * scale_log2);
        alpha[h] = ex2(m[mt][h] - mn);
        m[mt][h] = mn;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (okb >> (4 * j + e)) & 1
                              ? ex2(fmaf(s[mt][j][e], scale_log2,
                                         -m[mt][e >> 1]))
                              : 0.f;
          rs[e >> 1] += p;  // l takes the unrounded f32 p
          s[mt][j][e] = p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[mt][h] = l[mt][h] * alpha[h] + rs[h];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        oacc[mt][j][0] *= alpha[0];
        oacc[mt][j][1] *= alpha[0];
        oacc[mt][j][2] *= alpha[1];
        oacc[mt][j][3] *= alpha[1];
      }
    }

    // O += P V: P (rounded to bf16) is the A fragment straight from S's
    // accumulators; V through ldmatrix.trans, lanes 0-7 / 8-15 / 16-23 /
    // 24-31 address (keys +0, dims +0), (+8, +0), (+0, +8), (+8, +8)
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {
        uint32_t bv[4];
        ldsm_x4_t(bv, tv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               RS + dn * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(oacc[mt][2 * dn], pa[mt], bv[0], bv[1]);
          mma_bf16(oacc[mt][2 * dn + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // stage st is free for tile i + 2
  }
  // o through shared memory (the Q rows, read by now), so that each row
  // goes out as 16-byte stores of consecutive threads
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[mt][h] + __shfl_xor_sync(kFull, l[mt][h], 1);
      lt += __shfl_xor_sync(kFull, lt, 2);
      const float den = fmaxf(lt, 1e-30f);
      if constexpr (kLse) {
        const int f = row0 + wrow + 16 * mt + fr + 8 * h;
        if (fc == 0 && f < n_rows)
          lse[(size_t)(b * G + g) * n_rows + f] =
              lt > 0.f ? m[mt][h] + log2f(lt) : __int_as_float(0x7f800000);
      }
      bf16* dst = sQ + (wrow + 16 * mt + fr + 8 * h) * RS + fc;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(oacc[mt][j][2 * h] / den,
                                  oacc[mt][j][2 * h + 1] / den);
    }
  __syncthreads();
  for (int e = tid; e < BM * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 8, f = row0 + r;
    if (f >= n_rows) continue;
    const int qi = f / hpg, h = g * hpg + f % hpg;
    *reinterpret_cast<uint4*>(o + ((size_t)(b * Sq + qi) * H + h) * D + c) =
        *reinterpret_cast<const uint4*>(sQ + r * RS + c);
  }
}

template <int D, bool kLse>
cudaError_t launch_tc_as(const void* q, const void* k, const void* v,
                         const int* qpos, const int* kpos, void* o,
                         float* lse, int B, int Sq, int Sk, int H, int G,
                         int causal, int window, float scale,
                         cudaStream_t stream) {
  using C = TcCfg<D>;
  static size_t granted = 48 << 10;  // per instantiation and process
  const int n_tiles = (Sk + kTileK - 1) / kTileK;
  const size_t smem = C::kSmem + sizeof(int) * 2 * n_tiles;
  const cudaError_t err = allow_smem(attn_fwd_tc<D, kLse>, smem, &granted);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)Sq * (H / G);
  const dim3 grid((unsigned)((rows + C::kRows - 1) / C::kRows), G, B);
  attn_fwd_tc<D, kLse><<<grid, C::kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), qpos, kpos, static_cast<bf16*>(o), lse,
      Sq, Sk, H, G, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

// lse null: the inference instantiation (kLse = false)
template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* qpos, const int* kpos, void* o, float* lse,
                      int B, int Sq, int Sk, int H, int G, int causal,
                      int window, float scale, cudaStream_t s) {
  if (lse == nullptr)
    return launch_tc_as<D, false>(q, k, v, qpos, kpos, o, nullptr, B, Sq, Sk,
                                  H, G, causal, window, scale, s);
  return launch_tc_as<D, true>(q, k, v, qpos, kpos, o, lse, B, Sq, Sk, H, G,
                               causal, window, scale, s);
}

// ---------------------------------------------------------------------------
// attn_decode_split + attn_decode_merge: Sq == 1, keys split across blocks.

constexpr int kSplitWarps = 4;   // each takes 16 keys of a 64-key tile
constexpr int kSplitThreads = kSplitWarps * 32;

template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&d)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    d[0] = x.x; d[1] = x.y;
  } else {
    static_assert(N == 1, "1, 2 or 4 floats");
    d[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const bf16* p, float (&d)[N]) {
  if constexpr (N == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      d[2 * i] = f.x;
      d[2 * i + 1] = f.y;
    }
  } else if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    d[0] = a.x; d[1] = a.y; d[2] = b.x; d[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    d[0] = f.x; d[1] = f.y;
  } else {
    static_assert(N == 1, "1, 2, 4 or 8 bf16 values");
    d[0] = __bfloat162float(*p);
  }
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&x)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    static_assert(N == 1, "1, 2 or 4 floats");
    p[0] = x[0];
  }
}

template <int N>
__device__ __forceinline__ void store_n(bf16* p, const float (&x)[N]) {
  if constexpr (N == 4) {
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(x[0], x[1]),
                           __floats2bfloat162_rn(x[2], x[3])};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  } else if constexpr (N == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
  } else {
    static_assert(N == 1, "1, 2 or 4 values");
    p[0] = __float2bfloat16(x[0]);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// The output dims a lane owns in the split kernel's p @ V and in the
// merge: kMain contiguous dims at lane * kMain, moved as one vector, then
// kTail more at 32 * kMain + lane + 32 * t. kTail is 0 except at D = 160,
// where five dims at lane * 5 would be neither 8- nor 16-byte aligned, so
// a lane takes four and one.
template <int D>
struct LaneDims {
  static constexpr int kDpl = D >= 32 ? D / 32 : 1;
  static constexpr int kMain = kDpl > 4 ? 4 : kDpl;
  static constexpr int kTail = kDpl - kMain;
  static_assert(D < 32 || D == 32 * kDpl, "D a multiple of 32");
  // D = 16: lanes 0-15 hold a dim each, the others none
  static __device__ __forceinline__ bool active(int lane) {
    return D >= 32 || lane < D;
  }
  static __device__ __forceinline__ int dim(int lane, int e) {
    return e < kMain ? lane * kMain + e : 32 * kMain + lane + 32 * (e - kMain);
  }
};

template <int D, typename T>
__device__ __forceinline__ void load_lane(const T* row, int lane,
                                          float (&d)[LaneDims<D>::kDpl]) {
  using L = LaneDims<D>;
  float vec[L::kMain];
  load_f32<L::kMain>(row + lane * L::kMain, vec);
#pragma unroll
  for (int e = 0; e < L::kMain; ++e) d[e] = vec[e];
#pragma unroll
  for (int t = 0; t < L::kTail; ++t)
    d[L::kMain + t] = to_f32(row[L::dim(lane, L::kMain + t)]);
}

template <int D, typename T>
__device__ __forceinline__ void store_lane(
    T* row, int lane, const float (&x)[LaneDims<D>::kDpl]) {
  using L = LaneDims<D>;
  float vec[L::kMain];
#pragma unroll
  for (int e = 0; e < L::kMain; ++e) vec[e] = x[e];
  store_n<L::kMain>(row + lane * L::kMain, vec);
#pragma unroll
  for (int t = 0; t < L::kTail; ++t)
    store(row + L::dim(lane, L::kMain + t), x[L::kMain + t]);
}

template <typename T, int D, int R>  // R: q heads a block serves
struct SplitCfg {
  static constexpr int kVec = 16 / sizeof(T);        // elements a 16-byte load
  static constexpr int kStride = D + kVec;           // row stride: +16 bytes
  static constexpr size_t kStage = sizeof(T) * 2 * kTileK * kStride;  // K, V
  // one stage when a block has one tile (so more blocks fit an SM), else two
  static constexpr size_t smem(int stages) {
    return stages * kStage + sizeof(float) * R * D + sizeof(int) * 2 * kTileK +
           sizeof(float) * kSplitWarps * R * 16;
  }
  // the warps' partials, laid over the stages once the keys are done
  static_assert(sizeof(float) * (kSplitWarps * R * (D + 3) + R) <= kStage,
                "combine area");
};

// part: m (rows, n_split), l (rows, n_split), acc (rows, n_split, D) in f32,
// rows = B * H, row = b * H + h. R is a template argument so that loops
// over the rows issue nothing for rows a block does not have.
template <typename T, int D, int R>
__global__ void __launch_bounds__(kSplitThreads)
attn_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ qpos,
                  const int* __restrict__ kpos, float* __restrict__ part,
                  int Sk, int H, int G, int causal, int window, float scale) {
  using C = SplitCfg<T, D, R>;
  using LD = LaneDims<D>;
  constexpr int KS = C::kStride, VN = C::kVec, DPL = LD::kDpl;
  constexpr int CH = D / VN;  // 16-byte vectors a row
  // the merge grid may start now; it waits for this grid's writes itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int split = blockIdx.x, n_split = gridDim.x, b = blockIdx.z;
  const int n_tiles = (Sk + kTileK - 1) / kTileK;
  const int per = (n_tiles + n_split - 1) / n_split;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);  // [1 or 2][K, V][kTileK][KS]
  float* sQ = reinterpret_cast<float*>(  // [R][D], after the stages
      smem_raw + (per > 1 ? 2 : 1) * C::kStage);
  int* sKp = reinterpret_cast<int*>(sQ + R * D);  // [2][kTileK]
  float* sP = reinterpret_cast<float*>(sKp + 2 * kTileK);  // [warps][R][16]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hpg = H / G, n_chunks = (hpg + R - 1) / R;
  const int g = blockIdx.y / n_chunks, r0 = (blockIdx.y % n_chunks) * R;
  const int nr = min(R, hpg - r0), h0 = g * hpg + r0;
  const int t0 = min(n_tiles, split * per), t1 = min(n_tiles, t0 + per);
  // every tile of the range, with no scan first: a decode cache is full or
  // nearly so, and a scan would put a round trip before the first load
  const int n = t1 - t0;

  auto load_tile = [&](int t, int st) {
    const int key0 = t * kTileK;
    T* dk = stages + st * 2 * kTileK * KS;
    T* dv = dk + kTileK * KS;
    for (int e = tid; e < kTileK * CH; e += kSplitThreads) {
      const int j = e / CH, c = (e % CH) * VN, key = key0 + j;
      const bool ok = key < Sk;
      const size_t off = ((size_t)(b * Sk + (ok ? key : 0)) * G + g) * D + c;
      cp_async16(dk + j * KS + c, k + off, ok ? 16 : 0);
      cp_async16(dv + j * KS + c, v + off, ok ? 16 : 0);
    }
    for (int j = tid; j < kTileK; j += kSplitThreads) {
      const bool ok = key0 + j < Sk;
      cp_async4(sKp + st * kTileK + j, kpos + (ok ? key0 + j : 0), ok ? 4 : 0);
    }
  };

  // lane: key kl of the tile for the scores, the half hf of its dims taken
  // as every other 16-byte vector (so the two halves' Q reads use other
  // banks); dims LD::dim(lane, 0..DPL) for p @ V
  const int kl = warp * 16 + (lane & 15), hf = lane >> 4;
  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  // the first two tiles load first; q rows go to f32 meanwhile (the
  // loop's barrier shows them); tile i + 2 loads once tile i is done
  if (n > 0) load_tile(t0, 0);
  cp_async_commit();
  if (n > 1) load_tile(t0 + 1, 1);
  cp_async_commit();
  for (int e = tid; e < nr * D; e += kSplitThreads)
    sQ[e] = to_f32(q[((size_t)b * H + h0) * D + e]);
  const int qp = qpos[0];
  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    cp_async_wait<1>();  // all but the newest group: tile i has landed
    __syncthreads();
    const T* tk = stages + st * 2 * kTileK * KS;
    const T* tv = tk + kTileK * KS;
    const int key = (t0 + i) * kTileK + kl;
    const int kq = sKp[st * kTileK + kl];
    const bool ok = key < Sk && kq >= 0 && (!causal || kq <= qp) &&
                    (window <= 0 || kq > qp - window);

    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CH / 2; ++cc) {
      const int c = (2 * cc + hf) * VN;
      float kv[VN];
      load_f32<VN>(tk + kl * KS + c, kv);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nr) {
          const float* qr = sQ + r * D + c;
#pragma unroll
          for (int e = 0; e < VN; ++e) sc[r] = fmaf(qr[e], kv[e], sc[r]);
        }
    }

    // p goes through shared memory, so that p @ V reads four keys' p in
    // one 16-byte load instead of one shuffle a key and row
    float* pw = sP + warp * R * 16;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {  // nr is the same in the whole block
        // every lane shuffles, masked or not: a shuffle some lanes skip
        // never completes
        const float both = sc[r] + __shfl_xor_sync(kFull, sc[r], 16);
        const float x = ok ? both * scale : kNegInf;
        float mx = x;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float mn = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - mn);
        const float p = ok ? expf(x - mn) : 0.f;
        l[r] = l[r] * alpha + (hf == 0 ? p : 0.f);  // one half counts each key
        m[r] = mn;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
        if (hf == 0) pw[r * 16 + (lane & 15)] = p;
      }
    }
    __syncwarp();

#pragma unroll
    for (int j = 0; j < 16; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (LD::active(lane))
          load_lane<D>(tv + (warp * 16 + j + jj) * KS, lane, vv[jj]);
        else
          vv[jj][0] = 0.f;  // D = 16: DPL is 1
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nr) {
          const float4 p4 = *reinterpret_cast<const float4*>(pw + r * 16 + j);
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            float a = acc[r][e];
            a = fmaf(p4.x, vv[0][e], a);
            a = fmaf(p4.y, vv[1][e], a);
            a = fmaf(p4.z, vv[2][e], a);
            a = fmaf(p4.w, vv[3][e], a);
            acc[r][e] = a;
          }
        }
    }
    __syncthreads();  // stage st is free for tile i + 2
    if (i + 2 < n) load_tile(t0 + i + 2, st);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages become the combine area

  float* cm = reinterpret_cast<float*>(smem_raw);  // [kSplitWarps][R]
  float* cl = cm + kSplitWarps * R;                // [kSplitWarps][R]
  float* ca = cl + kSplitWarps * R;                // [kSplitWarps][R][D]
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < nr) {
      const float lt = warp_sum(l[r]);
      if (lane == 0) {
        cm[warp * R + r] = m[r];
        cl[warp * R + r] = lt;
      }
      if (LD::active(lane))
        store_lane<D>(ca + (warp * R + r) * D, lane, acc[r]);
    }
  __syncthreads();
  float* cw = ca + kSplitWarps * R * D;  // [kSplitWarps][R]: e^(m_w - M_r)
  float* cM = cw + kSplitWarps * R;      // [R]
  if (tid < nr) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) M = fmaxf(M, cm[w * R + tid]);
    cM[tid] = M;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      cw[w * R + tid] = expf(cm[w * R + tid] - M);  // 1 when all NEG_INF
  }
  __syncthreads();
  const size_t rows = (size_t)gridDim.z * H;
  for (int e = tid; e < nr * D; e += kSplitThreads) {
    const int r = e / D, d = e % D;
    const float M = cM[r];
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float x = cw[w * R + r];
      L = fmaf(cl[w * R + r], x, L);
      A = fmaf(ca[(w * R + r) * D + d], x, A);
    }
    const size_t ps = ((size_t)b * H + h0 + r) * n_split + split;
    part[2 * rows * n_split + ps * D + d] = A;
    if (d == 0) {
      part[ps] = M;
      part[rows * n_split + ps] = L;
    }
  }
}

// One warp a row: o = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M),
// 1e-30), M = max_s m_s. A split with no valid key has m = NEG_INF, l = 0,
// acc = 0 and adds nothing; a row with none in any split comes out 0.
// Partial s of a row is read at m[row * rs + s * ss], l likewise and
// acc[row * ars + s * ass + d]: the split kernel's scratch, or the packed
// partials of repro_flash_decode_merge. kPartial: the row's merged partial
// (M, L, sum_s acc_s e^(m_s - M)) is written, unnormalised, to out_part
// as a packed row of 2 + D floats instead of o.
template <typename T, int D, bool kPartial>
__global__ void __launch_bounds__(128)
attn_decode_merge(const float* __restrict__ m, const float* __restrict__ l,
                  const float* __restrict__ a, long long rs, long long ss,
                  long long ars, long long ass, T* __restrict__ o,
                  float* __restrict__ out_part, int rows, int n_split) {
  using LD = LaneDims<D>;
  constexpr int DPL = LD::kDpl;
  // launched early (programmatic dependent launch): wait until the split
  // grid has finished and its partials are visible; a plain launch has
  // nothing to wait for
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* pm = m + (size_t)row * rs;
  const float* pl = l + (size_t)row * rs;
  const float* pa = a + (size_t)row * ars;
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, pm[(size_t)s * ss]);
  float L = 0.f, acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(pm[(size_t)s * ss] - M);
    L = fmaf(pl[(size_t)s * ss], w, L);
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      if (LD::active(lane))
        acc[e] = fmaf(pa[(size_t)s * ass + LD::dim(lane, e)], w, acc[e]);
  }
  if (kPartial) {
    float* out = out_part + (size_t)row * (2 + D);
    if (lane == 0) {
      out[0] = M;
      out[1] = L;
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      if (LD::active(lane)) out[2 + LD::dim(lane, e)] = acc[e];
    return;
  }
  const float den = fmaxf(L, 1e-30f);
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] /= den;
  if (LD::active(lane))  // one vector store a lane (and one more at D 160)
    store_lane<D>(o + (size_t)row * D, lane, acc);
}

template <typename T, int D, int R>
cudaError_t launch_split_rows(const void* q, const void* k, const void* v,
                              const int* qpos, const int* kpos, void* o,
                              int B, int Sk, int H, int G, int causal,
                              int window, float scale, int n_split,
                              float* part, float* out_part,
                              cudaStream_t stream) {
  using C = SplitCfg<T, D, R>;
  static size_t granted = 48 << 10;  // per instantiation and process
  const int n_tiles = (Sk + kTileK - 1) / kTileK;
  const int per = (n_tiles + n_split - 1) / n_split;
  const size_t smem = C::smem(per > 1 ? 2 : 1);
  cudaError_t err = allow_smem(attn_decode_split<T, D, R>, smem, &granted);
  if (err != cudaSuccess) return err;
  const int n_chunks = (H / G + R - 1) / R;
  if ((long long)G * n_chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(n_split, G * n_chunks, B);
  attn_decode_split<T, D, R><<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, part, Sk, H, G, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the merge as a programmatic dependent launch: its blocks are placed
  // while the split grid runs, instead of after it
  const int rows = B * H;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + 3) / 4);
  cfg.blockDim = dim3(128);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* pm = part;
  const float* pl = part + (size_t)rows * n_split;
  const float* pa = part + 2 * (size_t)rows * n_split;
  const long long rs = n_split, ars = (long long)n_split * D;
  if (out_part != nullptr)
    return cudaLaunchKernelEx(&cfg, attn_decode_merge<T, D, true>, pm, pl,
                              pa, rs, 1LL, ars, (long long)D,
                              static_cast<T*>(o), out_part, rows, n_split);
  return cudaLaunchKernelEx(&cfg, attn_decode_merge<T, D, false>, pm, pl, pa,
                            rs, 1LL, ars, (long long)D, static_cast<T*>(o),
                            out_part, rows, n_split);
}

// Rows a block serves: 4 (qwen3-4b's 32/8 heads and fewer), 5 (hymba's
// 25/5), else 8 with more blocks along grid.y.
template <typename T, int D>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int* qpos, const int* kpos, void* o, int B,
                         int Sk, int H, int G, int causal, int window,
                         float scale, int n_split, float* part,
                         float* out_part, cudaStream_t s) {
  const int hpg = H / G;
  if (hpg <= 4)
    return launch_split_rows<T, D, 4>(q, k, v, qpos, kpos, o, B, Sk, H, G,
                                      causal, window, scale, n_split, part,
                                      out_part, s);
  if (hpg == 5)
    return launch_split_rows<T, D, 5>(q, k, v, qpos, kpos, o, B, Sk, H, G,
                                      causal, window, scale, n_split, part,
                                      out_part, s);
  return launch_split_rows<T, D, 8>(q, k, v, qpos, kpos, o, B, Sk, H, G,
                                    causal, window, scale, n_split, part,
                                    out_part, s);
}

template <typename T>
cudaError_t dispatch_split(int D, const void* q, const void* k, const void* v,
                           const int* qpos, const int* kpos, void* o, int B,
                           int Sk, int H, int G, int causal, int window,
                           float scale, int n_split, float* part,
                           float* out_part, cudaStream_t s) {
  switch (D) {
    case 16: return launch_split<T, 16>(q, k, v, qpos, kpos, o, B, Sk, H, G, causal, window, scale, n_split, part, out_part, s);
    case 32: return launch_split<T, 32>(q, k, v, qpos, kpos, o, B, Sk, H, G, causal, window, scale, n_split, part, out_part, s);
    case 64: return launch_split<T, 64>(q, k, v, qpos, kpos, o, B, Sk, H, G, causal, window, scale, n_split, part, out_part, s);
    case 128: return launch_split<T, 128>(q, k, v, qpos, kpos, o, B, Sk, H, G, causal, window, scale, n_split, part, out_part, s);
    case 160: return launch_split<T, 160>(q, k, v, qpos, kpos, o, B, Sk, H, G, causal, window, scale, n_split, part, out_part, s);
    default: return cudaErrorInvalidValue;
  }
}

// The merge of P packed partials a row, (P, rows, 2 + D) f32 (see
// repro_flash_decode_merge), into o (rows, D), as a plain launch.
template <typename T, int D>
cudaError_t launch_merge_packed(const float* part, void* o, int rows, int P,
                                cudaStream_t s) {
  const long long rs = 2 + D, ss = (long long)rows * (2 + D);
  attn_decode_merge<T, D, false><<<(rows + 3) / 4, 128, 0, s>>>(
      part, part + 1, part + 2, rs, ss, rs, ss, static_cast<T*>(o), nullptr,
      rows, P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_merge(int D, const float* part, void* o, int rows, int P,
                           cudaStream_t s) {
  switch (D) {
    case 16: return launch_merge_packed<T, 16>(part, o, rows, P, s);
    case 32: return launch_merge_packed<T, 32>(part, o, rows, P, s);
    case 64: return launch_merge_packed<T, 64>(part, o, rows, P, s);
    case 128: return launch_merge_packed<T, 128>(part, o, rows, P, s);
    case 160: return launch_merge_packed<T, 160>(part, o, rows, P, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_tc(int D, const void* q, const void* k, const void* v,
                        const int* qpos, const int* kpos, void* o, float* lse,
                        int B, int Sq, int Sk, int H, int G, int causal,
                        int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch_tc<16>(q, k, v, qpos, kpos, o, lse, B, Sq, Sk, H, G, causal, window, scale, s);
    case 32: return launch_tc<32>(q, k, v, qpos, kpos, o, lse, B, Sq, Sk, H, G, causal, window, scale, s);
    case 64: return launch_tc<64>(q, k, v, qpos, kpos, o, lse, B, Sq, Sk, H, G, causal, window, scale, s);
    case 128: return launch_tc<128>(q, k, v, qpos, kpos, o, lse, B, Sq, Sk, H, G, causal, window, scale, s);
    case 160: return launch_tc<160>(q, k, v, qpos, kpos, o, lse, B, Sq, Sk, H, G, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// attn_bwd_dq + attn_bwd_dkv: the backward of attn_fwd_tc (bf16), FA2-style.
//
// The JAX package trains through autograd of its plain attention (no Pallas
// backward); so did the port, through autograd of attention_plain, which
// writes (B, G, H/G, Sq, Sk) f32 scores and probabilities to device memory
// and took ~100x the least time. At the training shapes the work is large
// beside the bytes (granite-3-2b, B 4 x 1024, H 32, D 64: 4.3e10 operations
// of the five causal products over 85 MB), so operations bound it; both
// kernels run on the tensor cores as attn_fwd_tc does (mma.sync bf16 with
// f32 accumulators, ldmatrix, two cp.async stages) and recompute
// P = 2^(s * scale * log2 e - lse) from the forward's log-sum-exp (kLse), so
// no S x S matrix leaves the chip. P and dS enter their products in bf16, as
// the forward's P does. Masks as the forward: whole tiles the mask hides are
// skipped before they are loaded, tiles every row sees in full skip the
// per-element mask, a row with no valid key gets zero gradient.
//
// * attn_bwd_dq: one block a tile of packed rows of one kv head, 16 rows a
//   warp (attn_fwd_tc's layout at one m-tile a warp). First each row's
//   D = rowsum(dO o O) in f32, written for attn_bwd_dkv; then over the key
//   tiles the rows see (tile_list): S = Q K^T, dP = dO V^T, P,
//   dS = P (dP - D), dQ += dS K. dQ leaves once, in bf16.
// * attn_bwd_dkv: one block a 64-key tile of one kv head (grid key tiles x G
//   x B), each warp 16 of its keys. It walks the packed rows of the group
//   (every q head that reads the kv head, at every position) in steps of
//   kRows, those the mask lets see the tile (row_list): S^T = K Q^T,
//   dP^T = V dO^T, P^T, dS^T, dV += P^T dO, dK += dS^T Q. dK and dV stay in
//   f32 registers over the whole group, so the group's heads sum without
//   atomics; they leave once, in bf16.
//
// dQ takes a pass of its own rather than f32 atomics from attn_bwd_dkv: it
// recomputes S and dP (seven products where five would do), and in return
// needs no f32 scratch the size of q and no conversion pass after it, and
// gives the same bits on every run.

template <int D>
struct BwdCfg {
  static constexpr int kWarps = 4;       // both kernels
  static constexpr int kStride = D + 8;  // bf16 row stride: +16 bytes
  // attn_bwd_dq: 16 rows a warp; the Q and dO fragments held in registers
  // up to D 64, else read from shared memory per use
  static constexpr int kQRows = kWarps * 16;
  static constexpr bool kQRegs = D <= 64;
  // attn_bwd_dkv: packed rows a step (16 or a multiple of 32), as few as
  // keep dK and dV (D / 2 f32 registers each) beside S^T and dP^T (kRows / 2
  // each) without spills; the K and V fragments in registers up to D 64
  static constexpr int kRows = D <= 64 ? 64 : D <= 128 ? 32 : 16;
  static constexpr bool kKvRegs = D <= 64;
  static constexpr size_t kDqSmem =
      sizeof(bf16) * (2 * kQRows + 4 * kTileK) * kStride  // Q, dO, 2 x (K, V)
      + sizeof(float) * 2 * kQRows                         // lse, D
      + sizeof(int) * (2 * kTileK + 2 * kWarps + 1);       // kpos x 2, bounds
  static constexpr size_t kDkvSmem =
      sizeof(bf16) * (2 * kTileK + 4 * kRows) * kStride  // K, V, 2 x (Q, dO)
      + sizeof(float) * 4 * kRows                         // 2 x (lse, D)
      + sizeof(int) * (2 * kRows + kTileK + 6 + 1);       // qpos x 2, kpos
  static_assert(kWarps * 16 == kTileK, "attn_bwd_dkv: 16 keys a warp");
};

// Fills list[0..n) with the tiles of `rows` packed rows (f = position * hpg
// + head in group; n_rows of them) that see some key of a key tile whose
// valid positions lie in [kmin, kmax] (full: every key of the tile valid),
// each entry (tile << 1) | partial, where partial says some row of the tile
// may not see some key (or lies past n_rows), so the per-element mask must
// run. rows is 16 or a multiple of 32; list needs row_list_words ints: first
// one flag word per min(rows, 32) rows, written by the warp that reads
// them, then the entries. Returns n in every thread, after a barrier.
__host__ __device__ constexpr int row_list_words(int n_rows, int rows) {
  return (n_rows + 31) / 32 * (rows < 32 ? 2 : 1);
}

__device__ __forceinline__ int row_list(const int* __restrict__ qpos,
                                        int n_rows, int hpg, int rows,
                                        int kmin, int kmax, bool full,
                                        int causal, int window, int* list,
                                        int* count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, per = rows < 32 ? 1 : rows / 32;
  const int n_chunks = (n_rows + 31) / 32;
  const int words = row_list_words(n_rows, rows);
  const int n_tiles = (words + per - 1) / per;
  auto flags = [](unsigned any, bool all) {
    return (any ? 1 : 0) | (all ? 0 : 2);
  };
  for (int c = warp; c < n_chunks; c += nw) {
    const int f = 32 * c + lane;
    const bool ok = f < n_rows;
    const int qp = ok ? qpos[f / hpg] : 0;
    const bool seen = ok && kmin <= kmax && (!causal || qp >= kmin) &&
                      (window <= 0 || kmax > qp - window);
    const bool by_all = ok && full && (!causal || qp >= kmax) &&
                        (window <= 0 || kmin > qp - window);
    const unsigned any = __ballot_sync(kFull, seen);
    const unsigned all = __ballot_sync(kFull, by_all);
    if (lane == 0) {
      if (rows < 32) {  // a word a 16 rows
        list[2 * c] = flags(any & 0xffffu, (all & 0xffffu) == 0xffffu);
        list[2 * c + 1] = flags(any >> 16, (all >> 16) == 0xffffu);
      } else {
        list[c] = flags(any, all == kFull);
      }
    }
  }
  __syncthreads();
  if (warp == 0) {  // compact in place: entry t lands at n <= t
    int n = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      int f = 0;
      for (int u = 0; u < per; ++u) {
        const int w = t * per + u;
        if (t < n_tiles && w < words) f |= list[w];
      }
      const unsigned use = __ballot_sync(kFull, f & 1);
      __syncwarp();  // every lane has read its flags before any write
      if (f & 1)
        list[n + __popc(use & ((1u << lane) - 1))] = (t << 1) | (f >> 1);
      n += __popc(use);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

template <int D>
__global__ void __launch_bounds__(BwdCfg<D>::kWarps * 32, 2)
attn_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ o,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const int* __restrict__ qpos, const int* __restrict__ kpos,
            bf16* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk,
            int H, int G, int causal, int window, float scale_log2,
            float scale) {
  using C = BwdCfg<D>;
  constexpr int NW = C::kWarps, BM = C::kQRows, RS = C::kStride;
  constexpr int NT = NW * 32, CH = D / 8;  // threads; 16-byte chunks a row
  constexpr int NJ = kTileK / 8, ND = D / 8;
  constexpr bool kRegs = C::kQRegs;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + BM * RS;
  bf16* sK = sdO + BM * RS;              // [2][kTileK][RS]
  bf16* sV = sK + 2 * kTileK * RS;       // [2][kTileK][RS]
  float* sLse = reinterpret_cast<float*>(sV + 2 * kTileK * RS);  // [BM]
  float* sDel = sLse + BM;               // [BM]
  int* sKp = reinterpret_cast<int*>(sDel + BM);  // [2][kTileK]
  int* sBound = sKp + 2 * kTileK;        // [2][NW]: min, max
  int* sCount = sBound + 2 * NW;
  int* sList = sCount + 1;               // [2 * n_tiles]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, g = blockIdx.y;
  const int hpg = H / G, n_rows = Sq * hpg;
  // the last rows see the most causal tiles: start them first
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int n_tiles = (Sk + kTileK - 1) / kTileK;
  const size_t rbase = (size_t)(b * G + g) * n_rows;  // lse and D rows

  int kp[kScanBatch];
  scan_load(kpos, Sk, 0, n_tiles * kTileK, tid, kp);
  for (int e = tid; e < BM * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 8, f = row0 + r;
    const bool ok = f < n_rows;
    const int qi = ok ? f / hpg : 0, h = g * hpg + (ok ? f % hpg : 0);
    const size_t off = ((size_t)(b * Sq + qi) * H + h) * D + c;
    cp_async16(sQ + r * RS + c, q + off, ok ? 16 : 0);
    cp_async16(sdO + r * RS + c, dout + off, ok ? 16 : 0);
  }
  cp_async_commit();

  // this thread's fragment rows: wrow + fr + 8 * h, h = 0, 1
  const int fr = lane >> 2, fc = (lane & 3) * 2, wrow = warp * 16;
  {  // D = rowsum(dO o O) in f32: two lanes a row, every other 16 bytes
    const int r = lane >> 1, f = row0 + wrow + r;
    float d = 0.f;
    if (f < n_rows) {
      const size_t off =
          ((size_t)(b * Sq + f / hpg) * H + g * hpg + f % hpg) * D;
      for (int c = (lane & 1) * 8; c < D; c += 16) {
        float x[8], y[8];
        load_f32<8>(o + off + c, x);
        load_f32<8>(dout + off + c, y);
#pragma unroll
        for (int u = 0; u < 8; ++u) d = fmaf(x[u], y[u], d);
      }
    }
    d += __shfl_xor_sync(kFull, d, 1);
    if ((lane & 1) == 0) {
      sDel[wrow + r] = d;
      sLse[wrow + r] = f < n_rows ? lse[rbase + f] : 0.f;
      if (f < n_rows) delta[rbase + f] = d;
    }
  }
  int qp[2];
  bool rv[2];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = row0 + wrow + fr + 8 * h;
    rv[h] = f < n_rows;
    qp[h] = rv[h] ? qpos[f / hpg] : 0;
    if (rv[h]) {
      lo = min(lo, qp[h]);
      hi = max(hi, qp[h]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, off));
    hi = max(hi, __shfl_xor_sync(kFull, hi, off));
  }
  if (lane == 0) {
    sBound[warp] = lo;
    sBound[NW + warp] = hi;
  }
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    qmin = min(qmin, sBound[w]);
    qmax = max(qmax, sBound[NW + w]);
  }
  const int n = tile_list(kpos, Sk, 0, n_tiles, qmin, qmax, causal, window,
                          kp, sList, sCount);
  const float lse_r[2] = {sLse[wrow + fr], sLse[wrow + fr + 8]};
  const float del_r[2] = {sDel[wrow + fr], sDel[wrow + fr + 8]};

  auto load_tile = [&](int entry, int st) {
    const int key0 = (entry >> 1) * kTileK;
    bf16* tk = sK + st * kTileK * RS;
    bf16* tv = sV + st * kTileK * RS;
    for (int e = tid; e < kTileK * CH; e += NT) {
      const int j = e / CH, c = (e % CH) * 8, key = key0 + j;
      const bool ok = key < Sk;
      const size_t off = ((size_t)(b * Sk + (ok ? key : 0)) * G + g) * D + c;
      cp_async16(tk + j * RS + c, k + off, ok ? 16 : 0);
      cp_async16(tv + j * RS + c, v + off, ok ? 16 : 0);
    }
    for (int j = tid; j < kTileK; j += NT) {
      const bool ok = key0 + j < Sk;
      cp_async4(sKp + st * kTileK + j, kpos + (ok ? key0 + j : 0), ok ? 4 : 0);
    }
  };
  // the A fragment of the warp's 16 rows of Q or dO at k-step kk
  auto frag = [&](const bf16* rows, int kk, uint32_t (&a)[4]) {
    ldsm_x4(a, rows + (wrow + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
  };

  uint32_t qf[kRegs ? D / 16 : 1][4], of[kRegs ? D / 16 : 1][4];
  float dqa[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  if (n > 0) load_tile(sList[0], 0);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    const int st = i & 1, entry = sList[i];
    if (i + 1 < n) load_tile(sList[i + 1], st ^ 1);
    cp_async_commit();  // maybe empty: keeps the group count uniform
    cp_async_wait<1>();  // all but the newest group have landed
    __syncthreads();
    if constexpr (kRegs) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          frag(sQ, kk, qf[kk]);
          frag(sdO, kk, of[kk]);
        }
      }
    }
    const bf16* tk = sK + st * kTileK * RS;
    const bf16* tv = sV + st * kTileK * RS;

    // S = Q K^T and dP = dO V^T: K and V rows address as K in attn_fwd_tc
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      if constexpr (kRegs) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          aq[x] = qf[kk][x];
          ao[x] = of[kk][x];
        }
      } else {
        frag(sQ, kk, aq);
        frag(sdO, kk, ao);
      }
#pragma unroll
      for (int nj = 0; nj < NJ / 2; ++nj) {
        const int boff = (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                         kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, tk + boff);
        ldsm_x4(bv, tv + boff);
        mma_bf16(s[2 * nj], aq, bk[0], bk[1]);
        mma_bf16(s[2 * nj + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * nj], ao, bv[0], bv[1]);
        mma_bf16(dp[2 * nj + 1], ao, bv[2], bv[3]);
      }
    }

    // element e of n-tile j is row fr + 8 * (e >> 1), key 8 * j + fc +
    // (e & 1) of the tile; dS = P (dP - D) in place of S
    const bool partial = entry & 1;
    const int key0 = (entry >> 1) * kTileK;
    const int* kps = sKp + st * kTileK;
    uint32_t okb = 0xffffffffu;
    if (partial) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, key = j * 8 + fc + (e & 1);
          const int kq = key0 + key < Sk ? kps[key] : -1;
          const int qq = qp[h];
          const bool ok = rv[h] && kq >= 0 && (!causal || kq <= qq) &&
                          (window <= 0 || kq > qq - window);
          if (!ok) okb &= ~(1u << (4 * j + e));
        }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = (okb >> (4 * j + e)) & 1
                            ? ex2(fmaf(s[j][e], scale_log2, -lse_r[h]))
                            : 0.f;
        s[j][e] = p * (dp[j][e] - del_r[h]);
      }

    // dQ += dS K: dS (rounded to bf16) is the A fragment straight from the
    // accumulators; K through ldmatrix.trans, as V in attn_fwd_tc
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      da[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      da[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      da[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {
        uint32_t bk[4];
        ldsm_x4_t(bk, tk + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               RS + dn * 16 + (lane >> 4) * 8);
        mma_bf16(dqa[2 * dn], da, bk[0], bk[1]);
        mma_bf16(dqa[2 * dn + 1], da, bk[2], bk[3]);
      }
    }
    __syncthreads();  // stage st is free for tile i + 2
  }
  // dQ = scale dS K through shared memory (the Q rows, read by now), so
  // that each row goes out as 16-byte stores of consecutive threads
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* dst = sQ + (wrow + fr + 8 * h) * RS + fc;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(dqa[j][2 * h] * scale,
                                dqa[j][2 * h + 1] * scale);
  }
  __syncthreads();
  for (int e = tid; e < BM * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 8, f = row0 + r;
    if (f >= n_rows) continue;
    const int qi = f / hpg, h = g * hpg + f % hpg;
    *reinterpret_cast<uint4*>(dq + ((size_t)(b * Sq + qi) * H + h) * D + c) =
        *reinterpret_cast<const uint4*>(sQ + r * RS + c);
  }
}

template <int D>
__global__ void __launch_bounds__(BwdCfg<D>::kWarps * 32, 2)
attn_bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int* __restrict__ qpos, const int* __restrict__ kpos,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
             int H, int G, int causal, int window, float scale_log2,
             float scale) {
  using C = BwdCfg<D>;
  constexpr int NW = C::kWarps, BR = C::kRows, RS = C::kStride;
  constexpr int NT = NW * 32, CH = D / 8;  // threads; 16-byte chunks a row
  constexpr int NR = BR / 8, ND = D / 8;   // 8-row n-tiles of S^T; of dK
  constexpr bool kRegs = C::kKvRegs;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [kTileK][RS]
  bf16* sV = sK + kTileK * RS;                   // [kTileK][RS]
  bf16* sQ = sV + kTileK * RS;                   // [2][BR][RS]
  bf16* sdO = sQ + 2 * BR * RS;                  // [2][BR][RS]
  float* sLse = reinterpret_cast<float*>(sdO + 2 * BR * RS);  // [2][BR]
  float* sDel = sLse + 2 * BR;                   // [2][BR]
  int* sQp = reinterpret_cast<int*>(sDel + 2 * BR);  // [2][BR]
  int* sKp = sQp + 2 * BR;                       // [kTileK]
  int* sBound = sKp + kTileK;  // the key warps' min, max and all valid
  int* sCount = sBound + 6;
  int* sList = sCount + 1;            // [row_list_words(n_rows, BR)]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, g = blockIdx.y, key0 = blockIdx.x * kTileK;
  const int hpg = H / G, n_rows = Sq * hpg;
  const size_t rbase = (size_t)(b * G + g) * n_rows;  // lse and D rows

  for (int e = tid; e < kTileK * CH; e += NT) {
    const int j = e / CH, c = (e % CH) * 8, key = key0 + j;
    const bool ok = key < Sk;
    const size_t off = ((size_t)(b * Sk + (ok ? key : 0)) * G + g) * D + c;
    cp_async16(sK + j * RS + c, k + off, ok ? 16 : 0);
    cp_async16(sV + j * RS + c, v + off, ok ? 16 : 0);
  }
  cp_async_commit();
  // the tile's key positions (-1 past Sk) and their bounds over the valid
  // ones, from the two warps that hold one key a lane
  if (warp < kTileK / 32) {
    const int kq = key0 + tid < Sk ? kpos[key0 + tid] : -1;
    sKp[tid] = kq;
    int lo = kq >= 0 ? kq : INT_MAX, hi = kq >= 0 ? kq : INT_MIN;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(kFull, lo, off));
      hi = max(hi, __shfl_xor_sync(kFull, hi, off));
    }
    const bool all = __all_sync(kFull, kq >= 0);
    if (lane == 0) {
      sBound[warp] = lo;
      sBound[2 + warp] = hi;
      sBound[4 + warp] = all;
    }
  }
  __syncthreads();
  const int n = row_list(qpos, n_rows, hpg, BR, min(sBound[0], sBound[1]),
                         max(sBound[2], sBound[3]), sBound[4] && sBound[5],
                         causal, window, sList, sCount);

  // this thread's fragment keys: wrow + fr + 8 * h, h = 0, 1
  const int fr = lane >> 2, fc = (lane & 3) * 2, wrow = warp * 16;
  const int kq[2] = {sKp[wrow + fr], sKp[wrow + fr + 8]};

  auto load_rows = [&](int entry, int st) {
    const int r0 = (entry >> 1) * BR;
    bf16* tq = sQ + st * BR * RS;
    bf16* tdo = sdO + st * BR * RS;
    for (int e = tid; e < BR * CH; e += NT) {
      const int r = e / CH, c = (e % CH) * 8, f = r0 + r;
      const bool ok = f < n_rows;
      const int qi = ok ? f / hpg : 0, h = g * hpg + (ok ? f % hpg : 0);
      const size_t off = ((size_t)(b * Sq + qi) * H + h) * D + c;
      cp_async16(tq + r * RS + c, q + off, ok ? 16 : 0);
      cp_async16(tdo + r * RS + c, dout + off, ok ? 16 : 0);
    }
    for (int r = tid; r < BR; r += NT) {
      const int f = r0 + r;
      const bool ok = f < n_rows;
      cp_async4(sLse + st * BR + r, lse + rbase + (ok ? f : 0), ok ? 4 : 0);
      cp_async4(sDel + st * BR + r, delta + rbase + (ok ? f : 0), ok ? 4 : 0);
      cp_async4(sQp + st * BR + r, qpos + (ok ? f / hpg : 0), ok ? 4 : 0);
    }
  };
  // the A fragment of the warp's 16 keys of K or V at k-step kk
  auto frag = [&](const bf16* keys, int kk, uint32_t (&a)[4]) {
    ldsm_x4(a, keys + (wrow + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
  };

  uint32_t kf[kRegs ? D / 16 : 1][4], vf[kRegs ? D / 16 : 1][4];
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  if (n > 0) load_rows(sList[0], 0);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    const int st = i & 1, entry = sList[i];
    if (i + 1 < n) load_rows(sList[i + 1], st ^ 1);
    cp_async_commit();  // maybe empty: keeps the group count uniform
    cp_async_wait<1>();  // all but the newest group (K and V too) landed
    __syncthreads();
    if constexpr (kRegs) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          frag(sK, kk, kf[kk]);
          frag(sV, kk, vf[kk]);
        }
      }
    }
    const bf16* tq = sQ + st * BR * RS;
    const bf16* tdo = sdO + st * BR * RS;
    const float* tl = sLse + st * BR;
    const float* td = sDel + st * BR;
    const int* tp = sQp + st * BR;

    // S^T = K Q^T and dP^T = V dO^T: Q and dO rows address as K in
    // attn_fwd_tc
    float s[NR][4], dp[NR][4];
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      if constexpr (kRegs) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          ak[x] = kf[kk][x];
          av[x] = vf[kk][x];
        }
      } else {
        frag(sK, kk, ak);
        frag(sV, kk, av);
      }
#pragma unroll
      for (int nj = 0; nj < NR / 2; ++nj) {
        const int boff = (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                         kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, tq + boff);
        ldsm_x4(bo, tdo + boff);
        mma_bf16(s[2 * nj], ak, bq[0], bq[1]);
        mma_bf16(s[2 * nj + 1], ak, bq[2], bq[3]);
        mma_bf16(dp[2 * nj], av, bo[0], bo[1]);
        mma_bf16(dp[2 * nj + 1], av, bo[2], bo[3]);
      }
    }

    // element e of n-tile j is key fr + 8 * (e >> 1) of the warp, row
    // 8 * j + fc + (e & 1) of the step: P^T in place of S^T, dS^T in place
    // of dP^T
    const bool partial = entry & 1;
    const int r0 = (entry >> 1) * BR;
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + fc + (e & 1), kp = kq[e >> 1];
        bool ok = true;
        if (partial) {
          const int qq = tp[r];
          ok = r0 + r < n_rows && kp >= 0 && (!causal || kp <= qq) &&
               (window <= 0 || kp > qq - window);
        }
        const float p = ok ? ex2(fmaf(s[j][e], scale_log2, -tl[r])) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - td[r]);
      }

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T (rounded to bf16) are A
    // fragments straight from the accumulators; dO and Q through
    // ldmatrix.trans, as V in attn_fwd_tc
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {
        const int toff = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                         dn * 16 + (lane >> 4) * 8;
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, tdo + toff);
        ldsm_x4_t(bq, tq + toff);
        mma_bf16(dva[2 * dn], pa, bo[0], bo[1]);
        mma_bf16(dva[2 * dn + 1], pa, bo[2], bo[3]);
        mma_bf16(dka[2 * dn], da, bq[0], bq[1]);
        mma_bf16(dka[2 * dn + 1], da, bq[2], bq[3]);
      }
    }
    __syncthreads();  // stage st is free for step i + 2
  }
  // dK = scale dS^T Q and dV through shared memory (the K and V rows, read
  // by now), so that each key's row goes out as 16-byte stores
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* tk = sK + (wrow + fr + 8 * h) * RS + fc;
    bf16* tv = sV + (wrow + fr + 8 * h) * RS + fc;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(tk + 8 * j) = __floats2bfloat162_rn(
          dka[j][2 * h] * scale, dka[j][2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(tv + 8 * j) =
          __floats2bfloat162_rn(dva[j][2 * h], dva[j][2 * h + 1]);
    }
  }
  __syncthreads();
  for (int e = tid; e < kTileK * CH; e += NT) {
    const int j = e / CH, c = (e % CH) * 8, key = key0 + j;
    if (key >= Sk) continue;
    const size_t off = ((size_t)(b * Sk + key) * G + g) * D + c;
    *reinterpret_cast<uint4*>(dk + off) =
        *reinterpret_cast<const uint4*>(sK + j * RS + c);
    *reinterpret_cast<uint4*>(dv + off) =
        *reinterpret_cast<const uint4*>(sV + j * RS + c);
  }
}

struct BwdArgs {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;
  const int *qpos, *kpos;
  bf16 *dq, *dk, *dv;
  float* delta;
  int B, Sq, Sk, H, G, causal, window;
  float scale;
};

template <int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  using C = BwdCfg<D>;
  static size_t granted_dq = 48 << 10, granted_dkv = 48 << 10;
  const long long rows = (long long)a.Sq * (a.H / a.G);
  if (rows > INT_MAX - 64) return cudaErrorInvalidValue;
  const int n_tiles = (a.Sk + kTileK - 1) / kTileK;
  const size_t smem_dq = C::kDqSmem + sizeof(int) * 2 * n_tiles;
  const size_t smem_dkv =
      C::kDkvSmem + sizeof(int) * row_list_words((int)rows, C::kRows);
  cudaError_t err = allow_smem(attn_bwd_dq<D>, smem_dq, &granted_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dkv<D>, smem_dkv, &granted_dkv);
  if (err != cudaSuccess) return err;
  const float scale_log2 = a.scale * kLog2e;  // as the forward's
  const dim3 grid_dq((unsigned)((rows + C::kQRows - 1) / C::kQRows), a.G,
                     a.B);
  attn_bwd_dq<D><<<grid_dq, C::kWarps * 32, smem_dq, stream>>>(
      a.q, a.k, a.v, a.o, a.dout, a.lse, a.qpos, a.kpos, a.dq, a.delta, a.Sq,
      a.Sk, a.H, a.G, a.causal, a.window, scale_log2, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkv<D><<<dim3(n_tiles, a.G, a.B), C::kWarps * 32, smem_dkv,
                    stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.qpos,
                              a.kpos, a.dk, a.dv, a.Sq, a.Sk, a.H, a.G,
                              a.causal, a.window, scale_log2, a.scale);
  return cudaGetLastError();
}

cudaError_t dispatch_bwd(int D, const BwdArgs& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch_bwd<16>(a, s);
    case 32: return launch_bwd<32>(a, s);
    case 64: return launch_bwd<64>(a, s);
    case 128: return launch_bwd<128>(a, s);
    case 160: return launch_bwd<160>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. variant: 0 = attn_fwd (any dtype and
// Sq), 1 = attn_fwd_tc (bfloat16), 2 = attn_decode_split + merge (Sq == 1;
// scratch holds (2 + D) * B * H * n_split floats). lse: null, or (variant 1
// only) B * Sq * H floats for each row's log-sum-exp (attn_fwd_tc's kLse).
// Returns a cudaError_t (0 = launched).
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              const void* qpos, const void* kpos, void* o,
                              void* lse, int B, int Sq, int Sk, int H, int G,
                              int D, int causal, int window, float scale,
                              int dtype, int variant, int n_split,
                              void* scratch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || Sq < 1 || Sk < 1 || G < 1 || H % G != 0 || dtype < 0 ||
      dtype > 1 || (lse != nullptr && variant != 1))
    return (int)cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      if (dtype == 0)
        return (int)dispatch_d<float>(D, q, k, v, qp, kp, o, B, Sq, Sk, H, G,
                                      causal, window, scale, s);
      return (int)dispatch_d<bf16>(D, q, k, v, qp, kp, o, B, Sq, Sk, H, G,
                                   causal, window, scale, s);
    case 1:
      if (dtype != 1) return (int)cudaErrorInvalidValue;
      return (int)dispatch_tc(D, q, k, v, qp, kp, o, static_cast<float*>(lse),
                              B, Sq, Sk, H, G, causal, window, scale, s);
    case 2: {
      if (Sq != 1 || n_split < 1 || scratch == nullptr)
        return (int)cudaErrorInvalidValue;
      float* part = static_cast<float*>(scratch);
      if (dtype == 0)
        return (int)dispatch_split<float>(D, q, k, v, qp, kp, o, B, Sk, H, G,
                                          causal, window, scale, n_split,
                                          part, nullptr, s);
      return (int)dispatch_split<bf16>(D, q, k, v, qp, kp, o, B, Sk, H, G,
                                       causal, window, scale, n_split, part,
                                       nullptr, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Decode in two steps, for a cache split over ranks (each rank runs the
// first on its slots, the ranks exchange the partials, each runs the
// second). The packed partial of a row (b * H + h) is 2 + D f32: m, the max
// score over the valid keys (NEG_INF if none), l = sum e^(s - m) over them
// and acc[D] = sum e^(s - m) v, unnormalised.
//
// repro_flash_decode_partials: q (B, 1, H, D), k/v (B, Sk, G, D) as in
// repro_flash_attention_fwd variant 2 (scratch of (2 + D) * B * H *
// n_split floats), out_part (B * H, 2 + D) f32: the split kernel, then the
// merge of its n_split ranges into one partial a row.
int repro_flash_decode_partials(const void* q, const void* k, const void* v,
                                const void* qpos, const void* kpos,
                                void* out_part, int B, int Sk, int H, int G,
                                int D, int causal, int window, float scale,
                                int dtype, int n_split, void* scratch,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || Sk < 1 || G < 1 || H % G != 0 || n_split < 1 ||
      scratch == nullptr || out_part == nullptr || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  float* out = static_cast<float*>(out_part);
  if (dtype == 0)
    return (int)dispatch_split<float>(D, q, k, v, qp, kp, nullptr, B, Sk, H,
                                      G, causal, window, scale, n_split, part,
                                      out, s);
  return (int)dispatch_split<bf16>(D, q, k, v, qp, kp, nullptr, B, Sk, H, G,
                                   causal, window, scale, n_split, part, out,
                                   s);
}

// repro_flash_decode_merge: part (P, rows, 2 + D) f32, P partials a row
// (one a rank, in rank order) -> o (rows, D) in dtype.
int repro_flash_decode_merge(const void* part, void* o, int rows, int P,
                             int D, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || P < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_merge<float>(D, p, o, rows, P, s);
  return (int)dispatch_merge<bf16>(D, p, o, rows, P, s);
}

// The backward of repro_flash_attention_fwd's variant 1 (bfloat16): q, o,
// dout and dq (B, Sq, H, D); k, v, dk and dv (B, Sk, G, D); lse the
// forward's (B * Sq * H floats); delta scratch of as many floats, written
// here (each row's D). Launches attn_bwd_dq, then attn_bwd_dkv. Returns a
// cudaError_t (0 = launched).
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, const void* qpos,
                              const void* kpos, void* dq, void* dk, void* dv,
                              void* delta, int B, int Sq, int Sk, int H,
                              int G, int D, int causal, int window,
                              float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || Sq < 1 || Sk < 1 || G < 1 || H % G != 0 || lse == nullptr ||
      delta == nullptr)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.qpos = static_cast<const int*>(qpos);
  a.kpos = static_cast<const int*>(kpos);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.delta = static_cast<float*>(delta);
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.G = G;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return (int)dispatch_bwd(D, a, static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
