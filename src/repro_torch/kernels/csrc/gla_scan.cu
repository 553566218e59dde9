// Chunked gated-linear-attention (GLA) scan for Hopper (sm_90a), f32 and
// bf16.
//
// Replaces repro/kernels/gla_scan.py::_gla_kernel (the Pallas TPU kernel,
// wrapped by gla_pallas) and computes what repro/models/recurrence.py::
// gla_chunked computes, initial_state included. Per (batch, head) with K key
// and V value channels and an f32 state S (K x V):
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t
//   y_t = r_t (diag(u) k_t^T v_t + S_{t-1})        (u absent: u = 1)
// in chunks of C = 32 steps, with cw the inclusive cumulative sum of logw
// down each key channel inside the chunk and cwp the exclusive one:
//   y_t  = (r_t * e^{cwp_t}) S + sum_{j<t} A[t,j] v_j + (r_t . u . k_t) v_t
//   A[t,j] = sum_k r_tk k_jk e^{min(cwp_tk - cw_jk, 0)}
//   S'   = S * e^{cw_last} + sum_j (k_j * e^{cw_last - cw_j})^T v_j
// The pairwise exponent is kept in that form, never split into
// e^{cw_t} e^{-cw_j}: RWKV6's decay reaches -403 a step, so a chunk's cw can
// reach ~-13,000 and e^{-cw} would overflow f32. Every exponent taken here
// is <= 0, given the precondition logw <= 0 (both models produce it by
// construction: RWKV6's -exp(.), hymba's dt * -exp(a_log)); the min guards
// rounding. cwp_t is taken as the running sum before step t, the very
// number stored as cw_{t-1}, not as cw_t - logw_t (the reference's form):
// the adjacent pair's exponent is then exactly 0, where the difference
// carries the rounding error of |cw| (~1e-3 at |cw| ~ 1e4, which puts y off
// by ~6e-3 at K = 64).
//
// Layout: r, k, logw (B, T, H, K), v and y (B, T, H, V), contiguous, read
// and written in the model's layout (no transposes on the host); u (H, K)
// f32 or null; initial state (B, H, K, V) f32 or null (zeros); final state
// (B, H, K, V) f32. r/k/v/y are all f32 or all bf16; logw is f32. K, V in
// {8, 16, 32, 64}; any T >= 1: rows of a ragged last chunk read as r = k =
// v = logw = 0, which leaves the state as it is and writes no y.
//
// What bounds it on the H100: at the serving shapes the bytes (rwkv6 B=8,
// T=512, H=64, K=V=64 in bf16: r, k, v, y 33.5 MB each, logw 67 MB, the
// state 8.4 MB, ~210 MB or ~63 us at 3.35 TB/s; hymba T=2048, H=25, K=16,
// V=64: ~158 MB or ~47 us) dwarf the useful arithmetic (~5 GFLOP, ~5 us at
// the bf16 tensor-core peak). But the chunked form also takes exponentials
// for its factors and, taken per element, C(C-1)/2 * K a chunk for the
// pairs: in the first design ~290 M at rwkv6's shape, ~80 us of the card's
// special-function units alone (16 a clock an SM). Each input element is
// read from device memory once and y written once; the state never leaves
// the block between chunks. Two kernels behind one C entry point; the
// wrapper picks one by dtype (repro_torch/kernels/gla_scan.py::
// choose_variant):
//
// * gla_fwd_tc (bf16; "tc"). One block of 8 warps per (b, h). (A block
//   per slice of V was measured and lost at every shape: a slice repeats
//   the scan and A, and the product warps already split V.)
//   Loads: r, k, v as bf16 and logw as f32, by cp.async (16 bytes a
//   thread) into a ring of three stages, two chunks ahead (a bulk copy a
//   row, counted on an mbarrier, was slower). Per chunk c, two barriers:
//   1. scan (warps 4-7, beside the products of chunk c - 1 on warps 0-3):
//      lane = row, K/4 key channels a warp; an inclusive __shfl_up_sync
//      scan gives cw, and cwp = shfl_up(cw, 1) (0 at lane 0), so the
//      adjacent exponent is exactly 0. All in the log2 domain (logw *
//      log2 e, then ex2.approx). The lane writes the bf16 operands
//      r e^{cwp}, k e^{cw_last - cw} and the factors r e^{cwp - b},
//      k e^{b - cw} at b = cw_15, and its share of r.u.k (u = 1 absent).
//   2. A by factors on the tensor cores: A[t,j] = sum_k (r_tk e^{cwp_tk -
//      b_k}) (k_jk e^{b_k - cw_jk}). Where t >= 16 > j both exponents
//      are <= 0 (cw does not increase), so an underflowed factor means an
//      underflowed product. Inside a sub-chunk of 16 rows the exponents
//      are bounded by the sub-chunk's decay; while that spans at most
//      2^64 in every channel (kWide; a decay of ~e^2.8 a step) the
//      factors stay far inside bf16's range and the block is a product
//      too, masked to j < t, its diagonal r_t.u.k_t. A sub-chunk that
//      decays faster (RWKV6's decay reaches e^403 a step) takes its 120
//      pairs per element instead, one a thread, between the barriers
//      (flags from the scan, the same in every thread).
//   3. products (mma.sync m16n8k16, bf16 operands, f32 accumulators):
//      y = (r e^{cwp}) S + A V and S' = S e^{cw_last} + (k e^{cw_last -
//      cw})^T V. Each product warp owns 16 value columns: it keeps its
//      slice of S, transposed (16 x K), in f32 accumulator fragments
//      across all chunks, and those fragments are, rounded to bf16, the B
//      operand of (r e^{cwp}) S as they stand (no trip through shared
//      memory). Only that operand copy of S is rounded. y leaves from the
//      accumulators.
//   So the exponentials fall from C(C-1)/2 * K + 2 C K a chunk to 4 C K
//   (at K = 64: from 35,840 to 8,192), all the arithmetic of the pairs
//   goes to the tensor cores, and the scan of chunk c + 1 overlaps the
//   products of chunk c. K < 16 and V < 16 are padded with zeros.
// * gla_fwd (f32 and bf16; "simt"): the first design, f32 on CUDA cores,
//   kept because f32 on the tensor cores would be TF32. One block of 256
//   threads per (b, h), looping over the chunks in order. Per chunk: load
//   the tiles as f32 into shared memory; K threads take the cumulative
//   sums; then the C(C-1)/2 = 496 strictly-lower (t, j) pairs of A (two a
//   thread), r * e^{cwp}, k * e^{cw_last - cw} and the diagonal term; then
//   each thread computes y for one value column and V/8 rows; then each
//   thread updates the state entries of its column. Limited by
//   instruction issue and the exponentials rather than by the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;                              // C
constexpr int kPairs = kChunk * (kChunk - 1) / 2;       // strictly lower
constexpr int kPairsPerThread = (kPairs + kThreads - 1) / kThreads;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

// Shared-memory tiles, in floats. Arrays read by lanes of one warp at
// different rows (the pair loop) have rows padded to K + 1, so that the
// rows fall in different banks.
template <int K, int V>
struct Smem {
  static constexpr int KP = K + 1;
  static constexpr int R = 0;                    // r          C x KP
  static constexpr int KK = R + kChunk * KP;     // k          C x KP
  static constexpr int CW = KK + kChunk * KP;    // cw         C x KP
  static constexpr int CWP = CW + kChunk * KP;   // logw, cwp  C x KP
  static constexpr int RQ = CWP + kChunk * KP;   // r e^{cwp}  C x K
  static constexpr int KS = RQ + kChunk * K;     // k e^{..}   C x K
  static constexpr int VV = KS + kChunk * K;     // v          C x V
  static constexpr int A = VV + kChunk * V;      // A          C x C
  static constexpr int S = A + kChunk * kChunk;  // state      K x V
  static constexpr int DU = S + K * V;           // diagonal   C
  static constexpr int U = DU + kChunk;          // u          K
  static constexpr int WL = U + K;               // cw_last    K
  static constexpr int TOTAL = WL + K;
  static constexpr size_t BYTES = sizeof(float) * TOTAL;
};

template <typename T, int K, int V>
__global__ void __launch_bounds__(kThreads)
gla_fwd(const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ logw,
        const float* __restrict__ u, const float* __restrict__ s0,
        T* __restrict__ y, float* __restrict__ s_out, int Tlen, int H) {
  using L = Smem<K, V>;
  constexpr int KP = L::KP;
  constexpr int RSTEP = kThreads / V;                  // rows between a
  constexpr int RPT = kChunk / RSTEP;                  // thread's y rows
  constexpr int KSTEP = kThreads / V;                  // and state rows
  constexpr int KPT = (K + KSTEP - 1) / KSTEP;
  static_assert(kThreads % V == 0 && kChunk % RSTEP == 0, "tiling");

  extern __shared__ __align__(16) float smem[];
  float* sR = smem + L::R;
  float* sK = smem + L::KK;
  float* sCw = smem + L::CW;
  float* sCwp = smem + L::CWP;
  float* sRq = smem + L::RQ;
  float* sKs = smem + L::KS;
  float* sV = smem + L::VV;
  float* sA = smem + L::A;
  float* sS = smem + L::S;
  float* sDu = smem + L::DU;
  float* sU = smem + L::U;
  float* sWl = smem + L::WL;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int col = tid % V;          // this thread's value column
  const int row0 = tid / V;         // its first y row / state row

  // the strictly-lower pairs (t, j), j < t, this thread computes
  int pt[kPairsPerThread], pj[kPairsPerThread];
#pragma unroll
  for (int i = 0; i < kPairsPerThread; ++i) {
    int p = tid + i * kThreads, t = 1;
    if (p < kPairs) {
      while ((t + 1) * t / 2 <= p) ++t;   // t(t-1)/2 <= p < t(t+1)/2
      pt[i] = t;
      pj[i] = p - t * (t - 1) / 2;
    } else {
      pt[i] = -1;
      pj[i] = 0;
    }
  }

  const size_t bh = (size_t)b * H + h;
  for (int e = tid; e < K * V; e += kThreads)
    sS[e] = s0 ? s0[bh * K * V + e] : 0.f;
  for (int e = tid; e < kChunk * kChunk; e += kThreads) sA[e] = 0.f;
  for (int e = tid; e < K; e += kThreads) sU[e] = u ? u[(size_t)h * K + e] : 1.f;

  for (int t0 = 0; t0 < Tlen; t0 += kChunk) {
    const int n = min(kChunk, Tlen - t0);   // valid rows of this chunk
    __syncthreads();  // the previous chunk is done with every tile
    for (int e = tid; e < kChunk * K; e += kThreads) {
      const int t = e / K, c = e % K;
      float rr = 0.f, kk = 0.f, ww = 0.f;
      if (t < n) {
        const size_t off = (((size_t)b * Tlen + t0 + t) * H + h) * K + c;
        rr = load(r + off);
        kk = load(k + off);
        ww = logw[off];
      }
      sR[t * KP + c] = rr;
      sK[t * KP + c] = kk;
      sCwp[t * KP + c] = ww;
    }
    for (int e = tid; e < kChunk * V; e += kThreads) {
      const int t = e / V, c = e % V;
      sV[e] = t < n ? load(v + (((size_t)b * Tlen + t0 + t) * H + h) * V + c)
                    : 0.f;
    }
    __syncthreads();

    // cumulative sums down each key channel: cwp before step t, cw after
    if (tid < K) {
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        const float w = sCwp[t * KP + tid];
        sCwp[t * KP + tid] = acc;
        acc += w;
        sCw[t * KP + tid] = acc;
      }
      sWl[tid] = acc;
    }
    __syncthreads();

    // intra-chunk pair weights A[t, j], j < t
#pragma unroll
    for (int i = 0; i < kPairsPerThread; ++i) {
      if (pt[i] < 0) continue;
      const float* rt = sR + pt[i] * KP;
      const float* wt = sCwp + pt[i] * KP;
      const float* kj = sK + pj[i] * KP;
      const float* cj = sCw + pj[i] * KP;
      float a = 0.f;
#pragma unroll 8
      for (int c = 0; c < K; ++c)
        a = fmaf(rt[c] * expf(fminf(wt[c] - cj[c], 0.f)), kj[c], a);
      sA[pt[i] * kChunk + pj[i]] = a;
    }
    // r * e^{cwp} (inter-chunk) and k * e^{cw_last - cw} (state update)
    for (int e = tid; e < kChunk * K; e += kThreads) {
      const int t = e / K, c = e % K;
      sRq[e] = sR[t * KP + c] * expf(sCwp[t * KP + c]);
      sKs[e] = sK[t * KP + c] * expf(sWl[c] - sCw[t * KP + c]);
    }
    // diagonal term r_t . u . k_t
    if (tid < kChunk) {
      float d = 0.f;
      for (int c = 0; c < K; ++c)
        d = fmaf(sR[tid * KP + c] * sU[c], sK[tid * KP + c], d);
      sDu[tid] = d;
    }
    __syncthreads();

    // y for column `col`, rows row0 + i * RSTEP
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < K; ++c) {
      const float s = sS[c * V + col];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = fmaf(sRq[(row0 + i * RSTEP) * K + c], s, acc[i]);
    }
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const float vj = sV[j * V + col];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = fmaf(sA[(row0 + i * RSTEP) * kChunk + j], vj, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = row0 + i * RSTEP;
      if (t < n) {
        const float out = fmaf(sDu[t], sV[t * V + col], acc[i]);
        store(y + (((size_t)b * Tlen + t0 + t) * H + h) * V + col, out);
      }
    }
    __syncthreads();  // every y has read the old state

    // state update for column `col`, rows row0 + i * KSTEP
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int c = row0 + i * KSTEP;
      if (c >= K) break;
      float s = 0.f;
#pragma unroll 4
      for (int j = 0; j < kChunk; ++j)
        s = fmaf(sKs[j * K + c], sV[j * V + col], s);
      sS[c * V + col] = fmaf(sS[c * V + col], expf(sWl[c]), s);
    }
  }
  __syncthreads();
  for (int e = tid; e < K * V; e += kThreads) s_out[bh * K * V + e] = sS[e];
}

template <typename T, int K, int V>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, const float* s0,
                   void* y, float* s_out, int B, int Tlen, int H,
                   cudaStream_t stream) {
  constexpr size_t smem = Smem<K, V>::BYTES;
  static bool configured = false;  // once per instantiation and process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gla_fwd<T, K, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(H, B);
  gla_fwd<T, K, V><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, static_cast<T*>(y), s_out, Tlen,
      H);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t dispatch_v(int V, const void* r, const void* k, const void* v,
                       const float* logw, const float* u, const float* s0,
                       void* y, float* s_out, int B, int Tlen, int H,
                       cudaStream_t s) {
  switch (V) {
    case 8: return launch<T, K, 8>(r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    case 16: return launch<T, K, 16>(r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    case 32: return launch<T, K, 32>(r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    case 64: return launch<T, K, 64>(r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_k(int K, int V, const void* r, const void* k,
                       const void* v, const float* logw, const float* u,
                       const float* s0, void* y, float* s_out, int B,
                       int Tlen, int H, cudaStream_t s) {
  switch (K) {
    case 8: return dispatch_v<T, 8>(V, r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    case 16: return dispatch_v<T, 16>(V, r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    case 32: return dispatch_v<T, 32>(V, r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    case 64: return dispatch_v<T, 64>(V, r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// gla_fwd_tc: bf16, the products on the tensor cores, a block per (b, h,
// slice of V).

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kScanWarps = 4;                           // the last four
// the factors' exponents (log2) stay within +-kWide: 2^64 ~ 1.8e19, far
// inside bf16's range, and a factor k 2^-64 stays normal down to |k| ~
// 1e-18; a sub-chunk whose decay spans more takes its pairs per element
constexpr float kWide = 64.f;
constexpr int kSub = 16;                                // sub-chunk rows
constexpr int kSubPairs = kSub * (kSub - 1) / 2;        // 120 a sub-chunk
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(2 * kSubPairs + kChunk / 2 == kTcThreads,
              "a thread per pair, a thread per two diagonal entries");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
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

// 2^x in one MUFU instruction (relative error ~2^-22; 0 far below -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// N consecutive values of shared memory in one load or store (N = 2, 4, 8)
template <int N>
__device__ __forceinline__ void lds(const bf16* p, float (&d)[N]) {
  static_assert(N == 2 || N == 4 || N == 8, "2, 4 or 8 values");
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    d[2 * i] = f.x;
    d[2 * i + 1] = f.y;
  }
}

template <int N>
__device__ __forceinline__ void sts(bf16* p, const float (&x)[N]) {
  static_assert(N == 2 || N == 4 || N == 8, "2, 4 or 8 values");
  uint32_t w[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) w[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float (&d)[N]) {
  static_assert(N == 2 || N % 4 == 0, "2 or a multiple of 4 values");
  if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    d[0] = x.x; d[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      d[i] = x.x; d[i + 1] = x.y; d[i + 2] = x.z; d[i + 3] = x.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void sts(float* p, const float (&x)[N]) {
  static_assert(N == 2 || N % 4 == 0, "2 or a multiple of 4 values");
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  }
}

// Shared memory of gla_fwd_tc, in bytes. Rows are padded by 16 bytes, so
// that 8 lanes reading 8 rows at one column (the scan, the pairs, ldmatrix)
// hit 8 different bank groups. Chunk c's operands are written by the scan
// while chunk c - 1's products read theirs, so they alternate in two
// buffers; a stage of the load ring is read until chunk c's products, two
// phases after the loads of chunk c + 2 are issued, so the ring has three.
template <int K, int V>
struct TcLayout {
  static constexpr int KP = K < 16 ? 16 : K;     // key channels, padded
  static constexpr int VP = V < 16 ? 16 : V;     // value columns, padded
  static constexpr int RK = KP + 8;              // bf16 row: r, k, operands
  static constexpr int RW = KP + 4;              // f32 row: logw, then cw
  static constexpr int RV = VP + 8;              // bf16 row: v
  static constexpr int RA = kChunk + 8;          // bf16 row: A
  static constexpr int kStages = 3;
  // a stage of the load ring: r, k, v (bf16) and logw (f32), C rows each
  static constexpr int ST_R = 0;
  static constexpr int ST_K = ST_R + 2 * kChunk * RK;
  static constexpr int ST_V = ST_K + 2 * kChunk * RK;
  static constexpr int ST_W = ST_V + 2 * kChunk * RV;
  static constexpr int STAGE = ST_W + 4 * kChunk * RW;
  // a chunk's operands, two buffers: r e^{cwp}, k e^{cw_last - cw}, the
  // factors r e^{cwp - b} and k e^{b - cw} at b = cw_15, e^{cw_last}, r.u.k
  // by scan warp, and each scan warp's flags of the sub-chunks whose
  // factors would leave the safe range
  static constexpr int OP_RQ = 0;
  static constexpr int OP_KS = OP_RQ + 2 * kChunk * RK;
  static constexpr int OP_Q = OP_KS + 2 * kChunk * RK;
  static constexpr int OP_K = OP_Q + 2 * kChunk * RK;
  static constexpr int OP_DEC = OP_K + 2 * kChunk * RK;
  static constexpr int OP_DU = OP_DEC + 4 * KP;
  static constexpr int OP_FLAG = OP_DU + 4 * kScanWarps * kChunk;
  static constexpr int OPS = OP_FLAG + 16;
  static constexpr int OP0 = kStages * STAGE;
  static constexpr int AA = OP0 + 2 * OPS;       // A of an unsafe sub-chunk
  static constexpr size_t BYTES = AA + 2 * kChunk * RA;
  static_assert(STAGE % 16 == 0 && OPS % 16 == 0 && OP0 % 16 == 0 &&
                    AA % 16 == 0,
                "16-byte aligned parts");
};

template <int K, int V>
__global__ void __launch_bounds__(kTcThreads, 2)
gla_fwd_tc(const bf16* __restrict__ r, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ s0,
           bf16* __restrict__ y, float* __restrict__ s_out, int Tlen,
           int H) {
  using L = TcLayout<K, V>;
  constexpr int KP = L::KP, RK = L::RK, RW = L::RW, RV = L::RV, RA = L::RA;
  constexpr int CPW = KP / kScanWarps;  // key channels a scan warp takes
  constexpr int GRP = CPW < 8 ? CPW : 8;  // of them at a time
  constexpr int NPW = L::VP / 16;      // product warps, 16 columns each
  constexpr int NKT = KP / 8;          // 8-channel n-tiles of the state
  constexpr int KCH = K / 8, WCH = K / 4, VCH = V / 8;  // 16-byte pieces
  static_assert(NPW <= kTcWarps - kScanWarps, "product and scan warps");

  extern __shared__ __align__(16) unsigned char tsm[];
  bf16* sA = reinterpret_cast<bf16*>(tsm + L::AA);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const int n_chunks = (Tlen + kChunk - 1) / kChunk;
  // fragment coordinates: rows fr, fr + 8; columns fc, fc + 1
  const int fr = lane >> 2, fc = (lane & 3) * 2;

  // zeros everywhere once: the padding and A's upper triangle stay zero
  for (int e = tid; e < (int)(L::BYTES / 16); e += kTcThreads)
    reinterpret_cast<uint4*>(tsm)[e] = make_uint4(0, 0, 0, 0);

  // this thread's pair (t, j), j < t, inside sub-chunk tid / 120 (chunk
  // rows), or the two diagonal entries it sums
  int pt = -1, pj = 0;
  if (tid < 2 * kSubPairs) {
    const int q = tid % kSubPairs, base = (tid / kSubPairs) * kSub;
    int t = 1;
    while ((t + 1) * t / 2 <= q) ++t;   // t(t-1)/2 <= q < t(t+1)/2
    pt = base + t;
    pj = base + q - t * (t - 1) / 2;
  }

  // a scan warp's channels c0 .. c0 + CPW and their u
  const int sw = warp - (kTcWarps - kScanWarps), c0 = sw * CPW;
  float uu[CPW];
#pragma unroll
  for (int i = 0; i < CPW; ++i)
    uu[i] = sw < 0 || c0 + i >= K ? 0.f
                                  : (u ? u[(size_t)h * K + c0 + i] : 1.f);

  // a product warp's slice of S, transposed: st[n][.] holds S^T[v][c] for
  // v = 16 warp + fr (+8 in [2], [3]) and c = 8 n + fc (+1)
  const int vw = 16 * warp;
  float st[NKT][4];
#pragma unroll
  for (int n = 0; n < NKT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int vv = vw + fr + 8 * (e >> 1), c = 8 * n + fc + (e & 1);
      st[n][e] = s0 && warp < NPW && vv < V && c < K
                     ? s0[(bh * K + c) * V + vv]
                     : 0.f;
    }
  __syncthreads();  // the zeros are written before any copy lands

  auto stage_of = [&](int ci) { return tsm + (ci % L::kStages) * L::STAGE; };
  auto ops_of = [&](int ci) { return tsm + L::OP0 + (ci & 1) * L::OPS; };

  auto load_chunk = [&](int ci) {
    unsigned char* base = stage_of(ci);
    bf16* dr = reinterpret_cast<bf16*>(base + L::ST_R);
    bf16* dk = reinterpret_cast<bf16*>(base + L::ST_K);
    bf16* dv = reinterpret_cast<bf16*>(base + L::ST_V);
    float* dw = reinterpret_cast<float*>(base + L::ST_W);
    const int t0 = ci * kChunk, n = min(kChunk, Tlen - t0);
    for (int e = tid; e < kChunk * KCH; e += kTcThreads) {
      const int t = e / KCH, x = (e % KCH) * 8;
      const bool ok = t < n;
      const size_t off =
          (((size_t)b * Tlen + t0 + (ok ? t : 0)) * H + h) * K + x;
      cp_async16(dr + t * RK + x, r + off, ok ? 16 : 0);
      cp_async16(dk + t * RK + x, k + off, ok ? 16 : 0);
    }
    for (int e = tid; e < kChunk * WCH; e += kTcThreads) {
      const int t = e / WCH, x = (e % WCH) * 4;
      const bool ok = t < n;
      cp_async16(dw + t * RW + x,
                 logw + (((size_t)b * Tlen + t0 + (ok ? t : 0)) * H + h) * K +
                     x,
                 ok ? 16 : 0);
    }
    for (int e = tid; e < kChunk * VCH; e += kTcThreads) {
      const int t = e / VCH, x = (e % VCH) * 8;
      const bool ok = t < n;
      cp_async16(dv + t * RV + x,
                 v + (((size_t)b * Tlen + t0 + (ok ? t : 0)) * H + h) * V +
                     x,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  // the scan of chunk ci, by the scan warps: lane = row, channels c0 ..
  // c0 + CPW in groups of GRP, in the log2 domain
  auto scan = [&](int ci) {
    unsigned char* base = stage_of(ci);
    const bf16* sR = reinterpret_cast<const bf16*>(base + L::ST_R);
    const bf16* sK = reinterpret_cast<const bf16*>(base + L::ST_K);
    float* sW = reinterpret_cast<float*>(base + L::ST_W);
    unsigned char* ops = ops_of(ci);
    bf16* sRq = reinterpret_cast<bf16*>(ops + L::OP_RQ);
    bf16* sKs = reinterpret_cast<bf16*>(ops + L::OP_KS);
    bf16* sQ = reinterpret_cast<bf16*>(ops + L::OP_Q);
    bf16* sKf = reinterpret_cast<bf16*>(ops + L::OP_K);
    float* sDec = reinterpret_cast<float*>(ops + L::OP_DEC);
    float du = 0.f;
    bool wide0 = false, wide1 = false;
#pragma unroll
    for (int g = 0; g < CPW; g += GRP) {
      const int cg = c0 + g;
      float cw[GRP], rr[GRP], kk[GRP];
      lds<GRP>(sW + lane * RW + cg, cw);
      lds<GRP>(sR + lane * RK + cg, rr);
      lds<GRP>(sK + lane * RK + cg, kk);
#pragma unroll
      for (int i = 0; i < GRP; ++i) cw[i] *= kLog2e;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
#pragma unroll
        for (int i = 0; i < GRP; ++i) {
          const float x = __shfl_up_sync(kFull, cw[i], off);
          if (lane >= off) cw[i] += x;
        }
      float rq[GRP], ks[GRP], qf[GRP], kf[GRP];
#pragma unroll
      for (int i = 0; i < GRP; ++i) {
        const float prev = __shfl_up_sync(kFull, cw[i], 1);
        const float cwp = lane == 0 ? 0.f : prev;      // cw_{t-1} itself
        const float last = __shfl_sync(kFull, cw[i], 31);
        const float ref = __shfl_sync(kFull, cw[i], kSub - 1);
        rq[i] = rr[i] * ex2(cwp);
        ks[i] = kk[i] * ex2(last - cw[i]);
        // <= 0 where they meet across the sub-chunks (rows >= 16 of the
        // r factor, rows < 16 of the k one; the clamp at 0 only acts on a
        // decay that breaks logw <= 0, as gla_fwd's does); <= kWide inside
        // a safe sub-chunk (that clamp only keeps an unsafe one finite)
        qf[i] = rr[i] * ex2(fminf(cwp - ref, lane >= kSub ? 0.f : kWide));
        kf[i] = kk[i] * ex2(fminf(ref - cw[i], lane < kSub ? 0.f : kWide));
        du = fmaf(rr[i] * uu[g + i], kk[i], du);
        wide0 |= -ref > kWide;          // sub-chunk 0 spans cw 0 .. cw_15
        wide1 |= ref - last > kWide;    // sub-chunk 1 spans cw_15 .. cw_31
        if (lane == 31) sDec[cg + i] = ex2(last);
      }
      sts<GRP>(sW + lane * RW + cg, cw);   // cw over logw, in place
      sts<GRP>(sRq + lane * RK + cg, rq);
      sts<GRP>(sKs + lane * RK + cg, ks);
      sts<GRP>(sQ + lane * RK + cg, qf);
      sts<GRP>(sKf + lane * RK + cg, kf);
    }
    reinterpret_cast<float*>(ops + L::OP_DU)[sw * kChunk + lane] = du;
    const int flags = (__any_sync(kFull, wide0) ? 1 : 0) |
                      (__any_sync(kFull, wide1) ? 2 : 0);
    if (lane == 0) reinterpret_cast<int*>(ops + L::OP_FLAG)[sw] = flags;
  };
  // the sub-chunks of chunk ci whose factors would leave the safe range
  // (bit I: sub-chunk I), the same in every thread
  auto wide_of = [&](int ci) {
    const int* f = reinterpret_cast<const int*>(ops_of(ci) + L::OP_FLAG);
    return f[0] | f[1] | f[2] | f[3];
  };

  // the pairs inside the unsafe sub-chunks of chunk ci (flags `wide`) and
  // their diagonal with its u term, one a thread, per element
  auto pairs = [&](int ci, int wide) {
    unsigned char* base = stage_of(ci);
    const bf16* sR = reinterpret_cast<const bf16*>(base + L::ST_R);
    const bf16* sK = reinterpret_cast<const bf16*>(base + L::ST_K);
    const float* sW = reinterpret_cast<const float*>(base + L::ST_W);
    const float* sDu =
        reinterpret_cast<const float*>(ops_of(ci) + L::OP_DU);
    if (pt >= 0) {
      if (!((wide >> (pt / kSub)) & 1)) return;
      const bf16* rt = sR + pt * RK;
      const bf16* kj = sK + pj * RK;
      const float* wt = sW + (pt - 1) * RW;   // cwp_t = cw_{t-1}
      const float* wj = sW + pj * RW;
      float a[4] = {0.f, 0.f, 0.f, 0.f};      // four chains, not one
#pragma unroll
      for (int c = 0; c < KP; c += 8) {
        float rv[8], kv[8], wp[8], wc[8];
        lds<8>(rt + c, rv);
        lds<8>(kj + c, kv);
        lds<8>(wt + c, wp);
        lds<8>(wj + c, wc);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i & 3] = fmaf(rv[i] * kv[i], ex2(fminf(wp[i] - wc[i], 0.f)),
                          a[i & 3]);
      }
      sA[pt * RA + pj] = __float2bfloat16((a[0] + a[1]) + (a[2] + a[3]));
    } else {
      const int t = 2 * (tid - 2 * kSubPairs);
      if (!((wide >> (t / kSub)) & 1)) return;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float d = 0.f;
#pragma unroll
        for (int w = 0; w < kScanWarps; ++w) d += sDu[w * kChunk + t + x];
        sA[(t + x) * RA + t + x] = __float2bfloat16(d);
      }
    }
  };

  // the products of chunk ci, by product warp `warp` < NPW (value columns
  // vw .. vw + 15): y out, S^T in its accumulators
  auto products = [&](int ci) {
    const bf16* sV =
        reinterpret_cast<const bf16*>(stage_of(ci) + L::ST_V);
    unsigned char* ops = ops_of(ci);
    const bf16* sRq = reinterpret_cast<const bf16*>(ops + L::OP_RQ);
    const bf16* sKs = reinterpret_cast<const bf16*>(ops + L::OP_KS);
    const bf16* sQ = reinterpret_cast<const bf16*>(ops + L::OP_Q);
    const bf16* sKf = reinterpret_cast<const bf16*>(ops + L::OP_K);
    const float* sDec = reinterpret_cast<const float*>(ops + L::OP_DEC);
    const float* sDu = reinterpret_cast<const float*>(ops + L::OP_DU);
    const int wide = wide_of(ci);
    // A's three blocks of 16 x 16: [0] rows 0-15 x columns 0-15, [1] rows
    // 16-31 x 0-15 (across the sub-chunks), [2] rows 16-31 x 16-31
    float yacc[2][2][4], ab[3][2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        yacc[0][n][e] = yacc[1][n][e] = 0.f;
        ab[0][n][e] = ab[1][n][e] = ab[2][n][e] = 0.f;
      }
    // y = (r e^{cwp}) S: S's B fragments are the state's accumulators;
    // A = (r e^{cwp - b}) (k e^{b - cw})^T over the key channels
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) {
      const uint32_t b00 = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      const uint32_t b01 = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      const uint32_t b10 = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      const uint32_t b11 = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        uint32_t a[4];
        ldsm_x4(a, sRq + (16 * m + (lane & 15)) * RK + 16 * kk +
                       (lane >> 4) * 8);
        mma_bf16(yacc[m][0], a, b00, b01);
        mma_bf16(yacc[m][1], a, b10, b11);
      }
      const int qo = (lane & 15) * RK + 16 * kk + (lane >> 4) * 8;
      const int ko = ((lane & 7) + ((lane >> 4) << 3)) * RK + 16 * kk +
                     ((lane >> 3) & 1) * 8;
      uint32_t q[4], kb[4];
      ldsm_x4(q, sQ + kSub * RK + qo);
      ldsm_x4(kb, sKf + ko);
      mma_bf16(ab[1][0], q, kb[0], kb[1]);
      mma_bf16(ab[1][1], q, kb[2], kb[3]);
      if (!(wide & 2)) {
        uint32_t kb1[4];
        ldsm_x4(kb1, sKf + kSub * RK + ko);
        mma_bf16(ab[2][0], q, kb1[0], kb1[1]);
        mma_bf16(ab[2][1], q, kb1[2], kb1[3]);
      }
      if (!(wide & 1)) {
        ldsm_x4(q, sQ + qo);
        mma_bf16(ab[0][0], q, kb[0], kb[1]);
        mma_bf16(ab[0][1], q, kb[2], kb[3]);
      }
    }
    // A's blocks as A fragments (bf16): a safe diagonal block keeps j < t
    // and takes r_t.u.k_t on its diagonal; an unsafe one comes from the
    // pairs, written to shared memory per element
    uint32_t af[3][4];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const int I = x >> 1;              // the sub-chunk of a diagonal block
      if (x != 1 && ((wide >> I) & 1)) {
        ldsm_x4(af[x], sA + (kSub * I + (lane & 15)) * RA + kSub * I +
                           (lane >> 4) * 8);
        continue;
      }
      if (x != 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = fr + 8 * hh;
          float d = 0.f;
#pragma unroll
          for (int w = 0; w < kScanWarps; ++w)
            d += sDu[w * kChunk + kSub * I + t];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int j = 8 * n + fc + c;
              float& e = ab[x][n][2 * hh + c];
              e = j < t ? e : (j == t ? d : 0.f);
            }
        }
      }
      af[x][0] = pack_bf16(ab[x][0][0], ab[x][0][1]);
      af[x][1] = pack_bf16(ab[x][0][2], ab[x][0][3]);
      af[x][2] = pack_bf16(ab[x][1][0], ab[x][1][1]);
      af[x][3] = pack_bf16(ab[x][1][2], ab[x][1][3]);
    }
    // y += A V: V's B fragments by ldmatrix.trans, t-steps 0 and 1
    uint32_t bv[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldsm_x4_t(bv[kk], sV + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 RV + vw + (lane >> 4) * 8);
    mma_bf16(yacc[0][0], af[0], bv[0][0], bv[0][1]);
    mma_bf16(yacc[0][1], af[0], bv[0][2], bv[0][3]);
    mma_bf16(yacc[1][0], af[1], bv[0][0], bv[0][1]);
    mma_bf16(yacc[1][1], af[1], bv[0][2], bv[0][3]);
    mma_bf16(yacc[1][0], af[2], bv[1][0], bv[1][1]);
    mma_bf16(yacc[1][1], af[2], bv[1][2], bv[1][3]);
    // y out of the accumulators, rows < n and columns < V
    const int t0 = ci * kChunk, rows = min(kChunk, Tlen - t0);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = 16 * m + fr + 8 * hh;
        if (t >= rows) continue;
        bf16* dst = y + (((size_t)b * Tlen + t0 + t) * H + h) * V;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = vw + 8 * nt + fc;
          if (col < V)
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                __floats2bfloat162_rn(yacc[m][nt][2 * hh],
                                      yacc[m][nt][2 * hh + 1]);
        }
      }
    // S^T = S^T e^{cw_last} + V^T (k e^{cw_last - cw})
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
      const float d0 = sDec[8 * n + fc], d1 = sDec[8 * n + fc + 1];
      st[n][0] *= d0;
      st[n][1] *= d1;
      st[n][2] *= d0;
      st[n][3] *= d1;
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t av[4];
      ldsm_x4_t(av, sV + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * RV +
                        vw + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int dn = 0; dn < KP / 16; ++dn) {
        uint32_t kb[4];
        ldsm_x4_t(kb, sKs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                RK + 16 * dn + (lane >> 4) * 8);
        mma_bf16(st[2 * dn], av, kb[0], kb[1]);
        mma_bf16(st[2 * dn + 1], av, kb[2], kb[3]);
      }
    }
  };

  // Two barriers a chunk: the products of chunk ci run beside the scan of
  // chunk ci + 1 (other warps), then every thread takes ci + 1's pairs.
  load_chunk(0);
  if (n_chunks > 1) load_chunk(1);
  if (n_chunks > 1) cp_async_wait<1>(); else cp_async_wait<0>();
  __syncthreads();                        // chunk 0 has landed
  if (sw >= 0) scan(0);
  __syncthreads();
  pairs(0, wide_of(0));
  for (int ci = 0; ci < n_chunks; ++ci) {
    cp_async_wait<0>();
    __syncthreads();  // A of ci is whole, ci + 1 has landed, ci - 1 is done
    if (ci + 2 < n_chunks) load_chunk(ci + 2);  // over chunk ci - 1's stage
    if (warp < NPW) products(ci);
    else if (sw >= 0 && ci + 1 < n_chunks) scan(ci + 1);
    __syncthreads();  // ci's products are done with A; ci + 1's scan is out
    if (ci + 1 < n_chunks) pairs(ci + 1, wide_of(ci + 1));
  }
  if (warp < NPW) {
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int vv = vw + fr + 8 * (e >> 1), c = 8 * n + fc + (e & 1);
        if (vv < V && c < K) s_out[(bh * K + c) * V + vv] = st[n][e];
      }
  }
}

template <int K, int V>
cudaError_t launch_tc(const void* r, const void* k, const void* v,
                      const float* logw, const float* u, const float* s0,
                      void* y, float* s_out, int B, int Tlen, int H,
                      cudaStream_t stream) {
  constexpr size_t smem = TcLayout<K, V>::BYTES;
  static bool configured = false;  // once per instantiation and process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gla_fwd_tc<K, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(H, B);
  gla_fwd_tc<K, V><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), logw, u, s0, static_cast<bf16*>(y), s_out,
      Tlen, H);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch_tc_v(int V, const void* r, const void* k,
                          const void* v, const float* logw, const float* u,
                          const float* s0, void* y, float* s_out, int B,
                          int Tlen, int H, cudaStream_t s) {
  switch (V) {
    case 8: return launch_tc<K, 8>(r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    case 16: return launch_tc<K, 16>(r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    case 32: return launch_tc<K, 32>(r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    case 64: return launch_tc<K, 64>(r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_tc(int K, int V, const void* r, const void* k,
                        const void* v, const float* logw, const float* u,
                        const float* s0, void* y, float* s_out, int B,
                        int Tlen, int H, cudaStream_t s) {
  switch (K) {
    case 8: return dispatch_tc_v<8>(V, r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    case 16: return dispatch_tc_v<16>(V, r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    case 32: return dispatch_tc_v<32>(V, r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    case 64: return dispatch_tc_v<64>(V, r, k, v, logw, u, s0, y, s_out, B, Tlen, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of r/k/v/y: 0 = float32, 1 = bfloat16. variant: 0 = gla_fwd (any
// dtype), 1 = gla_fwd_tc (bfloat16). u and s0 may be null. Returns a
// cudaError_t (0 = launched).
int repro_gla_scan_fwd(const void* r, const void* k, const void* v,
                       const void* logw, const void* u, const void* s0,
                       void* y, void* s_out, int B, int T, int H, int K,
                       int V, int dtype, int variant, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > 65535 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const float* w = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* s = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)dispatch_tc(K, V, r, k, v, w, uu, s, y, so, B, T, H, st);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_k<float>(K, V, r, k, v, w, uu, s, y, so, B, T, H, st);
  if (dtype == 1)
    return (int)dispatch_k<__nv_bfloat16>(K, V, r, k, v, w, uu, s, y, so, B,
                                          T, H, st);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
