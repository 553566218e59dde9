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
// is <= 0 by construction (the min guards rounding). cwp_t is taken as the
// running sum before step t, the very number stored as cw_{t-1}, not as
// cw_t - logw_t (the reference's form): the adjacent pair's exponent is then
// exactly 0, where the difference carries the rounding error of |cw| (~1e-3
// at |cw| ~ 1e4, which puts y off by ~6e-3 at K = 64).
//
// Layout: r, k, logw (B, T, H, K), v and y (B, T, H, V), contiguous, read
// and written in the model's layout (no transposes on the host); u (H, K)
// f32 or null; initial state (B, H, K, V) f32 or null (zeros); final state
// (B, H, K, V) f32. r/k/v/y are all f32 or all bf16; logw is f32; all the
// arithmetic is f32. K, V in {8, 16, 32, 64}; any T >= 1: rows of a ragged
// last chunk read as r = k = v = logw = 0, which leaves the state as it is
// and writes no y.
//
// What bounds it on the H100: at the serving shapes the bytes (rwkv6 B=8,
// T=512, H=64, K=V=64 in bf16: r, k, v, y 33.5 MB each, logw 67 MB, the
// state 8.4 MB, ~210 MB or ~63 us at 3.35 TB/s; hymba T=2048, H=25, K=16,
// V=64: ~157 MB or ~47 us) dwarf the useful arithmetic (~5 GFLOP, ~5 us at
// the bf16 tensor-core peak). What the design does about it: every input
// element is read from device memory once and y once written, the state
// never leaves shared memory between chunks, and the chunk's pairwise
// decays (C x C x K exponentials) live only in registers. The arithmetic
// runs in f32 on CUDA cores (the three small products are not on tensor
// cores yet), so this first version is limited by instruction issue and the
// exponentials rather than by the bytes; that is later work.
//
// Work split: one block of 256 threads per (b, h), looping over the chunks
// in order. Per chunk: load the tiles as f32 into shared memory; K threads
// take the cumulative sums; then the C(C-1)/2 = 496 strictly-lower (t, j)
// pairs of A (two a thread), r * e^{cwp}, k * e^{cw_last - cw} and the
// diagonal term; then each thread computes y for one value column and V/8
// rows; then each thread updates the state entries of its column.

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

}  // namespace

extern "C" {

// dtype of r/k/v/y: 0 = float32, 1 = bfloat16. u and s0 may be null.
// Returns a cudaError_t (0 = launched).
int repro_gla_scan_fwd(const void* r, const void* k, const void* v,
                       const void* logw, const void* u, const void* s0,
                       void* y, void* s_out, int B, int T, int H, int K,
                       int V, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > 65535 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const float* w = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* s = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
