// Flash-attention forward for Hopper (sm_90a), f32 and bf16.
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
// and kpos (Sk,) int32; o (B, Sq, H, D). D in {16, 32, 64, 128}.
//
// What bounds it on the H100: at the serving shapes the work is small
// beside the bytes (prefill B=8, S=512, H=32, G=8, D=128, causal: ~84 MB
// against ~17 GFLOP, so ~25 us of HBM traffic at 3.35 TB/s; decode Sq=1
// reads ~18 MB of K/V per step), so the least time is set by the bytes.
// What the design does about it: one block serves every q head of one kv
// head (H/G heads x 64/(H/G) positions = 64 query rows), so each K/V tile
// is read from device memory once per 64 rows instead of once per head;
// tiles whose kpos are all masked for the block's rows (the causal upper
// triangle, the window's far past, empty ring-cache slots) are skipped
// before their K/V are loaded, so the bytes read are the ones the data
// needs. The arithmetic runs on CUDA cores in f32 (no tensor cores yet):
// that makes this first version compute-limited at the prefill shape;
// wgmma, TMA and warp specialisation are left for later work.
//
// Work split: grid (ceil(Sq*H/G / 64), G, B); 8 warps x 8 query rows each.
// Per kv tile of 32 keys (one key per lane) a warp computes its 8 rows'
// scores with lanes over keys, updates the online softmax in registers,
// writes p to shared memory, then accumulates p @ V with lanes over head
// dims. Ragged Sq/Sk are masked inside (rows past Sq are not written, keys
// past Sk count as kpos = -1), so any Sq >= 1 and Sk >= 1 are taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  static bool configured = false;  // once per instantiation and process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
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
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              const void* qpos, const void* kpos, void* o,
                              int B, int Sq, int Sk, int H, int G, int D,
                              int causal, int window, float scale, int dtype,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || Sq < 1 || Sk < 1 || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(D, q, k, v, qp, kp, o, B, Sq, Sk, H, G,
                                  causal, window, scale, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, qp, kp, o, B, Sq, Sk, H,
                                          G, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
