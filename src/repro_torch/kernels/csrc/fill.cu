// Batched max-min progressive fill for Hopper (sm_90a), float64.
//
// Replaces repro/sweep/vmap_fill.py::_fill_one and the _jitted_rates_dt
// epilogue (XLA, a jax.vmap of a lax.while_loop; not a Pallas kernel). It
// solves the fabric allocator's fill problems, repro_torch/sim/network.py::
// NetworkFabric._recompute, one problem per warp: S problems of C flow
// classes over L links, padded to a common (C, L).
//
// Inputs, contiguous: caps (S, L), n, fcap, cap_rank, remaining (S, C), all
// float64; members (S, C, L) uint8, 1 where class c crosses link l. Padded
// links carry caps = inf and no members; padded classes n = 0, fcap = inf,
// cap_rank = C and remaining = inf. Outputs: rates (S, C) float64, the
// per-member rate of each class (0 for padded classes); dt (S,) float64, the
// least remaining / rate over classes with rate > 0 and a finite remaining
// (inf for none); status (S,) float64, 0 for a solved problem and 1 for one
// whose round fixed no class (inconsistent input; the wrapper raises).
//
// Each round of the fill, exactly as the scalar allocator takes it:
//   * the link with the least share rem/nuse over links with nuse > 0, the
//     lowest index winning ties (links are in sorted-key order, which is the
//     allocator's (share, link key) tie-break);
//   * the unfixed class of least cap_rank, the (cap, signature) order; its
//     cap wins only when strictly below the link's share (a real link wins
//     an exact tie) or when no link has members left;
//   * a link win fixes every unfixed class that crosses it at the share; a
//     cap win fixes that one class, and the next round takes the next cap.
//     (The JAX kernel fixes every class at an equal cap in one round. That
//     debits a shared link by (k1 + k2) * r at once where the allocator
//     debits k1 * r and then k2 * r, which rounds differently; so here, as
//     in the allocator, one class a cap round.);
//   * k_l = sum of n over the newly fixed classes crossing link l (small
//     integers, exact in any order); where k_l > 0,
//     rem_l = max(0, rem_l - k_l * share) and nuse_l -= k_l.
// Bit-identity with CPython's float arithmetic in _recompute and _arm needs
// every operation rounded on its own: the debit is __dmul_rn then
// __dsub_rn (nvcc would otherwise contract it into an fma, which rounds
// once), the shares and etas __ddiv_rn, and max(0, x) is x > 0 ? x : 0 as
// CPython's max(0.0, x) takes it.
//
// What bounds it on the H100: neither bytes nor operations. A batch of 64
// problems at the pad floors (48 classes, 24 links) is ~0.2 MB of input and
// a few hundred thousand double operations; the card would move the bytes
// in ~0.06 us and do the arithmetic in well under that. The rounds are
// serial within a problem (up to C of them, each a few warp reductions over
// shared memory), so the time is the round count times the latency of a
// round, plus the launch. The design keeps a problem inside one warp, so a
// round needs no block barrier (only __syncwarp), and its state (rem and
// nuse over links; rates, fixed flags and the newly fixed list over classes)
// in shared memory; members stay in device memory as bytes, read through
// the read-only cache. C and L are strided over the 32 lanes, so any
// shape runs; shared memory grows as 16 L + 37 C bytes a problem.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void warp_argmin(double& v, int& i) {
  // least (v, i) over the warp; ties go to the lower index, and an index
  // of -1 (no candidate, v = inf) loses to any candidate
  for (int off = kWarp / 2; off > 0; off /= 2) {
    double ov = __shfl_xor_sync(kFull, v, off);
    int oi = __shfl_xor_sync(kFull, i, off);
    bool take = (oi >= 0) && (i < 0 || ov < v || (ov == v && oi < i));
    if (take) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ double warp_min(double v) {
  for (int off = kWarp / 2; off > 0; off /= 2)
    v = fmin(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__global__ void __launch_bounds__(kWarp)
    fill_rates_dt_kernel(const double* __restrict__ caps,
                         const uint8_t* __restrict__ members,
                         const double* __restrict__ n,
                         const double* __restrict__ fcap,
                         const double* __restrict__ cap_rank,
                         const double* __restrict__ remaining,
                         double* __restrict__ rates_out,
                         double* __restrict__ dt_out,
                         double* __restrict__ status_out, int C, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* rem = reinterpret_cast<double*>(smem);  // L
  double* nuse = rem + L;                         // L
  double* rates = nuse + L;                       // C
  double* nn = rates + C;                         // C
  double* rank = nn + C;                          // C
  double* cap = rank + C;                         // C
  int* newly = reinterpret_cast<int*>(cap + C);   // C
  uint8_t* fixed = reinterpret_cast<uint8_t*>(newly + C);  // C

  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  const double* caps_s = caps + (size_t)s * L;
  const uint8_t* mem_s = members + (size_t)s * C * L;
  const double* n_s = n + (size_t)s * C;

  int n_live = 0;  // classes that take part (n > 0), the round bound
  for (int c = lane; c < C; c += kWarp) {
    double nc = n_s[c];
    nn[c] = nc;
    rank[c] = cap_rank[(size_t)s * C + c];
    cap[c] = fcap[(size_t)s * C + c];
    rates[c] = 0.0;
    fixed[c] = !(nc > 0.0);
    n_live += nc > 0.0;
  }
  for (int off = kWarp / 2; off > 0; off /= 2)
    n_live += __shfl_xor_sync(kFull, n_live, off);
  __syncwarp();
  for (int l = lane; l < L; l += kWarp) {
    double u = 0.0;  // live members on link l: a sum of small integers
    for (int c = 0; c < C; ++c)
      if (__ldg(mem_s + (size_t)c * L + l)) u += nn[c];
    rem[l] = caps_s[l];
    nuse[l] = u;
  }
  __syncwarp();

  double status = 0.0;
  for (int round = 0;; ++round) {
    // the least-share link
    double link_share = inf;
    int li = -1;
    for (int l = lane; l < L; l += kWarp) {
      double u = nuse[l];
      if (u > 0.0) {
        double sh = __ddiv_rn(rem[l], u);
        if (li < 0 || sh < link_share) {
          link_share = sh;
          li = l;
        }
      }
    }
    warp_argmin(link_share, li);
    // the next cap: the unfixed class of least cap_rank
    double best_rank = inf;
    int bc = -1;
    for (int c = lane; c < C; c += kWarp) {
      if (!fixed[c] && (bc < 0 || rank[c] < best_rank)) {
        best_rank = rank[c];
        bc = c;
      }
    }
    warp_argmin(best_rank, bc);
    if (bc < 0) break;  // every class fixed
    if (round >= n_live) {  // more rounds than classes: no progress
      status = 1.0;
      break;
    }
    double cap_min = cap[bc];
    bool cap_wins = li < 0 || cap_min < link_share;
    double share = cap_wins ? cap_min : link_share;

    // the newly fixed classes, compacted into newly[0:k] in class order
    int k = 0;
    for (int c0 = 0; c0 < C; c0 += kWarp) {
      int c = c0 + lane;
      bool take = false;
      if (c < C && !fixed[c])
        take = cap_wins ? (c == bc) : (__ldg(mem_s + (size_t)c * L + li) != 0);
      unsigned mask = __ballot_sync(kFull, take);
      if (take) {
        newly[k + __popc(mask & ((1u << lane) - 1u))] = c;
        rates[c] = share;
        fixed[c] = 1;
      }
      k += __popc(mask);
    }
    if (k == 0) {  // a link with members but no unfixed class on it
      status = 1.0;
      break;
    }
    __syncwarp();
    for (int l = lane; l < L; l += kWarp) {
      double d = 0.0;
      for (int j = 0; j < k; ++j) {
        int c = newly[j];
        if (__ldg(mem_s + (size_t)c * L + l)) d += nn[c];
      }
      if (d > 0.0) {
        double x = __dsub_rn(rem[l], __dmul_rn(d, share));
        rem[l] = x > 0.0 ? x : 0.0;
        nuse[l] = __dsub_rn(nuse[l], d);
      }
    }
    __syncwarp();
  }

  // rates out, and the seconds to the earliest completion
  double dt = inf;
  const double* rm_s = remaining + (size_t)s * C;
  for (int c = lane; c < C; c += kWarp) {
    double r = rates[c];
    rates_out[(size_t)s * C + c] = r;
    double q = rm_s[c];
    if (r > 0.0 && isfinite(q)) dt = fmin(dt, __ddiv_rn(q, r));
  }
  dt = warp_min(dt);
  if (lane == 0) {
    dt_out[s] = dt;
    status_out[s] = status;
  }
}

}  // namespace

extern "C" {

// S problems of (C, L), one warp each, on `stream`. Returns a cudaError_t
// (0 = launched); a problem that could not be solved sets its status to 1.
int repro_fill_rates_dt(const void* caps, const void* members, const void* n,
                        const void* fcap, const void* cap_rank,
                        const void* remaining, void* rates, void* dt,
                        void* status, int S, int C, int L, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S < 1 || C < 1 || L < 1) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)L * 2 * sizeof(double) + (size_t)C * 4 * sizeof(double)
                + (size_t)C * sizeof(int) + (size_t)C;
  if (smem > 48 * 1024) {  // past the default: opt in, up to the card's most
    int max_optin = 0;
    err = cudaDeviceGetAttribute(
        &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)max_optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(fill_rates_dt_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fill_rates_dt_kernel<<<S, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(caps), static_cast<const uint8_t*>(members),
      static_cast<const double*>(n), static_cast<const double*>(fcap),
      static_cast<const double*>(cap_rank),
      static_cast<const double*>(remaining), static_cast<double*>(rates),
      static_cast<double*>(dt), static_cast<double*>(status), C, L);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
