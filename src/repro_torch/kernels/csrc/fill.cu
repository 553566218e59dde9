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
// cap_rank = C and remaining = inf. cap_rank orders the live classes
// (n > 0): any values but NaN, ties going to the lower index. Outputs: rates (S, C) float64, the
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
// gate-point problems (40 classes, 17 links) is ~156 KB of input and a few
// hundred thousand double operations; the card would move the bytes in
// ~0.05 us and do the arithmetic in less. The rounds are serial within a
// problem (up to C of them), and the 64 warps run side by side on 132 SMs,
// so a batch takes as long as its longest problem: its round count times
// the latency of one round, plus the prologue and the launch. Every round
// is a chain of dependent steps, so the design shortens the chain.
//
// In the first design ("smem") a round is long: a warp argmin of (double,
// index) pairs is five dependent rounds of three shuffles, the newly
// fixed classes and each link's sum over them are read from device memory
// a class at a time, and every link's share is divided anew.
//
// Two variants, one warp a problem each:
//   * "reg" (fill_reg_kernel<W, LPL>, C <= 256 and L <= 128): the state
//     lives in registers, and a round reads no device memory. Lane l
//     holds links l, l + 32, ... (LPL of them): for each, a bitmask of the
//     classes that cross it (W words of 64 bits), rem, nuse and the
//     cached share rem / nuse. Each lane holds classes lane, lane + 32,
//     ...: rate, and place in the cap order. The fixed set is W words,
//     the same in every lane.
//     Prologue: every global load issued at once (the members copied to
//     shared memory in whole words), then the masks, a lane reading its
//     column. Where each n is a whole number below 2^16, the sums of n
//     over a set of classes (nuse, each debit's k) are popcounts of the
//     set against the bit planes of n, exact in any order; else n is
//     added a class at a time in class order. The cap order sorts the
//     live classes by (cap_rank, index): where their ranks are 0 ..
//     n_live - 1, each once (as the packer gives them), a rank is its
//     place; else each class counts the ones ahead of it.
//     A round: the least-share link by three single-instruction warp
//     reductions (REDUX) over an order-preserving 64-bit key of the
//     cached shares and the index; the next cap the least place of an
//     unfixed class, one more REDUX, taken in the round before beside its
//     divisions. A link win takes the winner's mask (shuffled from its
//     lane) less the fixed set; a cap win the one class. Each lane debits,
//     and divides for a new share, only the links whose k is not zero:
//     the other shares have not changed, so the cache gives the bits a
//     fresh division would.
//   * "smem" (fill_smem_kernel, any shape): the first design. Rates, rem,
//     nuse and fixed flags in shared memory, members read from device
//     memory in every round, the least share recomputed for every link,
//     the next cap found by a warp reduction over classes. It stays for
//     the shapes past the register templates and as the comparison on the
//     card.
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

// an unsigned key in the order of the doubles, -0 and +0 one key, NaN
// after every number
__device__ __forceinline__ unsigned long long order_key(double v) {
  if (v != v) return ~0ull;
  const long long b = __double_as_longlong(v + 0.0);  // -0 + 0 = +0
  return b < 0 ? ~(unsigned long long)b
               : (unsigned long long)b | 0x8000000000000000ull;
}

__device__ __forceinline__ double key_value(unsigned long long k) {
  return __longlong_as_double(
      (long long)(k >> 63 ? k & 0x7fffffffffffffffull : ~k));
}

// the least (key, i) over the warp, ties to the lower i, in three
// single-instruction reductions: returns that i, or -1 where every lane's
// i is -1 (no candidate); `key` becomes the least key
__device__ __forceinline__ int warp_argmin_key(unsigned long long& key,
                                               int i) {
  const unsigned mine_hi = i >= 0 ? (unsigned)(key >> 32) : ~0u;
  const unsigned hi = __reduce_min_sync(kFull, mine_hi);
  const unsigned lo = __reduce_min_sync(
      kFull, i >= 0 && mine_hi == hi ? (unsigned)key : ~0u);
  const bool at = i >= 0 && key == ((unsigned long long)hi << 32 | lo);
  key = (unsigned long long)hi << 32 | lo;
  const unsigned got = __reduce_min_sync(kFull, at ? (unsigned)i : ~0u);
  return got == ~0u ? -1 : (int)got;
}

// bit c of a W-word set (c uniform or not; the word is picked by selects,
// so the set stays in registers)
template <int W>
__device__ __forceinline__ bool has_bit(const uint64_t (&m)[W], int c) {
  uint64_t w = m[0];
#pragma unroll
  for (int i = 1; i < W; ++i)
    if ((c >> 6) == i) w = m[i];
  return (w >> (c & 63)) & 1ull;
}

// the sum of n over the classes of a W-word set: popcounts over the bit
// planes of n where `bits` > 0 (whole n: exact in any order), else n a
// class at a time in class order
template <int W, int kBits>
__device__ __forceinline__ double sum_n(const uint64_t (&x)[W], int bits,
                                        const uint64_t (&plane)[kBits][W],
                                        const double* s_n) {
  if (bits > 0) {
    unsigned k = 0;
    for (int b = 0; b < bits; ++b) {
      unsigned cnt = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) cnt += __popcll(x[w] & plane[b][w]);
      k += cnt << b;
    }
    return (double)k;
  }
  double d = 0.0;
#pragma unroll
  for (int w = 0; w < W; ++w)
    for (uint64_t y = x[w]; y; y &= y - 1)
      d += s_n[64 * w + __ffsll((long long)y) - 1];
  return d;
}

// the least place in the cap order of an unfixed class (lane holds
// classes lane + 32 k, at places pos[k]), or -1 where every class is fixed
template <int W>
__device__ __forceinline__ int next_cap(const uint64_t (&fixed)[W],
                                        const int (&pos)[2 * W], int lane) {
  unsigned first = ~0u;
#pragma unroll
  for (int k = 0; k < 2 * W; ++k)
    if (!((fixed[k / 2] >> (kWarp * (k % 2) + lane)) & 1ull))
      first = min(first, (unsigned)pos[k]);
  first = __reduce_min_sync(kFull, first);
  return first == ~0u ? -1 : (int)first;
}

template <int W, int LPL>
__global__ void __launch_bounds__(kWarp)
    fill_reg_kernel(const double* __restrict__ caps,
                    const uint8_t* __restrict__ members,
                    const double* __restrict__ n,
                    const double* __restrict__ fcap,
                    const double* __restrict__ cap_rank,
                    const double* __restrict__ remaining,
                    double* __restrict__ rates_out,
                    double* __restrict__ dt_out,
                    double* __restrict__ status_out, int C, int L) {
  constexpr int kC = 64 * W;       // the classes the template holds
  constexpr int kL = kWarp * LPL;  // and the links
  constexpr int kBits = 16;        // a whole n below 2^16 has bit planes
  __shared__ double s_n[kC];
  __shared__ double s_cap[kC];
  __shared__ double s_rank[kC];  // NaN for a class that is not live
  __shared__ int s_order[kC];    // the live classes by (cap_rank, index)
  __shared__ uint64_t s_plane[kBits][W];  // bit b of each class's whole n
  // member bytes, (c, l) at pad + c L + l, copied in whole words
  __shared__ __align__(16) uint8_t s_mem[kC * kL + 4];

  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  const size_t row = (size_t)s * C;

  // every global load first, so their latencies overlap: the classes
  // (lane holds c = lane + 32 k), its links' capacities (l = lane + 32 j)
  // and the member bytes, a word a lane at a time
  double nc[2 * W], fc[2 * W], rk[2 * W], rm[2 * W];
#pragma unroll
  for (int k = 0; k < 2 * W; ++k) {
    const int c = lane + kWarp * k;
    nc[k] = 0.0;
    fc[k] = inf;
    rk[k] = nan;
    rm[k] = inf;
    if (c < C) {
      nc[k] = n[row + c];
      fc[k] = fcap[row + c];
      rk[k] = cap_rank[row + c];
      rm[k] = remaining[row + c];
    }
  }
  double rem[LPL];
#pragma unroll
  for (int j = 0; j < LPL; ++j) {
    const int l = lane + kWarp * j;
    rem[j] = l < L ? caps[(size_t)s * L + l] : 0.0;
  }
  const uint8_t* mem_s = members + row * L;
  const int nb = C * L;
  const int pad = (int)(reinterpret_cast<uintptr_t>(mem_s) & 3);
  const int head = min((4 - pad) & 3, nb);  // bytes before the first word
  const int nw = (nb - head) >> 2;          // whole words
  const int tail = head + 4 * nw;           // the bytes after the words
  const uint8_t b_head = lane < head ? __ldg(mem_s + lane) : 0;
  const uint8_t b_tail = lane < nb - tail ? __ldg(mem_s + tail + lane) : 0;
  const uint32_t* wsrc = reinterpret_cast<const uint32_t*>(mem_s + head);
  uint32_t* wdst = reinterpret_cast<uint32_t*>(s_mem + pad + head);
  for (int t0 = lane; t0 < nw; t0 += 8 * kWarp) {
    uint32_t v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = t0 + kWarp * u;
      v[u] = t < nw ? __ldg(wsrc + t) : 0u;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (t0 + kWarp * u < nw) wdst[t0 + kWarp * u] = v[u];
  }
  if (lane < head) s_mem[pad + lane] = b_head;
  if (lane < nb - tail) s_mem[pad + tail + lane] = b_tail;

  // live classes (n > 0) as W words; a live class's NaN rank sorts last.
  // Where every n is a whole number in [0, 2^16), sums of n over a set of
  // classes are popcounts over the bit planes of n
  uint64_t live[W];
  unsigned un[2 * W];  // a whole n, else 0
  bool whole = true;
#pragma unroll
  for (int k = 0; k < 2 * W; ++k) {
    const int c = lane + kWarp * k;
    const bool lv = nc[k] > 0.0;
    if (!lv)
      rk[k] = nan;
    else if (rk[k] != rk[k])
      rk[k] = inf;
    if (c < C) {
      s_n[c] = nc[k];
      s_cap[c] = fc[k];
      s_rank[c] = rk[k];
    }
    const bool whole_k = nc[k] >= 0.0 && nc[k] < (double)(1 << kBits) &&
                         nc[k] == rint(nc[k]);
    whole = whole && whole_k;
    un[k] = whole_k ? (unsigned)nc[k] : 0u;
    const uint64_t b = __ballot_sync(kFull, lv);
    if (k % 2 == 0)
      live[k / 2] = b;
    else
      live[k / 2] |= b << 32;
  }
  int n_live = 0;  // the round bound
#pragma unroll
  for (int w = 0; w < W; ++w) n_live += __popcll(live[w]);
  unsigned nmax = 0;
#pragma unroll
  for (int k = 0; k < 2 * W; ++k) nmax = max(nmax, un[k]);
  // 0: sum n a class at a time, in class order, as the first design
  const int bits = __all_sync(kFull, whole)
                       ? 32 - __clz((int)__reduce_max_sync(kFull, nmax))
                       : 0;
#pragma unroll 4
  for (int b = 0; b < bits; ++b)
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t p =
          __ballot_sync(kFull, (un[2 * w] >> b) & 1u) |
          (uint64_t)__ballot_sync(kFull, (un[2 * w + 1] >> b) & 1u) << 32;
      if (lane == 0) s_plane[b][w] = p;
    }
  // the cap order: where the live ranks are 0 .. n_live - 1, each once
  // (as the packer gives them), a class's rank is its place; else, below,
  // each live class counts the live classes ahead of it
  int pos[2 * W];
  bool perm = true;
#pragma unroll
  for (int k = 0; k < 2 * W; ++k) {
    const bool lv = (live[k / 2] >> (kWarp * (k % 2) + lane)) & 1ull;
    pos[k] = lv && rk[k] >= 0.0 && rk[k] < (double)n_live ? (int)rk[k] : -1;
    perm = perm && (!lv || (pos[k] >= 0 && rk[k] == (double)pos[k]));
    if (lv && pos[k] >= 0) s_order[pos[k]] = lane + kWarp * k;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 2 * W; ++k)  // a rank taken twice: a slot lost
    if (pos[k] >= 0) perm = perm && s_order[pos[k]] == lane + kWarp * k;
  perm = __all_sync(kFull, perm);

  // links: lane holds l = lane + 32 j; its class mask, rem, nuse (a sum
  // in class order) and the cached share
  uint64_t mask[LPL][W];
  double nuse[LPL], share[LPL];
  bool used[LPL];  // nuse > 0
#pragma unroll
  for (int j = 0; j < LPL; ++j)
#pragma unroll
    for (int w = 0; w < W; ++w) mask[j][w] = 0;
  // a row's byte a lane, 32 rows to a half word; the loads are independent
#pragma unroll
  for (int h = 0; h < 2 * W; ++h) {
    const int c0 = 32 * h;
    const int hi = min(32, C - c0);  // rows in this half word
#pragma unroll
    for (int j = 0; j < LPL; ++j) {
      const int l = lane + kWarp * j;
      const uint8_t* col = s_mem + pad + c0 * L + l;
      unsigned half = 0;
      if (l < L) {
#pragma unroll 8
        for (int t = 0; t < hi; ++t) half |= (unsigned)(col[t * L] != 0) << t;
      }
      mask[j][h / 2] |= (uint64_t)half << (32 * (h % 2));
    }
  }
#pragma unroll
  for (int j = 0; j < LPL; ++j) {
    nuse[j] = sum_n<W>(mask[j], bits, s_plane, s_n);
    used[j] = nuse[j] > 0.0;
    share[j] = used[j] ? __ddiv_rn(rem[j], nuse[j]) : inf;
  }
  if (!perm) {
#pragma unroll
    for (int k = 0; k < 2 * W; ++k) pos[k] = 0;
    for (int c0 = 0; c0 < C; c0 += 8) {
      double r2[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) r2[u] = c0 + u < C ? s_rank[c0 + u] : nan;
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int k = 0; k < 2 * W; ++k)
          pos[k] += (r2[u] < rk[k]) |
                    ((r2[u] == rk[k]) & (c0 + u < lane + kWarp * k));
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 2 * W; ++k)
      if ((live[k / 2] >> (kWarp * (k % 2) + lane)) & 1ull)
        s_order[pos[k]] = lane + kWarp * k;
  }
  __syncwarp();

  uint64_t fixed[W];
#pragma unroll
  for (int w = 0; w < W; ++w) fixed[w] = ~live[w];
  double rate[2 * W];
#pragma unroll
  for (int k = 0; k < 2 * W; ++k) rate[k] = 0.0;
  double status = 0.0;
  // the next cap: the unfixed class first in the cap order, its place the
  // least over the warp; found at the end of the round before, beside the
  // debits' divisions
  int first = next_cap<W>(fixed, pos, lane);
  for (int round = 0;; ++round) {
    if (first < 0) break;  // every class fixed
    if (round >= n_live) {  // more rounds than classes: no progress
      status = 1.0;
      break;
    }
    const int bc = s_order[first];
    const double cap_min = s_cap[bc];
    const double n_bc = s_n[bc];
    // the least-share link, from the cached shares
    unsigned long long key = ~0ull;
    int li = -1;
#pragma unroll
    for (int j = 0; j < LPL; ++j) {
      const unsigned long long kj = used[j] ? order_key(share[j]) : ~0ull;
      const bool take = used[j] & ((li < 0) | (kj < key));
      key = take ? kj : key;
      li = take ? lane + kWarp * j : li;
    }
    li = warp_argmin_key(key, li);
    const bool cap_wins = li < 0 || cap_min < key_value(key);

    // the newly fixed classes, and k_l: the sum of n over those on link l
    uint64_t newly[W];
    double d[LPL];
    double sh;
    if (cap_wins) {  // uniform over the warp, as li and bc are
      sh = cap_min;
#pragma unroll
      for (int w = 0; w < W; ++w)
        newly[w] = (bc >> 6) == w ? 1ull << (bc & 63) : 0ull;
#pragma unroll
      for (int j = 0; j < LPL; ++j)
        d[j] = has_bit<W>(mask[j], bc) ? n_bc : 0.0;
    } else {  // link li's unfixed classes, and its own share, from its lane
      double own = share[0];
#pragma unroll
      for (int j = 1; j < LPL; ++j)
        if (li >> 5 == j) own = share[j];
      sh = __shfl_sync(kFull, own, li & (kWarp - 1));
      uint64_t any = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        unsigned long long m = mask[0][w];
#pragma unroll
        for (int j = 1; j < LPL; ++j)
          if (li >> 5 == j) m = mask[j][w];
        newly[w] = __shfl_sync(kFull, m, li & (kWarp - 1)) & ~fixed[w];
        any |= newly[w];
      }
      if (any == 0) {  // a link with members but no unfixed class on it
        status = 1.0;
        break;
      }
#pragma unroll
      for (int j = 0; j < LPL; ++j) {
        uint64_t x[W];
#pragma unroll
        for (int w = 0; w < W; ++w) x[w] = newly[w] & mask[j][w];
        d[j] = sum_n<W>(x, bits, s_plane, s_n);
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) fixed[w] |= newly[w];
#pragma unroll
    for (int k = 0; k < 2 * W; ++k)
      if ((newly[k / 2] >> (kWarp * (k % 2) + lane)) & 1ull) rate[k] = sh;
    first = next_cap<W>(fixed, pos, lane);
    // debit the links the newly fixed classes cross, and only those
#pragma unroll
    for (int j = 0; j < LPL; ++j)
      if (d[j] > 0.0) {
        const double x = __dsub_rn(rem[j], __dmul_rn(d[j], sh));
        rem[j] = x > 0.0 ? x : 0.0;
        nuse[j] = __dsub_rn(nuse[j], d[j]);
        used[j] = nuse[j] > 0.0;
        if (used[j]) share[j] = __ddiv_rn(rem[j], nuse[j]);
      }
  }

  // rates out, and the seconds to the earliest completion
  double dt = inf;
#pragma unroll
  for (int k = 0; k < 2 * W; ++k) {
    const int c = lane + kWarp * k;
    if (c < C) {
      const double r = rate[k];
      rates_out[row + c] = r;
      if (r > 0.0 && isfinite(rm[k])) dt = fmin(dt, __ddiv_rn(rm[k], r));
    }
  }
  dt = warp_min(dt);
  if (lane == 0) {
    dt_out[s] = dt;
    status_out[s] = status;
  }
}

__global__ void __launch_bounds__(kWarp)
    fill_smem_kernel(const double* __restrict__ caps,
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

// S problems of (C, L), one warp each, on `stream`, by `variant`: 0 for
// "smem" (any shape), 1 for "reg" (C <= 256, L <= 128). Returns a
// cudaError_t (0 = launched); a problem that could not be solved sets its
// status to 1.
int repro_fill_rates_dt(const void* caps, const void* members, const void* n,
                        const void* fcap, const void* cap_rank,
                        const void* remaining, void* rates, void* dt,
                        void* status, int S, int C, int L, int variant,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S < 1 || C < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const auto* a_caps = static_cast<const double*>(caps);
  const auto* a_mem = static_cast<const uint8_t*>(members);
  const auto* a_n = static_cast<const double*>(n);
  const auto* a_fcap = static_cast<const double*>(fcap);
  const auto* a_rank = static_cast<const double*>(cap_rank);
  const auto* a_rem = static_cast<const double*>(remaining);
  auto* o_rates = static_cast<double*>(rates);
  auto* o_dt = static_cast<double*>(dt);
  auto* o_status = static_cast<double*>(status);
  auto st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (C > 256 || L > 128) return (int)cudaErrorInvalidValue;
    const int w = C <= 64 ? 1 : C <= 128 ? 2 : 4;
    const int lpl = L <= 32 ? 1 : L <= 64 ? 2 : 4;
#define REPRO_FILL_REG(W_, LPL_)                                         \
  case W_ * 8 + LPL_:                                                    \
    fill_reg_kernel<W_, LPL_><<<S, kWarp, 0, st>>>(                      \
        a_caps, a_mem, a_n, a_fcap, a_rank, a_rem, o_rates, o_dt,        \
        o_status, C, L);                                                 \
    break;
    switch (w * 8 + lpl) {
      REPRO_FILL_REG(1, 1) REPRO_FILL_REG(1, 2) REPRO_FILL_REG(1, 4)
      REPRO_FILL_REG(2, 1) REPRO_FILL_REG(2, 2) REPRO_FILL_REG(2, 4)
      REPRO_FILL_REG(4, 1) REPRO_FILL_REG(4, 2) REPRO_FILL_REG(4, 4)
    }
#undef REPRO_FILL_REG
    return (int)cudaGetLastError();
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)L * 2 * sizeof(double) + (size_t)C * 4 * sizeof(double)
                + (size_t)C * sizeof(int) + (size_t)C;
  if (smem > 48 * 1024) {  // past the default: opt in, up to the card's most
    int max_optin = 0;
    err = cudaDeviceGetAttribute(
        &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)max_optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(fill_smem_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fill_smem_kernel<<<S, kWarp, smem, st>>>(a_caps, a_mem, a_n, a_fcap, a_rank,
                                           a_rem, o_rates, o_dt, o_status, C,
                                           L);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
