// K2: fused LRAM query  q (n, 8) f32 -> top-k (idx int32, w f32).
//
// Replaces the TPU kernel src/repro/kernels/e8_lookup.py
// (lram_query_pallas, _query_kernel; pallas_call at :189).  Per query:
// E8 decode over both D8 cosets, canonicalisation into the fundamental
// region F by the 19-comparator Batcher network, squared distances to the
// 232 candidates (padded to 256), weights relu(1 - d^2/8)^4, the top-k in
// descending weight (equal weights: lower candidate first), the inverse
// isometry and the O(1) torus encode.
//
// Bound on an H100: operations.  A query reads 32 B and writes 8k B, but
// does 232 distances of ~23 fp32 operations each plus a top-k of 232; at
// n = 65536 that is ~0.4 G operations against 19 MB.
//
// Design: a block of 4 warps works through tiles of 4 * per_warp queries
// (per_warp from the host: 1 for small n, so every query has a warp of its
// own, up to 32 for large n, so about 4,096 warps cover the work).
//   1. Decode once a query: thread i of the block decodes and
//      canonicalises query i of the tile and leaves z (8), |z|^2, the coset
//      point c (8) and the inverse isometry (per output coordinate: the
//      source position and its sign, 4 bits) in shared memory.
//   2. One warp per query: lane l scores candidates j = l + 32 r (r < 8)
//      from the staged table (two float4 a candidate, conflict-free) and
//      keeps the 8 weights as uint32 keys: bits(w) + 1 for a valid
//      candidate (w >= 0, so the float bits order as integers), 0 for the
//      padding, below everything.
//   3. The top-k in chunks of <= 32 outputs: an MSB-first radix select of
//      the chunk's count over the 256 keys (each step counts the keys at or
//      above the trial prefix with __reduce_add_sync, and stops as soon as
//      the count is exactly the chunk's), then the winners are every key
//      above the threshold and the first of the keys equal to it in
//      candidate order (r-major, then lane: the stable order of the plain
//      version's sort and of the TPU kernel's repeated argmax).  They are
//      compacted with ballots into a per-warp buffer, sorted by (w desc,
//      j asc) with one 32-lane bitonic network, and lane r of the chunk
//      runs the inverse isometry and encode of output r: coalesced stores.
//      The chunk's winners are dropped (key 0) before the next chunk.
//
// Where |t| has ties the comparator network breaks them by coordinate, as
// the plain version's stable argsort does: the same candidates and
// weights, and the same order among equal weights as the plain version.
//
// Distances use the TPU kernel's form |z|^2 - 2 z.c + |c|^2 with sums left
// to right and explicit round-to-nearest intrinsics (no FMA contraction):
// the plain version (repro_torch.core.lattice) adds in the same order, so
// both give the same weights bit for bit and pick the same top-k.
// d^2 / 8 is taken as d^2 * 0.125 (the same correctly rounded value).
// Rounding is rintf (half to even, as jnp.round); wrapping is a floored
// mod ((x % K) + K) % K, as jnp.mod.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 8;
constexpr int kPadded = 256;
constexpr int kValid = 232;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPerWarp = 32;  // a tile is at most one query a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTopBit = 29;  // keys <= bits(1.0f) + 1 < 2^30

struct Torus {
  int K[kDim];
};

__device__ __forceinline__ void decode_d8(const float (&u)[kDim],
                                          float (&r)[kDim]) {
  float worst_abs = -1.f, worst_delta = 0.f, sum = 0.f;
  int worst = 0;
#pragma unroll
  for (int i = 0; i < kDim; ++i) {
    r[i] = rintf(u[i]);
    const float d = __fsub_rn(u[i], r[i]);
    if (fabsf(d) > worst_abs) {  // first maximum, as argmax
      worst_abs = fabsf(d);
      worst = i;
      worst_delta = d;
    }
    sum += r[i];  // integer valued: exact in any order
  }
  if (static_cast<int>(sum) & 1) {
#pragma unroll
    for (int i = 0; i < kDim; ++i)
      if (i == worst) r[i] += worst_delta >= 0.f ? 1.f : -1.f;
  }
}

__device__ __forceinline__ float sq_dist8(const float (&a)[kDim],
                                          const float (&b)[kDim]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kDim; ++i) {
    const float e = __fsub_rn(a[i], b[i]);
    s = i == 0 ? __fmul_rn(e, e) : __fadd_rn(s, __fmul_rn(e, e));
  }
  return s;
}

__device__ __forceinline__ void decode_e8(const float (&q)[kDim],
                                          float (&c)[kDim]) {
  float ue[kDim], uo[kDim], even[kDim], odd[kDim];
#pragma unroll
  for (int i = 0; i < kDim; ++i) {
    ue[i] = __fmul_rn(q[i], 0.5f);
    uo[i] = __fmul_rn(__fsub_rn(q[i], 1.f), 0.5f);
  }
  decode_d8(ue, even);
  decode_d8(uo, odd);
#pragma unroll
  for (int i = 0; i < kDim; ++i) {
    even[i] = 2.f * even[i];
    odd[i] = 2.f * odd[i] + 1.f;
  }
  const bool use_even = sq_dist8(q, even) <= sq_dist8(q, odd);
#pragma unroll
  for (int i = 0; i < kDim; ++i) c[i] = use_even ? even[i] : odd[i];
}

// compare-exchange for a descending sort of key, carrying val and perm;
// equal keys keep the lower coordinate first, so the network's result is
// the plain version's stable argsort (the TPU kernel's network leaves
// equal keys where its comparators put them)
#define CX(i, j)                                                   \
  if (key[i] < key[j] || (key[i] == key[j] && perm[i] > perm[j])) { \
    float tk = key[i]; key[i] = key[j]; key[j] = tk; \
    float tv = val[i]; val[i] = val[j]; val[j] = tv; \
    int tp = perm[i]; perm[i] = perm[j]; perm[j] = tp; \
  }

// x mod K, floored: two compares for x in [-K, 2K) (the usual case: x is a
// candidate of a query in [0, K)), the % of a runtime K for any other x.
__device__ __forceinline__ int floor_mod(int x, int K) {
  const int y = x < 0 ? x + K : (x >= K ? x - K : x);
  if (__builtin_expect(static_cast<unsigned>(y) < static_cast<unsigned>(K),
                       1))
    return y;
  return ((x % K) + K) % K;
}

__device__ __forceinline__ int encode(const int (&x)[kDim], const Torus& T) {
  int u[kDim];
  int xm[kDim];
#pragma unroll
  for (int i = 0; i < kDim; ++i) xm[i] = floor_mod(x[i], T.K[i]);
  const int p = xm[0] & 1;
#pragma unroll
  for (int i = 0; i < kDim; ++i) u[i] = (xm[i] - p) >> 1;
  const int qpar = (u[0] + u[1] + u[2] + u[3] + u[4] + u[5] + u[6]) & 1;
  const int j8 = (u[7] - qpar) >> 1;
  int idx7 = u[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) idx7 = idx7 * (T.K[i] / 2) + u[i];
  return (idx7 * ((T.K[7] / 2) >> 1) + j8) * 2 + p;
}

// Stage 1 for one query: the coset point c, the canonical z and |z|^2, and
// the inverse isometry packed as 4 bits per output coordinate i: the
// sorted position d with perm[d] == i, and bit 3 set when its sign is -1.
__device__ __forceinline__ void canonicalise(const float* __restrict__ qt,
                                             float (&c)[kDim],
                                             float (&z)[kDim], float& znorm,
                                             uint32_t& inv) {
  float qv[kDim];
#pragma unroll
  for (int i = 0; i < kDim; ++i) qv[i] = qt[i];
  decode_e8(qv, c);
  // sort |t| descending, carrying t and the permutation
  float key[kDim], val[kDim];
  int perm[kDim];
#pragma unroll
  for (int i = 0; i < kDim; ++i) {
    val[i] = __fsub_rn(qv[i], c[i]);
    key[i] = fabsf(val[i]);
    perm[i] = i;
  }
  CX(0, 1) CX(2, 3) CX(4, 5) CX(6, 7)
  CX(0, 2) CX(1, 3) CX(4, 6) CX(5, 7)
  CX(1, 2) CX(5, 6)
  CX(0, 4) CX(1, 5) CX(2, 6) CX(3, 7)
  CX(2, 4) CX(3, 5)
  CX(1, 2) CX(3, 4) CX(5, 6)
  float sgn[kDim];
  float parity = 1.f;
#pragma unroll
  for (int i = 0; i < kDim; ++i) {
    sgn[i] = val[i] < 0.f ? -1.f : 1.f;
    parity *= sgn[i];
  }
  sgn[7] *= parity;
  znorm = 0.f;
  inv = 0u;
#pragma unroll
  for (int d = 0; d < kDim; ++d) {
    z[d] = sgn[d] * val[d];
    znorm = d == 0 ? __fmul_rn(z[d], z[d])
                   : __fadd_rn(znorm, __fmul_rn(z[d], z[d]));
    inv |= static_cast<uint32_t>(d | (sgn[d] < 0.f ? 8 : 0))
           << (4 * perm[d]);
  }
}

#undef CX

__global__ void __launch_bounds__(kThreads, 8)
lram_query_kernel(const float* __restrict__ q,
                  const float* __restrict__ cand,      // (2, 256, 4)
                  const float* __restrict__ cand_nsq,  // (256,)
                  int32_t* __restrict__ idx_out, float* __restrict__ w_out,
                  int n, int top_k, int per_warp, Torus torus) {
  // candidate j's coordinates 0-3 at s_cand[4j], 4-7 at s_cand[1024 + 4j]
  __shared__ __align__(16) float s_cand[2 * kPadded * 4];
  __shared__ float s_nsq[kPadded];
  __shared__ __align__(16) float s_z[kThreads][kDim];
  __shared__ __align__(16) float s_c[kThreads][kDim];
  __shared__ float s_zn[kThreads];
  __shared__ uint32_t s_inv[kThreads];
  __shared__ uint2 s_win[kWarps][32];  // a chunk's winners: (key, j)
  for (int i = threadIdx.x; i < 2 * kPadded * 4; i += kThreads)
    s_cand[i] = cand[i];
  for (int i = threadIdx.x; i < kPadded; i += kThreads)
    s_nsq[i] = cand_nsq[i];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const float4* s_lo = reinterpret_cast<const float4*>(s_cand);
  const float4* s_hi = s_lo + kPadded;
  const int tile = kWarps * per_warp;
  for (int t0 = blockIdx.x * tile; t0 < n; t0 += gridDim.x * tile) {
    __syncthreads();  // the table is staged, the last tile is read
    if (threadIdx.x < tile && t0 + threadIdx.x < n) {
      float c[kDim], z[kDim], znorm;
      uint32_t inv;
      canonicalise(q + static_cast<size_t>(t0 + threadIdx.x) * kDim, c, z,
                   znorm, inv);
      float4* zt = reinterpret_cast<float4*>(s_z[threadIdx.x]);
      float4* ct = reinterpret_cast<float4*>(s_c[threadIdx.x]);
      zt[0] = make_float4(z[0], z[1], z[2], z[3]);
      zt[1] = make_float4(z[4], z[5], z[6], z[7]);
      ct[0] = make_float4(c[0], c[1], c[2], c[3]);
      ct[1] = make_float4(c[4], c[5], c[6], c[7]);
      s_zn[threadIdx.x] = znorm;
      s_inv[threadIdx.x] = inv;
    }
    __syncthreads();

    for (int s = 0; s < per_warp; ++s) {
      const int qi = warp + kWarps * s;
      const int t = t0 + qi;
      if (t >= n) break;  // warp-uniform
      // scores of this lane's candidates j = lane + 32 r, as keys
      const float4 za = reinterpret_cast<const float4*>(s_z[qi])[0];
      const float4 zb = reinterpret_cast<const float4*>(s_z[qi])[1];
      const float zn = s_zn[qi];
      uint32_t key[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = lane + 32 * r;
        const float4 a = s_lo[j];
        const float4 b = s_hi[j];
        float cross = __fmul_rn(za.x, a.x);
        cross = __fadd_rn(cross, __fmul_rn(za.y, a.y));
        cross = __fadd_rn(cross, __fmul_rn(za.z, a.z));
        cross = __fadd_rn(cross, __fmul_rn(za.w, a.w));
        cross = __fadd_rn(cross, __fmul_rn(zb.x, b.x));
        cross = __fadd_rn(cross, __fmul_rn(zb.y, b.y));
        cross = __fadd_rn(cross, __fmul_rn(zb.z, b.z));
        cross = __fadd_rn(cross, __fmul_rn(zb.w, b.w));
        const float d2 =
            __fadd_rn(__fsub_rn(zn, __fmul_rn(2.f, cross)), s_nsq[j]);
        const float rl =
            fmaxf(0.f, __fsub_rn(1.f, __fmul_rn(d2, 0.125f)));
        const float r2 = __fmul_rn(rl, rl);
        key[r] = j < kValid ? __float_as_uint(__fmul_rn(r2, r2)) + 1u : 0u;
      }

      const size_t out0 = static_cast<size_t>(t) * top_k;
      for (int base = 0; base < top_k; base += 32) {
        const int kc = min(32, top_k - base);
        // radix select: lo ends as the kc-th largest key, unless a prefix
        // is found whose keys at or above it number exactly kc
        uint32_t lo = 0u;
        bool exact = false;
        for (int bit = kTopBit; bit >= 0; --bit) {
          const uint32_t trial = lo | (1u << bit);
          unsigned cnt = 0;
#pragma unroll
          for (int r = 0; r < 8; ++r) cnt += key[r] >= trial ? 1u : 0u;
          cnt = __reduce_add_sync(kFull, cnt);
          if (cnt >= static_cast<unsigned>(kc)) {
            lo = trial;
            if (cnt == static_cast<unsigned>(kc)) {
              exact = true;
              break;
            }
          }
        }
        // the winners: the keys above the threshold, then the first keys
        // equal to it in candidate order until there are kc
        const uint32_t above = exact ? lo : lo + 1u;
        int pos = 0;
        unsigned sel = 0;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const bool p = key[r] >= above;
          const unsigned b = __ballot_sync(kFull, p);
          if (p) {
            s_win[warp][pos + __popc(b & below)] =
                make_uint2(key[r], lane + 32 * r);
            sel |= 1u << r;
          }
          pos += __popc(b);
        }
        if (!exact) {
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const bool p = key[r] == lo;
            const unsigned b = __ballot_sync(kFull, p);
            const int at = pos + __popc(b & below);
            if (p && at < kc) {
              s_win[warp][at] = make_uint2(key[r], lane + 32 * r);
              sel |= 1u << r;
            }
            pos += __popc(b);
          }
        }
        __syncwarp();
        uint32_t mk = 0u;
        int mj = kPadded + lane;  // an empty place sorts after every winner
        if (lane < kc) {
          const uint2 e = s_win[warp][lane];
          mk = e.x;
          mj = static_cast<int>(e.y);
        }
        __syncwarp();
        // bitonic sort of the 32 places by (key desc, j asc)
#pragma unroll
        for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
          for (int h = k >> 1; h > 0; h >>= 1) {
            const uint32_t ok = __shfl_xor_sync(kFull, mk, h);
            const int oj = __shfl_xor_sync(kFull, mj, h);
            const bool other_first = ok > mk || (ok == mk && oj < mj);
            const bool hold_first = ((lane & k) == 0) == ((lane & h) == 0);
            if (other_first == hold_first) {
              mk = ok;
              mj = oj;
            }
          }
        }
        if (lane < kc) {
          // inverse isometry: x_i = c_i + sgn_d * cand[j][d], perm[d] = i
          const uint32_t inv = s_inv[qi];
          int x[kDim];
#pragma unroll
          for (int i = 0; i < kDim; ++i) {
            const uint32_t nib = (inv >> (4 * i)) & 15u;
            const int d = nib & 7u;
            const float p =
                s_cand[(d >> 2) * (kPadded * 4) + mj * 4 + (d & 3)];
            x[i] =
                __float2int_rn(__fadd_rn(s_c[qi][i], (nib & 8u) ? -p : p));
          }
          idx_out[out0 + base + lane] = encode(x, torus);
          w_out[out0 + base + lane] = __uint_as_float(mk - 1u);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if ((sel >> r) & 1u) key[r] = 0u;
        __syncwarp();  // s_win is rewritten by the next chunk
      }
    }
  }
}

}  // namespace

extern "C" int lram_query_f32(const void* q, const void* cand,
                              const void* cand_nsq, void* idx, void* w,
                              int n, int top_k, const int* wrap, int device,
                              void* stream) {
  cudaSetDevice(device);
  if (n > 0) {
    static int sms = 0;
    if (sms == 0) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         device);
    Torus torus;
    for (int i = 0; i < kDim; ++i) torus.K[i] = wrap[i];
    // queries a warp takes: one until n passes 4,096, then as many as keep
    // about 4,096 warps (one per query would stage the table per 4 queries)
    int per_warp = 1;
    while (per_warp < kMaxPerWarp && n > 4096 * per_warp) per_warp *= 2;
    const int tile = kWarps * per_warp;
    const int blocks = min((n + tile - 1) / tile, 16 * (sms > 0 ? sms : 132));
    lram_query_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(cand),
        static_cast<const float*>(cand_nsq), static_cast<int32_t*>(idx),
        static_cast<float*>(w), n, top_k, per_warp, torus);
  }
  return static_cast<int>(cudaGetLastError());
}
