// The weighted row gather of K1 (csrc/gather_interp.cu), B4
// (csrc/gather_interp_quant.cu), B5 and B6 (csrc/tiered_gather.cu) and
// row 9 (the range gather, csrc/sharded_gather.cu), redesigned for the
// H100:
//
//   out[t] = sum_k  w[t,k] * (scale[r] if scaled) * values[r],
//            r = row_map(idx[t,k])
//
// with the row payloads and row maps of gather_rows.cuh (fp32
// accumulate; a 1-byte row's scale folded into its weight; a row mapped
// below 0 gives NaN; a masking row map's "not mine" adds nothing and its
// row is not read).  lookup_bwd.cu's instances without scatter have a
// batched body of their own.
//
// Bound: bytes (each distinct row read once, the indices, weights and
// output; the 2*n*k*m flops are far below the fp32 rate: at n = 128,
// top-32, m = 64, 0.00033 ms for an fp32 table, 0.00010 for a 1-byte
// one at 3.35 TB/s).  The warp-per-query body these kernels ran before
// was latency-bound at decode sizes: a warp walked its query's 32 rows in
// unroll-8 batches, about five dependent memory round trips a query, and
// at n = 128 its 16 blocks left most of the 132 SMs idle: 0.0077 ms for
// K1, 0.0082 for B4, 0.0078 for B5 and 0.0083 for B6 (int8) there, where
// this body takes 0.0024, 0.0023, 0.0026 and 0.0027 (device time,
// tools/kernel_ab.py on an NVIDIA H100 80GB HBM3 at 700.00 W).  This one:
//   * a warp loads its candidates' indices and weights once (lane l holds
//     candidate l) and maps them to table rows;
//   * with a masking row map (row 9) the warp compacts the candidates to
//     this shard's, in candidate order (__ballot_sync, then lane p takes
//     the p-th set bit's candidate): no shuffle, branch or read is spent
//     on another rank's row, and the sum keeps its order;
//   * it issues kBatch = 8 row loads (two adjacent columns a lane, 256
//     bytes a row at m = 64 fp32) before the first multiply-add, with no
//     branch around a load (a load past the count reads candidate 0's row
//     and is not added; a lane past the row's end reads the last pair), and
//     turns 1-byte payloads into fp32 only after the batch's loads are out
//     (a conversion beside its load waits for it);
//   * where n is too small for one warp a query to fill the card, `split`
//     warps of a block share a query, each summing a contiguous part of
//     its candidates in order; the parts are added in a fixed warp order
//     through shared memory and the output row is written once, so the
//     result is deterministic for a given n.  With split = 1 a warp sums
//     its query in candidate order, as the old body did: the same fp32
//     operations in the same order, so K1's and B5's outputs, and B4's
//     and B6's on byte pairs, are bit-equal to the old kernels';
//   * one kernel instance per (split == 1, m even) pair, so each holds
//     only its own path's registers: at most 64 (4 blocks of 8 warps an
//     SM), none spilled; the range gather's one-warp instances 32 (see
//     sharded_gather.cu; its odd-m ones spill a little), B5's and B6's
//     48 (see tiered_gather.cu).  Clustered
//     queries (training's) are L2-bound, where the old body's 32
//     registers ran 64 warps an SM;
//   * kWide (B4 and B6, 1-byte rows with m % 8 == 0 and an 8-byte aligned
//     table, fits_wide): 8 bytes a lane, so 8 lanes cover a 64-column
//     chunk of a row and one warp load serves 4 rows (lane group l >> 3
//     sums candidates l >> 3, + 4, + 8, ... in order); kBatch loads then
//     put 32 rows in flight, and the 4 groups' sums are added at the end
//     by 2 __shfl_xor_sync steps.  It adds in another order than kWide =
//     false (rtol 2e-5 / atol 1e-6 against the plain version on K2's
//     weights, not bit-equal);
//   * kWide with kInOrder (B6): the same wide loads, but a batch's 32 rows
//     go through a 2 KiB tile of the warp's in shared memory and each lane
//     then adds its two columns in candidate order, as byte pairs do:
//     bit-equal to byte pairs at the same split.  With 32 weights of up to
//     1 each the 4 groups' order strayed from the plain version's
//     candidate order by 1.2e-6 on a sum near 0, past atol 1e-6.
// Tried and dropped (PERF.md): 16 or 32 row loads in flight, or
// 4-12 under a 32-48 register cap (tools/gather_sweep.py: spills, fewer
// blocks an SM, or slower on uniform queries); running the queries in the
// order of their top row (tools/csrc/query_order.cu, tools/kernel_ab.py
// --phases order: faster on uniform queries, slower on clustered ones).

#pragma once

#include <stdint.h>

#include <type_traits>

#include "gather_rows.cuh"

namespace gather_batched {

using gather_rows::kFull;
using gather_rows::kNotMine;
using gather_rows::Payload;

constexpr int kWarps = 8;     // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplit = 8;  // warps a query at most (kWarps divides)
constexpr int kBatch = 8;     // row loads a warp issues before its FMAs
constexpr int kMinBlocks = 4;  // blocks an SM holds: at most 64 registers

// Two adjacent columns of a row as stored (an fp32 pair, a bf16 or fp16
// pair, two int8, two e4m3), loaded first and turned into fp32 only once the
// batch's loads are out: a conversion next to its load would wait for it.
template <typename T>
struct Raw;

template <>
struct Raw<float> {
  using Pair = float2;
  static __device__ __forceinline__ Pair pair(const float* r, int c) {
    return *reinterpret_cast<const float2*>(r + c);
  }
  static __device__ __forceinline__ float2 f32(Pair v) { return v; }
};

template <>
struct Raw<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static __device__ __forceinline__ Pair pair(const __nv_bfloat16* r,
                                              int c) {
    return *reinterpret_cast<const __nv_bfloat162*>(r + c);
  }
  static __device__ __forceinline__ float2 f32(Pair v) {
    return __bfloat1622float2(v);  // exact: every bf16 value is a float
  }
};

template <>
struct Raw<__half> {
  using Pair = __half2;
  static __device__ __forceinline__ Pair pair(const __half* r, int c) {
    return *reinterpret_cast<const __half2*>(r + c);
  }
  static __device__ __forceinline__ float2 f32(Pair v) {
    return __half22float2(v);  // exact: every fp16 value is a float
  }
};

template <>
struct Raw<int8_t> {
  using Pair = char2;
  static __device__ __forceinline__ Pair pair(const int8_t* r, int c) {
    return *reinterpret_cast<const char2*>(r + c);
  }
  static __device__ __forceinline__ float2 f32(Pair v) {
    return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
  }
};

template <>
struct Raw<__nv_fp8_e4m3> {
  using Pair = __nv_fp8x2_e4m3;
  static __device__ __forceinline__ Pair pair(const __nv_fp8_e4m3* r,
                                              int c) {
    return *reinterpret_cast<const __nv_fp8x2_e4m3*>(r + c);
  }
  static __device__ __forceinline__ float2 f32(Pair v) {
    return static_cast<float2>(v);  // exact: every e4m3 value is a float
  }
};

// Eight adjacent columns of a 1-byte row, loaded as one 8-byte word and
// turned into fp32 only once the batch's loads are out (kWide).
template <typename T>
struct Raw8;

template <>
struct Raw8<int8_t> {
  static __device__ __forceinline__ void f32(uint2 v, float (&f)[8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // byte i, sign-extended
      f[i] = static_cast<float>(static_cast<int>(v.x << (24 - 8 * i)) >> 24);
      f[i + 4] =
          static_cast<float>(static_cast<int>(v.y << (24 - 8 * i)) >> 24);
    }
  }
};

template <>
struct Raw8<__nv_fp8_e4m3> {
  static __device__ __forceinline__ void f32(uint2 v, float (&f)[8]) {
    const unsigned words[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // pairs of bytes, as Raw's
      __nv_fp8x2_e4m3 p;
      p.__x = static_cast<__nv_fp8x2_storage_t>(words[i >> 1] >>
                                                (16 * (i & 1)));
      const float2 x = static_cast<float2>(p);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

constexpr int kWideRows = 4;  // rows one warp load serves (kWide, m = 64)

// The position of the p-th (from 0) set bit of mask, which has more than p.
__device__ __forceinline__ int nth_set_bit(unsigned mask, int p) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width > 0; width >>= 1) {
    const int c = __popc((mask >> pos) & ((1u << width) - 1u));
    if (p >= c) {
      p -= c;
      pos += width;
    }
  }
  return pos;
}

// Warps a query: the least power of two that gives every SM 4 warps,
// while each warp keeps at least min_per_warp candidates (4; the wide
// loads of B4 and B6 32, one batch of kBatch loads of kWideRows rows).
// On the H100 n = 128 takes 8 (4 and 8 time alike, 1 and 2 slower); from
// n = 528 on a query has one warp (at n = 2,048 one and two time alike, 4
// and 8 slower).  With the wide loads one warp a query was fastest at
// n = 128 and 2,048 (0.0023 ms against 0.0026-0.0028 split).
// tools/kernel_ab.py --phases k1, b4, b5 and b6 time every split.
inline int split_for(int n, int top_k, int sm_count, int min_per_warp = 4) {
  const long long want = 4LL * sm_count;
  int split = 1;
  while (split < kMaxSplit && static_cast<long long>(n) * split < want &&
         2 * min_per_warp * split <= top_k)
    split *= 2;
  return split;
}

// Whether the wide loads (kWide) fit a 1-byte table: 8-byte words of
// whole 8-column groups.
inline bool fits_wide(const void* values, int m) {
  return m % 8 == 0 && reinterpret_cast<uintptr_t>(values) % 8 == 0;
}

inline int blocks_for(int n, int split) {
  const int per_block = kWarps / split;
  return min((n + per_block - 1) / per_block, 65535);
}

inline int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cached[device] = sms > 0 ? sms : 132;
  }
  return cached[device];
}

// Adds rows 0 .. cnt - 1 of the warp's candidates (lane j holds row j and
// its weight) at columns c, c + 1 to (ax, ay), in order, kBatch row loads
// at a time.  kPairs (m even, so pair loads stay aligned):
// one load a row, of the raw pair; else (m odd) two loads, converted at
// once.  A lane past the row's end reads its last pair and adds nothing
// it stores; a load past cnt reads candidate 0's row and is not added.
template <typename T, bool kPairs>
__device__ __forceinline__ void add_rows(const T* __restrict__ values,
                                         int m, int c, int my_row,
                                         float my_w, int cnt, float& ax,
                                         float& ay) {
  using Pair = typename std::conditional<kPairs, typename Raw<T>::Pair,
                                         float2>::type;
  const int cx = kPairs ? min(c, m - 2) : min(c, m - 1);
  const int cy = min(c + 1, m - 1);
  for (int jb = 0; jb < cnt; jb += kBatch) {
    Pair v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = jb + u < cnt ? jb + u : 0;
      const T* vr = values + static_cast<int64_t>(
                                 __shfl_sync(kFull, my_row, j)) * m;
      if constexpr (kPairs) {
        v[u] = Raw<T>::pair(vr, cx);
      } else {
        v[u] = make_float2(Payload<T>::one(vr, cx),
                           Payload<T>::one(vr, cy));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (jb + u < cnt) {  // warp-uniform
        const float wj = __shfl_sync(kFull, my_w, jb + u);
        float2 f;
        if constexpr (kPairs) {
          f = Raw<T>::f32(v[u]);
        } else {
          f = v[u];
        }
        ax = fmaf(wj, f.x, ax);
        ay = fmaf(wj, f.y, ay);
      }
    }
  }
}

// add_rows with 8 columns a lane (kWide): lane group grp = lane >> 3 adds
// rows grp, grp + 4, ... of candidates 0 .. cnt - 1 at columns c .. c + 7
// to a, in order, kBatch loads (4 rows each) at a time.  A lane past the
// row's end reads its last 8 columns and adds nothing it stores; a load
// past cnt reads candidate 0's row and is not added.
template <typename T>
__device__ __forceinline__ void add_rows_wide(const T* __restrict__ values,
                                              int m, int c, int grp,
                                              int my_row, float my_w, int cnt,
                                              float (&a)[8]) {
  const int cc = min(c, m - 8);
  for (int jb = 0; jb < cnt; jb += kBatch * kWideRows) {
    uint2 v[kBatch];
    float wv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = jb + u * kWideRows + grp;
      const int src = j < cnt ? j : 0;
      const T* vr = values + static_cast<int64_t>(
                                 __shfl_sync(kFull, my_row, src)) * m;
      v[u] = *reinterpret_cast<const uint2*>(vr + cc);
      wv[u] = __shfl_sync(kFull, my_w, src);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (jb + u * kWideRows + grp < cnt) {
        float f[8];
        Raw8<T>::f32(v[u], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = fmaf(wv[u], f[i], a[i]);
      }
    }
  }
}

// add_rows' sum on add_rows_wide's loads (kWide with kInOrder): the
// 8-byte words of a batch's rows go through the warp's tile in shared
// memory, and the lane then adds columns c, c + 1 of rows 0 .. cnt - 1
// (cnt <= 32) in order: add_rows' fp32 operations in add_rows' order, with
// a quarter of its loads.  Every word of the tile is written each batch (a
// lane past the row's end writes its last 8 columns), so a lane past the
// row's end reads initialized bytes and stores nothing.
template <typename T>
__device__ __forceinline__ void add_rows_wide_in_order(
    const T* __restrict__ values, int m, int c0, int lane, int my_row,
    float my_w, int cnt, float& ax, float& ay) {
  constexpr int kRows = kBatch * kWideRows;  // rows a batch: 32
  __shared__ uint2 tile[kWarps][kRows][8];   // a warp's rows, 64 bytes each
  uint2(*rows)[8] = tile[threadIdx.x >> 5];
  const int grp = lane >> 3, col = lane & 7;
  const int cc = min(c0 + 8 * col, m - 8);
  uint2 v[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int j = u * kWideRows + grp;
    const T* vr = values + static_cast<int64_t>(__shfl_sync(
                               kFull, my_row, j < cnt ? j : 0)) * m;
    v[u] = *reinterpret_cast<const uint2*>(vr + cc);
  }
  __syncwarp();  // the last chunk's reads of the tile are done
#pragma unroll
  for (int u = 0; u < kBatch; ++u) rows[u * kWideRows + grp][col] = v[u];
  __syncwarp();
  using Pair = typename Raw<T>::Pair;
  const Pair* mine = reinterpret_cast<const Pair*>(rows[0]) + lane;
  auto add = [&](int j) {
    const float wj = __shfl_sync(kFull, my_w, j);
    const float2 f = Raw<T>::f32(mine[j * 32]);  // 32 pairs a row
    ax = fmaf(wj, f.x, ax);
    ay = fmaf(wj, f.y, ay);
  };
  if (cnt == kRows) {  // warp-uniform; no guard, so the tile's reads can
#pragma unroll         // go out ahead of the chain of FMAs
    for (int j = 0; j < kRows; ++j) add(j);
  } else {
    for (int j = 0; j < cnt; ++j) add(j);
  }
}

// The body of one kernel instance: kOneWarp (split == 1), kPairs (m even),
// kWide and kInOrder are fixed at compile time, so an instance holds one
// path's registers only.
template <typename T, bool kScaled, bool kOneWarp, bool kPairs,
          bool kWide = false, bool kInOrder = false, typename RowMap>
__device__ __forceinline__ void gather(
    const T* __restrict__ values, const float* __restrict__ scale,
    const int32_t* __restrict__ idx, const float* __restrict__ w,
    float* __restrict__ out, int n, int top_k, int m, int split_arg,
    RowMap row_map) {
  __shared__ float2 part[kWarps][32];  // one 64-column chunk's partials
  // the wide loads' 4 lane groups, each summing its own rows (not kInOrder)
  constexpr bool kGroups = kWide && !kInOrder;
  const int split = kOneWarp ? 1 : split_arg;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_block = kWarps / split;
  const int slot = warp / split, piece = warp % split;
  const int chunk = (top_k + split - 1) / split;
  const int k_lo = min(top_k, piece * chunk);
  const int k_hi = min(top_k, k_lo + chunk);
  // block-uniform trip count: every warp reaches the __syncthreads below
  for (int tb = blockIdx.x * per_block; tb < n;
       tb += gridDim.x * per_block) {
    const int i = tb + slot;
    const bool live = i < n;
    const int t = live ? i : 0;
    const int32_t* it = idx + static_cast<int64_t>(t) * top_k;
    const float* wt = w + static_cast<int64_t>(t) * top_k;
    float* ot = out + static_cast<int64_t>(t) * m;
    for (int c0 = 0; c0 < m; c0 += 64) {
      const int c = c0 + (kGroups ? 8 * (lane & 7) : 2 * lane);
      float ax = 0.f, ay = 0.f;
      float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // kGroups
      for (int kb = k_lo; live && kb < k_hi; kb += 32) {
        const int kk = kb + lane;
        int my_row = 0;  // a row fits int32: each wrapper refuses 2^31 rows
        float my_w = 0.f;
        bool mine = false;
        if (kk < k_hi) {
          const int64_t row = row_map(it[kk]);
          my_w = wt[kk];
          mine = !(RowMap::kMasked && row == kNotMine);
          if (mine && row < 0) {
            my_w = __int_as_float(0x7fc00000);  // NaN marks the row
          } else if (mine) {
            my_row = static_cast<int>(row);
            if (kScaled) my_w *= scale[row];
          }
        }
        int cnt = min(32, k_hi - kb);
        if (RowMap::kMasked) {  // this shard's candidates, in order
          const unsigned ball = __ballot_sync(kFull, mine);
          cnt = __popc(ball);
          const int src = lane < cnt ? nth_set_bit(ball, lane) : lane;
          my_row = __shfl_sync(kFull, my_row, src);
          my_w = __shfl_sync(kFull, my_w, src);
        }
        if constexpr (kGroups) {
          add_rows_wide<T>(values, m, c, lane >> 3, my_row, my_w, cnt, a);
        } else if constexpr (kWide) {
          add_rows_wide_in_order<T>(values, m, c0, lane, my_row, my_w, cnt,
                                    ax, ay);
        } else {
          add_rows<T, kPairs>(values, m, c, my_row, my_w, cnt, ax, ay);
        }
      }
      if constexpr (kGroups) {
        // the 4 row groups' sums, on every lane
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          a[i] += __shfl_xor_sync(kFull, a[i], 8);
          a[i] += __shfl_xor_sync(kFull, a[i], 16);
        }
        float* pw = reinterpret_cast<float*>(part[warp]) + 8 * (lane & 7);
        if (!kOneWarp && split > 1) {  // the parts in warp order, once
          if (lane < 8) {
#pragma unroll
            for (int i = 0; i < 8; ++i) pw[i] = a[i];
          }
          __syncthreads();
          if (piece == 0) {
            for (int s = 1; s < split; ++s) {
              const float* ps = pw + s * 64;  // part[warp + s], same lane
#pragma unroll
              for (int i = 0; i < 8; ++i) a[i] += ps[i];
            }
          }
          __syncthreads();
        }
        if (live && piece == 0 && lane < 8 && c < m) {
          *reinterpret_cast<float4*>(ot + c) =
              make_float4(a[0], a[1], a[2], a[3]);
          *reinterpret_cast<float4*>(ot + c + 4) =
              make_float4(a[4], a[5], a[6], a[7]);
        }
      } else {
        if (!kOneWarp && split > 1) {  // the parts in warp order, once
          part[warp][lane] = make_float2(ax, ay);
          __syncthreads();
          if (piece == 0) {
            for (int s = 1; s < split; ++s) {
              const float2 p = part[warp + s][lane];
              ax += p.x;
              ay += p.y;
            }
          }
          __syncthreads();
        }
        if (live && piece == 0) {
          if (c < m) ot[c] = ax;
          if (c + 1 < m) ot[c + 1] = ay;
        }
      }
    }
  }
}

}  // namespace gather_batched
