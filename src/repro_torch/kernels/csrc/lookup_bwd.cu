// The lookup's backward: one warp-per-query body for dw or dq, templated
// on the row payload (fp32; int8 or e4m3 with one fp32 scale per row) and
// on a row range, and a segmented scatter of the table's gradient for the
// fp32 instances that train a dense table or a row shard of one.
//
// Per query t and candidate k, with r = rows[t,k] the row the forward read
// (a dense table's index itself, or a tiered store's row in its flat table
// of cache + overflow rows) and i = idx[t,k] the lattice index:
//
//   dw[t,k]  = g[t] . values[r]              (fp32 rows)
//            = scale[r] * (g[t] . q[r])      (1-byte rows: dequantized in
//                                             registers, the scale applied
//                                             once to the warp's dot)
//   dq[t] = sum_k dw[t,k] * relu_k^3 * (-delta_k)   (kDq)
//   dvalues[r] = sum over (t,k) with rows[t,k] = r of w[t,k] * g[t]
//                                            (the scatter instances)
//
// with delta_k = q[t] - x_k on the nearest torus image of the lattice
// point x_k that i names, relu_k = max(0, 1 - |delta_k|^2 / 8): the
// analytic derivative of w = relu^4.  The instances:
//
//   fp32, scatter, dq   lookup_bwd_dq_f32: B3's backward (replaces
//     _lookup_bwd of src/repro/kernels/ops.py, lram_lookup; K2 + K1
//     forward, pallas_call sites e8_lookup.py:189 and gather_interp.py:73).
//   fp32, scatter, dw   lookup_bwd_dw_f32: B1's VJP (replaces _vjp_bwd of
//     src/repro/kernels/gather_interp.py, gather_interp_vjp, :206).
//     Both write the whole dense (N, m) fp32 dvalues (the reference's
//     jnp.zeros(...).at[idx].add), untouched rows as zeros.
//   fp32, no scatter, dq / dw   lookup_bwd_rows_{dq,dw}_f32: the tiered
//     fp32 table (its gradient goes to the store's host write-back, not to
//     a dense dvalues; the reference's tiered VJP, src/repro/memstore/
//     interp.py:99-112, whose dw is B1's).
//   int8 / e4m3, no scatter, dw   lookup_bwd_rows_dw_{i8,e4m3}: B4's VJP
//     (replaces _quant_bwd of src/repro/kernels/gather_interp.py,
//     gather_interp_quant, :165-179; forward pallas_call at :138); the
//     table is frozen or trains through the tiered write-back.
//   int8 / e4m3, no scatter, dq   lookup_bwd_rows_dq_{i8,e4m3}: the same
//     finished with dq, the backward of the dense 1-byte table's joined
//     lookup and of the tiered lram-tiered-q8 training path.
//   over a row range   lookup_bwd_range_{dq,dw}_{f32,i8,e4m3}: row 9's
//     backward, on one rank's row-range shard [base, base + rows) of the
//     table (replaces the autodiff of the shard-local gathers of
//     src/repro/distributed/sharded_lram.py, sharded_gather_interp,
//     :62-136: gather_interp_vjp's backward :206 and gather_interp_quant's
//     :165-179, through shard_map).  Only the in-range k count: the row
//     read is r = idx - base, the fp32 instances scatter w_k * g into the
//     shard's own (rows, m) dvalues, and dw / dq are the PARTIAL sums over
//     the in-range k (dw_k = 0 for the others; dq is linear in the per-k
//     terms, so the sum of the partials over the `model` ranks is the full
//     dq, one all-reduce outside the kernel).  An out-of-range row is not
//     read: the warp skips it, as the range gather does.  Their bound
//     counts the in-range distinct rows and the shard's dvalues.
//
// Bound on an H100: bytes, at 3.35 TB/s.  Every distinct row the forward
// read is read once (4m bytes for fp32, m + 4 for a 1-byte row and its
// scale), plus g (4m a query), idx, rows and w (4k each; rows only where
// they are not idx), q (32) and the output (32 or 4k); the scatter
// instances write dvalues once (4Nm bytes: 256 MiB at full width).  The
// 2·n·k·m flops are far below the fp32 rate.
//
// Design of the instances without scatter: one warp per query row,
// grid-stride over rows, 8 warps a block (the gather's layout,
// gather_rows.cuh).  Each lane keeps two columns of g[t] in registers per
// 64-column chunk (m <= 256).  Lane l loads rows[t, l] (and, for dq,
// idx[t, l]; for 1-byte rows, the row's scale), 32 at a time, and the warp
// broadcasts the row with __shfl_sync.  For each of the k rows the warp
// reads the row once (a float2, or two bytes converted in registers, per
// lane; coalesced), forms its part of g . row and sums it with a 5-step
// __shfl_xor_sync butterfly (on every lane).  Lane k keeps dw_k (times its
// row's scale for a 1-byte payload).  For dq, lane k then decodes idx_k
// into its lattice point with the integer ops of the plain version's
// points_from_indices, takes the nearest-image delta, d^2 and relu^3
// (explicit round-to-nearest, no FMA, as the plain version computes them),
// and the warp sums dw_k·relu_k^3·(-delta_k) over k with one butterfly per
// component; lane 0 writes dq[t].
//
// Design of the scatter instances: a counting sort of the n·k pairs (row,
// t, k) by row, then passes over the sorted pairs that do the scatter and
// dw at once, then dq from dw.  No fp32 atomics per pair on dvalues:
// scattered 4- or 16-byte reductions into a 256 MiB table miss L2 and were
// most of the previous kernel's time (the 16-byte ones cut it by a
// quarter only).  Each row of dvalues is written once, or zeroed and then
// added to a few times where its pairs straddle warps, so the call needs
// no zero fill of dvalues; and each row of values is read once per run of
// its pairs, not once per pair.  The kernels,
// lookup_bwd_scatter_{count,scan,blocks,place,zero,sum,dq}_kernel:
//   count   counts[r] += 1 per in-range pair (int atomics into a 4 MiB
//           array that stays in L2; the scratch's counts zeroed first);
//   scan    an exclusive prefix sum of counts in blocks of 4096 rows
//           (block-local offsets, then one block scans the block totals
//           and writes the pairs' total);
//   place   entries[start[r]++ + block offset] = t << 8 | k (int atomics;
//           k < 256, t < 2^23);
//   zero    the rows no warp of the sum stores whole: no pairs, or pairs
//           cut by a boundary of the sum's chunks;
//   sum     a warp per chunk of 32 sorted pairs, whatever rows they hit
//           (a row many pairs hit, as training's queries do, spreads over
//           many warps): for each run of one row, values[r] read once,
//           dvalues[r] summed in registers (g, 16 MiB at n = 65536, stays
//           in L2) and stored, or added atomically where the run is part
//           of a cut row; dw[t,k] = g[t] . values[r], each lane's part
//           staged in shared memory and summed a pair a lane;
//   dq      a warp per query: the body's dq from idx, q and that dw.
// A row's dvalues sum runs in placement order, which the atomics set: its
// fp32 rounding may differ from run to run (the tests' atol 1e-5); dw and
// dq add in another order than the instances without scatter (rtol 1e-4).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "gather_rows.cuh"

namespace {

constexpr int kDim = 8;
constexpr int kWarps = 8;
constexpr int kMaxChunks = 4;  // m <= 256 (the wrapper checks)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kRadiusSq = 8.f;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kScanBlock = kScanThreads * kScanItems;  // rows a scan block
constexpr int kFlatThreads = 256;

struct Torus {
  int K[kDim];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The lattice point (in [0, K)) of a flat torus index: the inverse of the
// mixed-radix encode, M_i = K_i / 2, idx >= 0 so / and % are floored.
__device__ __forceinline__ void point_of(int32_t idx, const Torus& torus,
                                         float (&x)[kDim]) {
  const int p = idx & 1;
  const int r = idx >> 1;
  const int half = (torus.K[7] >> 1) >> 1;
  const int j8 = r % half;
  int idx7 = r / half;
  int u[kDim];
  int parity = 0;
#pragma unroll
  for (int i = kDim - 2; i >= 0; --i) {
    const int mi = torus.K[i] >> 1;
    u[i] = idx7 % mi;
    idx7 /= mi;
    parity += u[i];
  }
  u[kDim - 1] = 2 * j8 + (parity & 1);
#pragma unroll
  for (int i = 0; i < kDim; ++i) x[i] = static_cast<float>(2 * u[i] + p);
}

// acc += dw_k * relu_k^3 * (-delta_k) for one candidate at lattice point
// x: the nearest-image delta, d^2 and relu^3 with explicit round-to-
// nearest and no FMA, as the plain version computes them.
__device__ __forceinline__ void dq_terms(const float (&x)[kDim], float dw_k,
                                         const float (&qt)[kDim],
                                         const Torus& torus,
                                         float (&acc)[kDim]) {
  float delta[kDim];
  float d2 = 0.f;
#pragma unroll
  for (int i = 0; i < kDim; ++i) {
    const float kf = static_cast<float>(torus.K[i]);
    float d = __fsub_rn(qt[i], x[i]);
    d = __fsub_rn(d, __fmul_rn(kf, rintf(__fdiv_rn(d, kf))));
    delta[i] = d;
    d2 = __fadd_rn(d2, __fmul_rn(d, d));
  }
  const float relu = fmaxf(0.f, __fsub_rn(1.f, d2 / kRadiusSq));
  const float coef = __fmul_rn(dw_k, __fmul_rn(__fmul_rn(relu, relu), relu));
#pragma unroll
  for (int i = 0; i < kDim; ++i)
    acc[i] = __fadd_rn(acc[i], __fmul_rn(coef, -delta[i]));
}

template <typename T, bool kDq, bool kRange>
__global__ void __launch_bounds__(kWarps * 32)
lookup_bwd_kernel(const T* __restrict__ values,
                  const float* __restrict__ scale,
                  const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ g, const float* __restrict__ q,
                  float* __restrict__ dsmall, int n, int top_k, int m,
                  Torus torus, int base, int range_rows) {
  constexpr bool kScaled = !std::is_same<T, float>::value;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = (m + 63) / 64;
  for (int t = blockIdx.x * kWarps + warp; t < n; t += gridDim.x * kWarps) {
    const int32_t* rt = rows + static_cast<int64_t>(t) * top_k;
    const int32_t* it = idx + static_cast<int64_t>(t) * top_k;
    const float* gt = g + static_cast<int64_t>(t) * m;
    float2 gr[kMaxChunks];
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch) {
      const int c = ch * 64 + 2 * lane;
      gr[ch] = (ch < chunks && c < m)
                   ? *reinterpret_cast<const float2*>(gt + c)
                   : make_float2(0.f, 0.f);
    }
    float qt[kDim];
    float acc[kDim];
#pragma unroll
    for (int i = 0; i < kDim; ++i) {
      qt[i] = kDq ? q[static_cast<int64_t>(t) * kDim + i] : 0.f;
      acc[i] = 0.f;
    }
    for (int kb = 0; kb < top_k; kb += 32) {
      const int kk = kb + lane;
      int32_t my_row = 0;
      int32_t my_idx = 0;
      float my_scale = 1.f;
      if (kk < top_k) {
        my_row = rt[kk];
        if (kRange) {  // -1: not this shard's row (a 0 term, not read)
          my_row -= base;
          if (static_cast<uint32_t>(my_row) >=
              static_cast<uint32_t>(range_rows))
            my_row = -1;
        }
        if (kDq) my_idx = it[kk];
        if (kScaled && my_row >= 0) my_scale = scale[my_row];
      }
      const int cnt = min(32, top_k - kb);
      float my_dw = 0.f;
      for (int j = 0; j < cnt; ++j) {
        const int64_t row = __shfl_sync(kFull, my_row, j);
        if (kRange && row < 0) continue;  // warp-uniform; dw_j stays 0
        const T* vr = values + row * m;
        float part = 0.f;
#pragma unroll
        for (int ch = 0; ch < kMaxChunks; ++ch) {
          const int c = ch * 64 + 2 * lane;
          if (ch < chunks && c < m) {
            const float2 v = gather_rows::Payload<T>::pair(vr, c);
            part = fmaf(gr[ch].x, v.x, part);
            part = fmaf(gr[ch].y, v.y, part);
          }
        }
        const float dwj = warp_sum(part);
        if (lane == j) my_dw = kScaled ? my_scale * dwj : dwj;
      }
      if (kk < top_k) {
        if (kDq) {
          float x[kDim];
          point_of(my_idx, torus, x);
          dq_terms(x, my_dw, qt, torus, acc);
        } else {
          dsmall[static_cast<int64_t>(t) * top_k + kk] = my_dw;
        }
      }
    }
    if (kDq) {
#pragma unroll
      for (int i = 0; i < kDim; ++i) {
        const float s = warp_sum(acc[i]);
        if (lane == 0) dsmall[static_cast<int64_t>(t) * kDim + i] = s;
      }
    }
  }
}

// ---------------------------------------------------------------- scatter

int scan_blocks_for(int rows) { return (rows + kScanBlock - 1) / kScanBlock; }

// The scatter's scratch (32-bit words): counts [rows] | start [rows] | the
// scan blocks' offsets and the pairs' total [blocks + 1] | entries [n k] |
// dw [n k] (fp32, the dq instances' own).
struct Scatter {
  int32_t* counts;
  int32_t* start;
  int32_t* block;
  int32_t* entries;
  float* dw;
  int blocks;

  Scatter(void* scratch, int n, int top_k, int rows)
      : counts(static_cast<int32_t*>(scratch)),
        start(counts + rows),
        block(start + rows),
        entries(block + scan_blocks_for(rows) + 1),
        dw(reinterpret_cast<float*>(entries +
                                    static_cast<int64_t>(n) * top_k)),
        blocks(scan_blocks_for(rows)) {}
};

// The row of flat pair f in the table (or the shard), -1 out of range.
template <bool kRange>
__device__ __forceinline__ int32_t row_of(const int32_t* __restrict__ idx,
                                          int64_t f, int base,
                                          int range_rows) {
  int32_t r = idx[f];
  if (kRange) {
    r -= base;
    if (static_cast<uint32_t>(r) >= static_cast<uint32_t>(range_rows))
      r = -1;
  }
  return r;
}

template <bool kRange>
__global__ void __launch_bounds__(kFlatThreads)
lookup_bwd_scatter_count_kernel(const int32_t* __restrict__ idx,
                                int64_t pairs, int base, int rows,
                                int32_t* counts) {
  for (int64_t f = blockIdx.x * static_cast<int64_t>(kFlatThreads) +
                   threadIdx.x;
       f < pairs; f += static_cast<int64_t>(gridDim.x) * kFlatThreads) {
    const int32_t r = row_of<kRange>(idx, f, base, rows);
    if (r >= 0) atomicAdd(counts + r, 1);
  }
}

// Exclusive prefix sum of v over a block of kScanThreads; total = the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    s_warp[lane] = s;
  }
  __syncthreads();
  total = s_warp[31];
  const int excl = (warp == 0 ? 0 : s_warp[warp - 1]) + x - v;
  __syncthreads();  // s_warp is free again
  return excl;
}

// start[r] = the counts before r within r's block of kScanBlock rows;
// block[b] = that block's total.
__global__ void __launch_bounds__(kScanThreads)
lookup_bwd_scatter_scan_kernel(const int32_t* __restrict__ counts,
                               int32_t* __restrict__ start,
                               int32_t* __restrict__ block, int rows) {
  __shared__ int s_warp[32];
  const int r0 = blockIdx.x * kScanBlock + threadIdx.x * kScanItems;
  int v[kScanItems];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = r0 + i < rows ? counts[r0 + i] : 0;
    sum += v[i];
  }
  int total;
  int run = block_exclusive_scan(sum, s_warp, total);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (r0 + i < rows) start[r0 + i] = run;
    run += v[i];
  }
  if (threadIdx.x == 0) block[blockIdx.x] = total;
}

// block[b] <- the sum of the block totals before b (one block, in chunks);
// block[blocks] <- the pairs' total.
__global__ void __launch_bounds__(kScanThreads)
lookup_bwd_scatter_blocks_kernel(int32_t* __restrict__ block, int blocks) {
  __shared__ int s_warp[32];
  int carry = 0;
  for (int b0 = 0; b0 < blocks; b0 += kScanThreads) {
    const int b = b0 + threadIdx.x;
    const int v = b < blocks ? block[b] : 0;
    int total;
    const int excl = block_exclusive_scan(v, s_warp, total);
    if (b < blocks) block[b] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) block[blocks] = carry;
}

template <bool kRange>
__global__ void __launch_bounds__(kFlatThreads)
lookup_bwd_scatter_place_kernel(const int32_t* __restrict__ idx,
                                int64_t pairs, int top_k, int base, int rows,
                                int32_t* start,
                                const int32_t* __restrict__ block,
                                int32_t* __restrict__ entries) {
  for (int64_t f = blockIdx.x * static_cast<int64_t>(kFlatThreads) +
                   threadIdx.x;
       f < pairs; f += static_cast<int64_t>(gridDim.x) * kFlatThreads) {
    const int32_t r = row_of<kRange>(idx, f, base, rows);
    if (r >= 0) {
      const int fi = static_cast<int>(f);  // n k < 2^31 (the wrapper checks)
      const int t = fi / top_k;
      entries[atomicAdd(start + r, 1) + block[r / kScanBlock]] =
          t << 8 | (fi - t * top_k);
    }
  }
}

// The sum below takes the sorted pairs in chunks of 32.  A row whose
// segment lies in one chunk is stored whole by that chunk's warp; the rows
// no chunk stores whole, with no pairs or cut by a chunk boundary, are
// zeroed here first (a warp per 32 rows, one store a zeroed row) and the
// chunks add their parts to them with atomics.  After place, start[r]
// plus its block's offset is the end of r's segment.
__global__ void __launch_bounds__(kWarps * 32)
lookup_bwd_scatter_zero_kernel(const int32_t* __restrict__ counts,
                               const int32_t* __restrict__ start,
                               const int32_t* __restrict__ block,
                               float* __restrict__ dvalues, int rows,
                               int m) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r0 = (blockIdx.x * kWarps + warp) * 32; r0 < rows;
       r0 += gridDim.x * kWarps * 32) {
    bool zero = false;
    if (r0 + lane < rows) {
      const int cnt = counts[r0 + lane];
      const int end = start[r0 + lane] + block[(r0 + lane) / kScanBlock];
      zero = cnt == 0 || ((end - cnt) >> 5) != ((end - 1) >> 5);
    }
    for (unsigned todo = __ballot_sync(kFull, zero); todo;
         todo &= todo - 1) {
      float* dr = dvalues + static_cast<int64_t>(r0 + __ffs(todo) - 1) * m;
      for (int c = 2 * lane; c < m; c += 64)
        *reinterpret_cast<float2*>(dr + c) = make_float2(0.f, 0.f);
    }
  }
}

// A row of values into registers, two columns a lane.
template <int kCh>
__device__ __forceinline__ void load_row(float2 (&v)[kCh],
                                         const float* __restrict__ row,
                                         int m, int lane) {
#pragma unroll
  for (int ch = 0; ch < kCh; ++ch) {
    const int col = ch * 64 + 2 * lane;
    v[ch] = col < m ? *reinterpret_cast<const float2*>(row + col)
                    : make_float2(0.f, 0.f);
  }
}

// dvalues[r] (+)= a run's sum: stored when the run is r's whole segment,
// added atomically onto the zeroed row when a chunk boundary cuts it.
template <int kCh>
__device__ __forceinline__ void put_row(float* __restrict__ dr,
                                        const float2 (&acc)[kCh], bool whole,
                                        int m, int lane) {
#pragma unroll
  for (int ch = 0; ch < kCh; ++ch) {
    const int col = ch * 64 + 2 * lane;
    if (col >= m) continue;
    if (whole) {
      *reinterpret_cast<float2*>(dr + col) = acc[ch];
    } else {
      atomicAdd(dr + col, acc[ch].x);
      atomicAdd(dr + col + 1, acc[ch].y);
    }
  }
}

// The row (idx - base) of the sorted pair at position e.
__device__ __forceinline__ int row_at(const int32_t* __restrict__ entries,
                                      const int32_t* __restrict__ idx,
                                      int e, int top_k, int base) {
  const int en = entries[e];
  return idx[static_cast<int64_t>(en >> 8) * top_k + (en & 255)] - base;
}

// dvalues[r] += w[t, k] * g[t] and dw[t, k] = g[t] . values[r] over the
// sorted pairs, a warp per chunk of 32 (lane j loads pair j: its (t, k),
// w and row, idx[t, k] - base).  The warp walks the chunk's runs of equal
// rows: at a run's start it reads values[r] once; each pair adds w·g[t] to
// the run's sum in registers (g, 16 MiB at n = 65536, stays in L2) and
// leaves its lanes' parts of the dot in shared memory; at a run's end the
// row goes out once (put_row).  Lane j then adds pair j's 32 parts in
// lane order: dw.  Every warp takes 32 pairs however they fall on rows, so
// a row that many pairs hit spreads over many warps.
template <int kCh>  // 64-column chunks a row has at most: 1 or kMaxChunks
__global__ void __launch_bounds__(kWarps * 32)
lookup_bwd_scatter_sum_kernel(const float* __restrict__ values,
                              const int32_t* __restrict__ entries,
                              const int32_t* __restrict__ idx,
                              const int32_t* __restrict__ total_pairs,
                              const float* __restrict__ w,
                              const float* __restrict__ g,
                              float* __restrict__ dvalues,
                              float* __restrict__ dw, int top_k, int m,
                              int base) {
  __shared__ float s_part[kWarps][32][33];  // padded: conflict-free both ways
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float(*part)[33] = s_part[warp];
  const int total = *total_pairs;
  for (int e0 = (blockIdx.x * kWarps + warp) * 32; e0 < total;
       e0 += gridDim.x * kWarps * 32) {
    const int cnt = min(32, total - e0);
    int my_t = 0;
    int my_f = 0;
    int my_r = -1;
    float my_w = 0.f;
    if (lane < cnt) {
      const int en = entries[e0 + lane];
      my_t = en >> 8;
      my_f = my_t * top_k + (en & 255);
      my_w = w[my_f];
      my_r = idx[my_f] - base;
    }
    // does the first run go on from the chunk before, the last into the
    // chunk after?
    const int before = e0 > 0 ? row_at(entries, idx, e0 - 1, top_k, base)
                              : -1;
    const int after = e0 + cnt < total
                          ? row_at(entries, idx, e0 + cnt, top_k, base)
                          : -1;
    float2 acc[kCh];
    float2 vr[kCh];
    int cur = __shfl_sync(kFull, my_r, 0);
    bool whole = cur != before;  // the current run began in this chunk
    load_row<kCh>(vr, values + static_cast<int64_t>(cur) * m, m, lane);
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) acc[ch] = make_float2(0.f, 0.f);
    for (int j = 0; j < cnt; ++j) {
      const int r = __shfl_sync(kFull, my_r, j);
      if (r != cur) {  // warp-uniform
        put_row<kCh>(dvalues + static_cast<int64_t>(cur) * m, acc, whole, m,
                     lane);
        cur = r;
        whole = true;
        load_row<kCh>(vr, values + static_cast<int64_t>(cur) * m, m, lane);
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch) acc[ch] = make_float2(0.f, 0.f);
      }
      const int64_t t = __shfl_sync(kFull, my_t, j);
      const float wj = __shfl_sync(kFull, my_w, j);
      const float* gt = g + t * m;
      float p = 0.f;
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) {
        const int col = ch * 64 + 2 * lane;
        if (col < m) {
          const float2 gv = *reinterpret_cast<const float2*>(gt + col);
          acc[ch].x = fmaf(wj, gv.x, acc[ch].x);
          acc[ch].y = fmaf(wj, gv.y, acc[ch].y);
          p = fmaf(gv.x, vr[ch].x, p);
          p = fmaf(gv.y, vr[ch].y, p);
        }
      }
      part[j][lane] = p;
    }
    put_row<kCh>(dvalues + static_cast<int64_t>(cur) * m, acc,
                 whole && cur != after, m, lane);
    __syncwarp();
    if (lane < cnt) {
      float sum = 0.f;
      for (int l = 0; l < 32; ++l) sum += part[lane][l];
      dw[my_f] = sum;
    }
    __syncwarp();  // part is rewritten by the next chunk
  }
}

// dq[t] = sum_k dw[t, k] * relu_k^3 * (-delta_k) from the sum's dw: the
// body's dq, lane k's terms in the same order, the same butterflies.
__global__ void __launch_bounds__(kWarps * 32)
lookup_bwd_scatter_dq_kernel(const int32_t* __restrict__ idx,
                             const float* __restrict__ dw,
                             const float* __restrict__ q,
                             float* __restrict__ dq, int n, int top_k,
                             Torus torus) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = blockIdx.x * kWarps + warp; t < n; t += gridDim.x * kWarps) {
    float qt[kDim];
    float acc[kDim];
#pragma unroll
    for (int i = 0; i < kDim; ++i) {
      qt[i] = q[static_cast<int64_t>(t) * kDim + i];
      acc[i] = 0.f;
    }
    for (int kk = lane; kk < top_k; kk += 32) {
      const int64_t f = static_cast<int64_t>(t) * top_k + kk;
      float x[kDim];
      point_of(idx[f], torus, x);
      dq_terms(x, dw[f], qt, torus, acc);
    }
#pragma unroll
    for (int i = 0; i < kDim; ++i) {
      const float s = warp_sum(acc[i]);
      if (lane == 0) dq[static_cast<int64_t>(t) * kDim + i] = s;
    }
  }
}

int blocks_for(int n) { return min((n + kWarps - 1) / kWarps, 65535); }

int flat_blocks_for(int64_t pairs) {
  return static_cast<int>(std::min<int64_t>(
      std::max<int64_t>((pairs + kFlatThreads - 1) / kFlatThreads, 1), 8192));
}

Torus torus_of(const int* wrap) {
  Torus torus = {};
  if (wrap != nullptr)
    for (int i = 0; i < kDim; ++i) torus.K[i] = wrap[i];
  return torus;
}

template <typename T, bool kDq, bool kRange = false>
void launch_body(const void* values, const void* scale, const void* rows,
                 const void* idx, const void* g, const void* q, void* out,
                 int n, int top_k, int m, const int* wrap,
                 cudaStream_t stream, int base = 0, int range_rows = 0) {
  lookup_bwd_kernel<T, kDq, kRange><<<blocks_for(n), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(values), static_cast<const float*>(scale),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(idx),
      static_cast<const float*>(g), static_cast<const float*>(q),
      static_cast<float*>(out), n, top_k, m, torus_of(wrap), base,
      range_rows);
}

template <typename T, bool kDq, bool kRange = false>
int launch(const void* values, const void* scale, const void* rows,
           const void* idx, const void* g, const void* q, void* out, int n,
           int top_k, int m, const int* wrap, int device, void* stream,
           int base = 0, int range_rows = 0) {
  cudaSetDevice(device);
  if (n > 0)
    launch_body<T, kDq, kRange>(values, scale, rows, idx, g, q, out, n,
                                top_k, m, wrap,
                                static_cast<cudaStream_t>(stream), base,
                                range_rows);
  return static_cast<int>(cudaGetLastError());
}

// dvalues (rows, m), every row written, and dw (n, k) (the in-range k's
// only; the others 0) or dq (n, 8): the pairs (idx[t,k] - base, t, k)
// counted and placed by row, then summed 32 at a time, then dq from dw.
template <bool kDq, bool kRange = false>
int launch_with_scatter(const void* values, const void* idx, const void* w,
                        const void* g, const void* q, void* dvalues,
                        void* out, void* scratch, int n, int top_k, int m,
                        int rows, const int* wrap, int device, void* stream,
                        int base = 0) {
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const Scatter s(scratch, n, top_k, rows);
  const int64_t pairs = static_cast<int64_t>(n) * top_k;
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* dw = kDq ? s.dw : static_cast<float*>(out);
  float* dv = static_cast<float*>(dvalues);
  cudaMemsetAsync(s.counts, 0, sizeof(int32_t) * rows, st);
  if (kRange)  // the sum writes the in-range pairs' dw alone
    cudaMemsetAsync(dw, 0, sizeof(float) * pairs, st);
  lookup_bwd_scatter_count_kernel<kRange>
      <<<flat_blocks_for(pairs), kFlatThreads, 0, st>>>(ix, pairs, base, rows,
                                                        s.counts);
  lookup_bwd_scatter_scan_kernel<<<s.blocks, kScanThreads, 0, st>>>(
      s.counts, s.start, s.block, rows);
  lookup_bwd_scatter_blocks_kernel<<<1, kScanThreads, 0, st>>>(s.block,
                                                              s.blocks);
  lookup_bwd_scatter_place_kernel<kRange>
      <<<flat_blocks_for(pairs), kFlatThreads, 0, st>>>(
          ix, pairs, top_k, base, rows, s.start, s.block, s.entries);
  lookup_bwd_scatter_zero_kernel<<<blocks_for((rows + 31) / 32), kWarps * 32,
                                   0, st>>>(s.counts, s.start, s.block, dv,
                                            rows, m);
  if (pairs > 0) {
    const int sum_blocks = blocks_for(static_cast<int>((pairs + 31) / 32));
    const float* vals = static_cast<const float*>(values);
    const float* wf = static_cast<const float*>(w);
    const float* gf = static_cast<const float*>(g);
    const int32_t* total = s.block + s.blocks;
    if (m <= 64)
      lookup_bwd_scatter_sum_kernel<1><<<sum_blocks, kWarps * 32, 0, st>>>(
          vals, s.entries, ix, total, wf, gf, dv, dw, top_k, m, base);
    else
      lookup_bwd_scatter_sum_kernel<kMaxChunks>
          <<<sum_blocks, kWarps * 32, 0, st>>>(vals, s.entries, ix, total,
                                               wf, gf, dv, dw, top_k, m,
                                               base);
  }
  if (kDq && n > 0)
    lookup_bwd_scatter_dq_kernel<<<blocks_for(n), kWarps * 32, 0, st>>>(
        ix, s.dw, static_cast<const float*>(q), static_cast<float*>(out), n,
        top_k, torus_of(wrap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// int32 words of scratch a scatter instance takes for n queries of top_k
// over a table (or shard) of `rows` rows.
extern "C" long long lookup_bwd_scatter_scratch(int n, int top_k, int rows) {
  return 2LL * rows + scan_blocks_for(rows) + 1 +
         2LL * static_cast<long long>(n) * top_k;
}

// B3's backward: dvalues (N, m), written whole, and dq (n, 8); rows = idx.
extern "C" int lookup_bwd_dq_f32(const void* values, const void* idx,
                                 const void* w, const void* g, const void* q,
                                 void* dvalues, void* dq, void* scratch,
                                 int n, int top_k, int m, int rows,
                                 const int* wrap, int device, void* stream) {
  return launch_with_scatter<true>(values, idx, w, g, q, dvalues, dq,
                                   scratch, n, top_k, m, rows, wrap, device,
                                   stream);
}

// B1's VJP: dvalues (N, m), written whole, and dw (n, k).
extern "C" int lookup_bwd_dw_f32(const void* values, const void* idx,
                                 const void* w, const void* g, void* dvalues,
                                 void* dw, void* scratch, int n, int top_k,
                                 int m, int rows, int device, void* stream) {
  return launch_with_scatter<false>(values, idx, w, g, nullptr, dvalues, dw,
                                    scratch, n, top_k, m, rows, nullptr,
                                    device, stream);
}

// No scatter, over the rows `rows` of a table: dq (n, 8) with q, idx and
// the torus (wrap), else dw (n, k).  `scale` is null for fp32 rows; w is
// taken for the callers' sake (dq and dw do not depend on it).
#define LOOKUP_BWD_ROWS(NAME, T)                                              \
  extern "C" int lookup_bwd_rows_dq_##NAME(                                   \
      const void* values, const void* scale, const void* rows,                \
      const void* idx, const void* w, const void* g, const void* q,           \
      void* dq, int n, int top_k, int m, const int* wrap, int device,         \
      void* stream) {                                                         \
    (void)w;                                                                  \
    return launch<T, true>(values, scale, rows, idx, g, q, dq, n, top_k, m,   \
                           wrap, device, stream);                             \
  }                                                                           \
  extern "C" int lookup_bwd_rows_dw_##NAME(                                   \
      const void* values, const void* scale, const void* rows, const void* w, \
      const void* g, void* dw, int n, int top_k, int m, int device,           \
      void* stream) {                                                         \
    (void)w;                                                                  \
    return launch<T, false>(values, scale, rows, rows, g, nullptr, dw, n,     \
                            top_k, m, nullptr, device, stream);               \
  }

LOOKUP_BWD_ROWS(f32, float)
LOOKUP_BWD_ROWS(i8, int8_t)
LOOKUP_BWD_ROWS(e4m3, __nv_fp8_e4m3)

// Row 9's backward over the shard [base, base + rows) of the table: the
// in-range k only, rows read at idx - base.  fp32: w (x) g scattered into
// the shard's (rows, m) dvalues, written whole, and the partial dq (n, 8)
// or dw (n, k).
extern "C" int lookup_bwd_range_dq_f32(const void* values, const void* idx,
                                       const void* w, const void* g,
                                       const void* q, void* dvalues, void* dq,
                                       void* scratch, int n, int top_k, int m,
                                       int base, int rows, const int* wrap,
                                       int device, void* stream) {
  return launch_with_scatter<true, true>(values, idx, w, g, q, dvalues, dq,
                                         scratch, n, top_k, m, rows, wrap,
                                         device, stream, base);
}

extern "C" int lookup_bwd_range_dw_f32(const void* values, const void* idx,
                                       const void* w, const void* g,
                                       void* dvalues, void* dw, void* scratch,
                                       int n, int top_k, int m, int base,
                                       int rows, int device, void* stream) {
  return launch_with_scatter<false, true>(values, idx, w, g, nullptr, dvalues,
                                          dw, scratch, n, top_k, m, rows,
                                          nullptr, device, stream, base);
}

// 1-byte shards (frozen, no scatter): the partial dq or dw.
#define LOOKUP_BWD_RANGE_QUANT(NAME, T)                                       \
  extern "C" int lookup_bwd_range_dq_##NAME(                                  \
      const void* values, const void* scale, const void* idx, const void* w,  \
      const void* g, const void* q, void* dq, int n, int top_k, int m,        \
      int base, int rows, const int* wrap, int device, void* stream) {        \
    (void)w;                                                                  \
    return launch<T, true, true>(values, scale, idx, idx, g, q, dq, n, top_k, \
                                 m, wrap, device, stream, base, rows);        \
  }                                                                           \
  extern "C" int lookup_bwd_range_dw_##NAME(                                  \
      const void* values, const void* scale, const void* idx, const void* w,  \
      const void* g, void* dw, int n, int top_k, int m, int base, int rows,   \
      int device, void* stream) {                                             \
    (void)w;                                                                  \
    return launch<T, false, true>(values, scale, idx, idx, g, nullptr, dw, n, \
                                  top_k, m, nullptr, device, stream, base,    \
                                  rows);                                      \
  }

LOOKUP_BWD_RANGE_QUANT(i8, int8_t)
LOOKUP_BWD_RANGE_QUANT(e4m3, __nv_fp8_e4m3)
