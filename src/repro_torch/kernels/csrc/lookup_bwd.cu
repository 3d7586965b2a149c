// The lookup's backward: one warp-per-query body, templated on the row
// payload (fp32; int8 or e4m3 with one fp32 scale per row), on whether it
// scatters the table's gradient, and on whether it finishes with dq.
//
// Per query t and candidate k, with r = rows[t,k] the row the forward read
// (a dense table's index itself, or a tiered store's row in its flat table
// of cache + overflow rows) and i = idx[t,k] the lattice index:
//
//   dw[t,k]  = g[t] . values[r]              (fp32 rows)
//            = scale[r] * (g[t] . q[r])      (1-byte rows: dequantized in
//                                             registers, the scale applied
//                                             once to the warp's dot)
//   dvalues[r] += w[t,k] * g[t]              (kScatter only)
//   dq[t] = sum_k dw[t,k] * relu_k^3 * (-delta_k)   (kDq only)
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
//     Both scatter into the dense (N, m) fp32 dvalues, zeroed by the
//     wrapper (the reference's jnp.zeros(...).at[idx].add).
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
// they are not idx), q (32) and the output (32 or 4k).  The scatter
// instances write each distinct row's gradient once more (4m) on the
// zeroed dvalues; their whole call adds the zero fill of dvalues (4Nm
// bytes: 256 MiB at full width), which then covers those writes.  Reading
// the zeroed rows back for the atomic adds is a cost of this design, not
// of the function.  The 2·n·k·m flops are far below the fp32 rate.
//
// Design: one warp per query row, grid-stride over rows, 8 warps a block
// (the gather's layout, gather_rows.cuh).  Each lane keeps two columns of
// g[t] in registers per 64-column chunk (m <= 256).  Lane l loads
// rows[t, l], w[t, l] (and, for dq, idx[t, l]; for 1-byte rows, the row's
// scale), 32 at a time, and the warp broadcasts row and weight with
// __shfl_sync.  For each of the k rows the warp reads the row once (a
// float2, or two bytes converted in registers, per lane; coalesced),
// forms its part of g . row, sums it with a 5-step __shfl_xor_sync
// butterfly (on every lane), and with kScatter adds w_k·g into dvalues'
// row with fp32 atomicAdd (two per lane; the result is unused, so they
// compile to reductions).  Lane k keeps dw_k (times its row's scale for a
// 1-byte payload).  For dq, lane k then decodes idx_k into its lattice
// point with the integer ops of the plain version's points_from_indices,
// takes the nearest-image delta, d^2 and relu^3 (explicit round-to-
// nearest, no FMA, as the plain version computes them), and the warp sums
// dw_k·relu_k^3·(-delta_k) over k with one butterfly per component; lane 0
// writes dq[t].  Atomics make the order of dvalues' sums vary from run to
// run (fp32 rounding only); the instances without scatter are
// deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gather_rows.cuh"

namespace {

constexpr int kDim = 8;
constexpr int kWarps = 8;
constexpr int kMaxChunks = 4;  // m <= 256 (the wrapper checks)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kRadiusSq = 8.f;

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

template <typename T, bool kScatter, bool kDq, bool kRange>
__global__ void __launch_bounds__(kWarps * 32)
lookup_bwd_kernel(const T* __restrict__ values,
                  const float* __restrict__ scale,
                  const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ w, const float* __restrict__ g,
                  const float* __restrict__ q, float* __restrict__ dvalues,
                  float* __restrict__ dsmall, int n, int top_k, int m,
                  Torus torus, int base, int range_rows) {
  constexpr bool kScaled = !std::is_same<T, float>::value;
  static_assert(!(kScaled && kScatter), "a 1-byte table is not scattered");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = (m + 63) / 64;
  for (int t = blockIdx.x * kWarps + warp; t < n; t += gridDim.x * kWarps) {
    const int32_t* rt = rows + static_cast<int64_t>(t) * top_k;
    const int32_t* it = idx + static_cast<int64_t>(t) * top_k;
    const float* wt = w + static_cast<int64_t>(t) * top_k;
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
      float my_w = 0.f;
      float my_scale = 1.f;
      if (kk < top_k) {
        my_row = rt[kk];
        if (kRange) {  // -1: not this shard's row (a 0 term, not read)
          my_row -= base;
          if (static_cast<uint32_t>(my_row) >=
              static_cast<uint32_t>(range_rows))
            my_row = -1;
        }
        my_w = wt[kk];
        if (kDq) my_idx = it[kk];
        if (kScaled && my_row >= 0) my_scale = scale[my_row];
      }
      const int cnt = min(32, top_k - kb);
      float my_dw = 0.f;
      for (int j = 0; j < cnt; ++j) {
        const int64_t row = __shfl_sync(kFull, my_row, j);
        if (kRange && row < 0) continue;  // warp-uniform; dw_j stays 0
        const float wj = kScatter ? __shfl_sync(kFull, my_w, j) : 0.f;
        const T* vr = values + row * m;
        float* dr = kScatter ? dvalues + row * m : nullptr;
        float part = 0.f;
#pragma unroll
        for (int ch = 0; ch < kMaxChunks; ++ch) {
          const int c = ch * 64 + 2 * lane;
          if (ch < chunks && c < m) {
            const float2 v = gather_rows::Payload<T>::pair(vr, c);
            part = fmaf(gr[ch].x, v.x, part);
            part = fmaf(gr[ch].y, v.y, part);
            if (kScatter) {
              atomicAdd(dr + c, wj * gr[ch].x);
              atomicAdd(dr + c + 1, wj * gr[ch].y);
            }
          }
        }
        const float dwj = warp_sum(part);
        if (lane == j) my_dw = kScaled ? my_scale * dwj : dwj;
      }
      if (kk < top_k) {
        if (kDq) {
          float x[kDim];
          point_of(my_idx, torus, x);
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
          const float coef = __fmul_rn(my_dw,
                                       __fmul_rn(__fmul_rn(relu, relu), relu));
#pragma unroll
          for (int i = 0; i < kDim; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(coef, -delta[i]));
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

int blocks_for(int n) { return min((n + kWarps - 1) / kWarps, 65535); }

Torus torus_of(const int* wrap) {
  Torus torus = {};
  if (wrap != nullptr)
    for (int i = 0; i < kDim; ++i) torus.K[i] = wrap[i];
  return torus;
}

template <typename T, bool kScatter, bool kDq, bool kRange = false>
int launch(const void* values, const void* scale, const void* rows,
           const void* idx, const void* w, const void* g, const void* q,
           void* dvalues, void* out, int n, int top_k, int m,
           const int* wrap, int device, void* stream, int base = 0,
           int range_rows = 0) {
  cudaSetDevice(device);
  if (n > 0) {
    lookup_bwd_kernel<T, kScatter, kDq, kRange>
        <<<blocks_for(n), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(values), static_cast<const float*>(scale),
            static_cast<const int32_t*>(rows),
            static_cast<const int32_t*>(idx), static_cast<const float*>(w),
            static_cast<const float*>(g), static_cast<const float*>(q),
            static_cast<float*>(dvalues), static_cast<float*>(out), n, top_k,
            m, torus_of(wrap), base, range_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B3's backward: dvalues (zeroed, (N, m)) and dq (n, 8); rows = idx.
extern "C" int lookup_bwd_dq_f32(const void* values, const void* idx,
                                 const void* w, const void* g, const void* q,
                                 void* dvalues, void* dq, int n, int top_k,
                                 int m, const int* wrap, int device,
                                 void* stream) {
  return launch<float, true, true>(values, nullptr, idx, idx, w, g, q,
                                   dvalues, dq, n, top_k, m, wrap, device,
                                   stream);
}

// B1's VJP: dvalues (zeroed, (N, m)) and dw (n, k).
extern "C" int lookup_bwd_dw_f32(const void* values, const void* idx,
                                 const void* w, const void* g, void* dvalues,
                                 void* dw, int n, int top_k, int m,
                                 int device, void* stream) {
  return launch<float, true, false>(values, nullptr, idx, idx, w, g, nullptr,
                                    dvalues, dw, n, top_k, m, nullptr, device,
                                    stream);
}

// No scatter, over the rows `rows` of a table: dq (n, 8) with q, idx and
// the torus (wrap), else dw (n, k).  `scale` is null for fp32 rows.
#define LOOKUP_BWD_ROWS(NAME, T)                                              \
  extern "C" int lookup_bwd_rows_dq_##NAME(                                   \
      const void* values, const void* scale, const void* rows,                \
      const void* idx, const void* w, const void* g, const void* q,           \
      void* dq, int n, int top_k, int m, const int* wrap, int device,         \
      void* stream) {                                                         \
    return launch<T, false, true>(values, scale, rows, idx, w, g, q, nullptr, \
                                  dq, n, top_k, m, wrap, device, stream);     \
  }                                                                           \
  extern "C" int lookup_bwd_rows_dw_##NAME(                                   \
      const void* values, const void* scale, const void* rows, const void* w, \
      const void* g, void* dw, int n, int top_k, int m, int device,           \
      void* stream) {                                                         \
    return launch<T, false, false>(values, scale, rows, rows, w, g, nullptr,  \
                                   nullptr, dw, n, top_k, m, nullptr, device, \
                                   stream);                                   \
  }

LOOKUP_BWD_ROWS(f32, float)
LOOKUP_BWD_ROWS(i8, int8_t)
LOOKUP_BWD_ROWS(e4m3, __nv_fp8_e4m3)

// Row 9's backward over the shard [base, base + rows) of the table: the
// in-range k only, rows read at idx - base.  fp32: w (x) g scattered into
// the shard's (rows, m) dvalues (zeroed), and the partial dq (n, 8) or dw
// (n, k).
extern "C" int lookup_bwd_range_dq_f32(const void* values, const void* idx,
                                       const void* w, const void* g,
                                       const void* q, void* dvalues, void* dq,
                                       int n, int top_k, int m, int base,
                                       int rows, const int* wrap, int device,
                                       void* stream) {
  return launch<float, true, true, true>(values, nullptr, idx, idx, w, g, q,
                                         dvalues, dq, n, top_k, m, wrap,
                                         device, stream, base, rows);
}

extern "C" int lookup_bwd_range_dw_f32(const void* values, const void* idx,
                                       const void* w, const void* g,
                                       void* dvalues, void* dw, int n,
                                       int top_k, int m, int base, int rows,
                                       int device, void* stream) {
  return launch<float, true, false, true>(values, nullptr, idx, idx, w, g,
                                          nullptr, dvalues, dw, n, top_k, m,
                                          nullptr, device, stream, base,
                                          rows);
}

// 1-byte shards (frozen, no scatter): the partial dq or dw.
#define LOOKUP_BWD_RANGE_QUANT(NAME, T)                                       \
  extern "C" int lookup_bwd_range_dq_##NAME(                                  \
      const void* values, const void* scale, const void* idx, const void* w,  \
      const void* g, const void* q, void* dq, int n, int top_k, int m,        \
      int base, int rows, const int* wrap, int device, void* stream) {        \
    return launch<T, false, true, true>(values, scale, idx, idx, w, g, q,     \
                                        nullptr, dq, n, top_k, m, wrap,       \
                                        device, stream, base, rows);          \
  }                                                                           \
  extern "C" int lookup_bwd_range_dw_##NAME(                                  \
      const void* values, const void* scale, const void* idx, const void* w,  \
      const void* g, void* dw, int n, int top_k, int m, int base, int rows,   \
      int device, void* stream) {                                             \
    return launch<T, false, false, true>(values, scale, idx, idx, w, g,       \
                                         nullptr, nullptr, dw, n, top_k, m,   \
                                         nullptr, device, stream, base,       \
                                         rows);                               \
  }

LOOKUP_BWD_RANGE_QUANT(i8, int8_t)
LOOKUP_BWD_RANGE_QUANT(e4m3, __nv_fp8_e4m3)
