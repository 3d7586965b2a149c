// The lookup's backward: one body, two instantiations.
//
//   kDq = true  (B3's backward, replaces _lookup_bwd of
//     src/repro/kernels/ops.py, lram_lookup; K2 + K1 forward, pallas_call
//     sites e8_lookup.py:189 and gather_interp.py:73):
//       dvalues[idx[t,k]] += w[t,k] * g[t]
//       dq[t] = sum_k (g[t] . values[idx[t,k]]) * relu_k^3 * (-delta_k)
//     with delta_k = q[t] - x_k on the nearest torus image of the lattice
//     point x_k that idx[t,k] names, relu_k = max(0, 1 - |delta_k|^2 / 8):
//     the analytic derivative of w = relu^4.
//   kDq = false (B1's VJP, replaces _vjp_bwd of
//     src/repro/kernels/gather_interp.py, gather_interp_vjp; forward
//     pallas_call at :73):
//       dvalues as above, dw[t,k] = g[t] . values[idx[t,k]].
//
// dvalues is the dense (N, m) fp32 gradient, zeroed by the wrapper before
// the launch (the reference's jnp.zeros(...).at[idx].add).
//
// Bound on an H100: bytes, at 3.35 TB/s.  The kernel alone, on the zeroed
// dvalues: each distinct row the indices name read once (4m bytes) and
// its gradient row written once (4m), plus g (4m per query), idx and w
// (8k), q (32) and the small output (32 or 4k).  The whole call adds the
// zero fill of dvalues (4Nm bytes: 256 MiB at full width), which then
// covers the gradient rows' writes.  Reading the zeroed rows back for the
// atomic adds is a cost of this design, not of the function.  The
// 4·n·k·m flops are far below the fp32 rate.
//
// Design: one warp per query row, grid-stride over rows, 8 warps a block
// (the gather's layout, gather_rows.cuh).  Each lane keeps two columns of
// g[t] in registers per 64-column chunk (m <= 256).  Lane l loads
// idx[t, l] and w[t, l], 32 at a time, and the warp broadcasts them with
// __shfl_sync.  For each of the k rows the warp reads the row once (one
// float2 per lane, coalesced), forms its part of g . row, sums it with a
// 5-step __shfl_xor_sync butterfly (dw_k, on every lane), and adds w_k·g
// into dvalues' row with fp32 atomicAdd (two per lane; the result is
// unused, so they compile to reductions).  Lane k keeps dw_k.  For dq,
// lane k then decodes idx_k into its lattice point with the integer ops of
// the plain version's points_from_indices, takes the nearest-image delta,
// d^2 and relu^3 (explicit round-to-nearest, no FMA, as the plain version
// computes them), and the warp sums dw_k·relu_k^3·(-delta_k) over k with
// one butterfly per component; lane 0 writes dq[t].  Atomics make the
// order of dvalues' sums vary from run to run (fp32 rounding only).

#include <cuda_runtime.h>
#include <stdint.h>

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

template <bool kDq>
__global__ void __launch_bounds__(kWarps * 32)
lookup_bwd_kernel(const float* __restrict__ values,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ w, const float* __restrict__ g,
                  const float* __restrict__ q, float* __restrict__ dvalues,
                  float* __restrict__ dsmall, int n, int top_k, int m,
                  Torus torus) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = (m + 63) / 64;
  for (int t = blockIdx.x * kWarps + warp; t < n; t += gridDim.x * kWarps) {
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
      float my_w = 0.f;
      if (kk < top_k) {
        my_row = it[kk];
        my_w = wt[kk];
      }
      const int cnt = min(32, top_k - kb);
      float my_dw = 0.f;
      for (int j = 0; j < cnt; ++j) {
        const int64_t row = __shfl_sync(kFull, my_row, j);
        const float wj = __shfl_sync(kFull, my_w, j);
        const float* vr = values + row * m;
        float* dr = dvalues + row * m;
        float part = 0.f;
#pragma unroll
        for (int ch = 0; ch < kMaxChunks; ++ch) {
          const int c = ch * 64 + 2 * lane;
          if (ch < chunks && c < m) {
            const float2 v = *reinterpret_cast<const float2*>(vr + c);
            part = fmaf(gr[ch].x, v.x, part);
            part = fmaf(gr[ch].y, v.y, part);
            atomicAdd(dr + c, wj * gr[ch].x);
            atomicAdd(dr + c + 1, wj * gr[ch].y);
          }
        }
        const float dwj = warp_sum(part);
        if (lane == j) my_dw = dwj;
      }
      if (kk < top_k) {
        if (kDq) {
          float x[kDim];
          point_of(my_row, torus, x);
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

}  // namespace

// B3's backward: dvalues (zeroed, (N, m)) and dq (n, 8).
extern "C" int lookup_bwd_dq_f32(const void* values, const void* idx,
                                 const void* w, const void* g, const void* q,
                                 void* dvalues, void* dq, int n, int top_k,
                                 int m, const int* wrap, int device,
                                 void* stream) {
  cudaSetDevice(device);
  if (n > 0) {
    Torus torus;
    for (int i = 0; i < kDim; ++i) torus.K[i] = wrap[i];
    lookup_bwd_kernel<true><<<blocks_for(n), kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values), static_cast<const int32_t*>(idx),
        static_cast<const float*>(w), static_cast<const float*>(g),
        static_cast<const float*>(q), static_cast<float*>(dvalues),
        static_cast<float*>(dq), n, top_k, m, torus);
  }
  return static_cast<int>(cudaGetLastError());
}

// B1's VJP: dvalues (zeroed, (N, m)) and dw (n, k).
extern "C" int lookup_bwd_dw_f32(const void* values, const void* idx,
                                 const void* w, const void* g, void* dvalues,
                                 void* dw, int n, int top_k, int m,
                                 int device, void* stream) {
  cudaSetDevice(device);
  if (n > 0) {
    Torus torus = {};
    lookup_bwd_kernel<false><<<blocks_for(n), kWarps * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values), static_cast<const int32_t*>(idx),
        static_cast<const float*>(w), static_cast<const float*>(g), nullptr,
        static_cast<float*>(dvalues), static_cast<float*>(dw), n, top_k, m,
        torus);
  }
  return static_cast<int>(cudaGetLastError());
}
