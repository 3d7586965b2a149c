// K2: fused LRAM query  q (n, 8) f32 -> top-k (idx int32, w f32).
//
// Replaces the TPU kernel src/repro/kernels/e8_lookup.py
// (lram_query_pallas, _query_kernel; pallas_call at :189).  Per query:
// E8 decode over both D8 cosets, canonicalisation into the fundamental
// region F by the 19-comparator Batcher network, squared distances to the
// 232 candidates (padded to 256), weights relu(1 - d^2/8)^4, top-k by
// repeated argmax, the inverse isometry and the O(1) torus encode.
//
// Bound on an H100: operations.  A query reads 32 B and writes 8k B, but
// does 232 distances of ~23 fp32 operations each plus k rounds of a
// 232-wide argmax; at n = 65536 that is ~0.8 G operations against 19 MB.
//
// Design: one warp per query (grid-stride over queries, 8 warps a block).
// The padded candidate table is staged once per block in shared memory,
// transposed (cand[d][j]) so lane l reading candidate j = l + 32r hits 32
// distinct banks; constant memory would serialise those distinct
// addresses.  Every lane redoes the 8-wide decode and sort (cheap, keeps
// the warp in lock step) and scores its 8 candidates.  Each of the k
// rounds is a lane-local max over 8 registers and a 5-step __shfl_xor_sync
// argmax on (score, index), ties to the lower index as jnp.argmax breaks
// them.  Lane r keeps the winner of round r, so after 32 rounds the
// inverse isometry and encode run once per lane in parallel and the
// stores are coalesced.
//
// Distances use the TPU kernel's form |z|^2 - 2 z.c + |c|^2 with sums left
// to right and explicit round-to-nearest intrinsics (no FMA contraction):
// the plain version (repro_torch.core.lattice) adds in the same order, so
// both give the same weights bit for bit and pick the same top-k.
// Rounding is rintf (half to even, as jnp.round); wrapping is a floored
// mod ((x % K) + K) % K, as jnp.mod.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 8;
constexpr int kPadded = 256;
constexpr int kValid = 232;
constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kRemoved = -2.f;  // below the padding's -1: never re-picked

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

// compare-exchange for a descending sort of key, carrying val and perm
#define CX(i, j)                         \
  if (key[i] < key[j]) {                 \
    float tk = key[i]; key[i] = key[j]; key[j] = tk; \
    float tv = val[i]; val[i] = val[j]; val[j] = tv; \
    int tp = perm[i]; perm[i] = perm[j]; perm[j] = tp; \
  }

__device__ __forceinline__ int encode(const int (&x)[kDim], const Torus& T) {
  int u[kDim];
  const int p = (((x[0] % T.K[0]) + T.K[0]) % T.K[0]) & 1;
#pragma unroll
  for (int i = 0; i < kDim; ++i) {
    const int xm = ((x[i] % T.K[i]) + T.K[i]) % T.K[i];
    u[i] = (xm - p) >> 1;
  }
  const int qpar = (u[0] + u[1] + u[2] + u[3] + u[4] + u[5] + u[6]) & 1;
  const int j8 = (u[7] - qpar) >> 1;
  int idx7 = u[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) idx7 = idx7 * (T.K[i] / 2) + u[i];
  return (idx7 * ((T.K[7] / 2) >> 1) + j8) * 2 + p;
}

__global__ void __launch_bounds__(kWarps * 32)
lram_query_kernel(const float* __restrict__ q,
                  const float* __restrict__ cand_t,    // (8, 256)
                  const float* __restrict__ cand_nsq,  // (256,)
                  int32_t* __restrict__ idx_out, float* __restrict__ w_out,
                  int n, int top_k, Torus torus) {
  __shared__ float s_cand[kDim][kPadded];
  __shared__ float s_nsq[kPadded];
  for (int i = threadIdx.x; i < kDim * kPadded; i += blockDim.x)
    (&s_cand[0][0])[i] = cand_t[i];
  for (int i = threadIdx.x; i < kPadded; i += blockDim.x)
    s_nsq[i] = cand_nsq[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = blockIdx.x * kWarps + warp; t < n;
       t += gridDim.x * kWarps) {
    float qv[kDim], c[kDim];
#pragma unroll
    for (int i = 0; i < kDim; ++i) qv[i] = q[(size_t)t * kDim + i];
    decode_e8(qv, c);

    // canonicalise: sort |t| descending, carrying t and the permutation
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
    float sgn[kDim], z[kDim];
    float parity = 1.f;
#pragma unroll
    for (int i = 0; i < kDim; ++i) {
      sgn[i] = val[i] < 0.f ? -1.f : 1.f;
      parity *= sgn[i];
    }
    sgn[7] *= parity;
    float znorm = 0.f;
#pragma unroll
    for (int i = 0; i < kDim; ++i) {
      z[i] = sgn[i] * val[i];
      znorm = i == 0 ? __fmul_rn(z[i], z[i])
                     : __fadd_rn(znorm, __fmul_rn(z[i], z[i]));
    }

    // scores of this lane's candidates j = lane + 32 r
    float sc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = lane + 32 * r;
      float cross = __fmul_rn(z[0], s_cand[0][j]);
#pragma unroll
      for (int d = 1; d < kDim; ++d)
        cross = __fadd_rn(cross, __fmul_rn(z[d], s_cand[d][j]));
      const float d2 =
          __fadd_rn(__fsub_rn(znorm, __fmul_rn(2.f, cross)), s_nsq[j]);
      const float rl = fmaxf(0.f, __fsub_rn(1.f, __fdiv_rn(d2, 8.f)));
      const float r2 = __fmul_rn(rl, rl);
      sc[r] = j < kValid ? __fmul_rn(r2, r2) : -1.f;
    }

    for (int base = 0; base < top_k; base += 32) {
      const int cnt = min(32, top_k - base);
      int my_j = 0;
      float my_w = 0.f;
      for (int round = 0; round < cnt; ++round) {
        float bs = sc[0];
        int br = 0;
#pragma unroll
        for (int r = 1; r < 8; ++r)
          if (sc[r] > bs) {  // j grows with r: keeps the lower index
            bs = sc[r];
            br = r;
          }
        int bj = lane + 32 * br;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float os = __shfl_xor_sync(kFull, bs, off);
          const int oj = __shfl_xor_sync(kFull, bj, off);
          if (os > bs || (os == bs && oj < bj)) {
            bs = os;
            bj = oj;
          }
        }
        if ((bj & 31) == lane) {
#pragma unroll
          for (int r = 0; r < 8; ++r)
            if (r == (bj >> 5)) sc[r] = kRemoved;
        }
        if (lane == round) {
          my_j = bj;
          my_w = fmaxf(bs, 0.f);
        }
      }
      if (lane < cnt) {
        // inverse isometry: g[perm_d] = sgn_d * p_d, then the global point
        float g[kDim];
#pragma unroll
        for (int i = 0; i < kDim; ++i) g[i] = 0.f;
#pragma unroll
        for (int d = 0; d < kDim; ++d) {
          const float ps = sgn[d] * s_cand[d][my_j];
#pragma unroll
          for (int i = 0; i < kDim; ++i)
            if (perm[d] == i) g[i] = ps;
        }
        int x[kDim];
#pragma unroll
        for (int i = 0; i < kDim; ++i) x[i] = __float2int_rn(c[i] + g[i]);
        const size_t o = (size_t)t * top_k + base + lane;
        idx_out[o] = encode(x, torus);
        w_out[o] = my_w;
      }
    }
  }
}

#undef CX

}  // namespace

extern "C" int lram_query_f32(const void* q, const void* cand_t,
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
    // about one wave of resident blocks; the grid-stride loop covers the rest
    const int blocks = min((n + kWarps - 1) / kWarps, 8 * (sms > 0 ? sms : 132));
    lram_query_kernel<<<blocks, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(cand_t),
        static_cast<const float*>(cand_nsq), static_cast<int32_t*>(idx),
        static_cast<float*>(w), n, top_k, torus);
  }
  return static_cast<int>(cudaGetLastError());
}
