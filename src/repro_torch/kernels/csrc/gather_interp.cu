// K1: weighted row gather  out[t] = sum_k w[t,k] * values[idx[t,k]]  (fp32).
//
// Replaces the TPU kernel src/repro/kernels/gather_interp.py
// (gather_interp_pallas, _kernel; pallas_call at :73), which DMAs one
// value row per grid step through scalar-prefetched indices and
// accumulates in VMEM.
//
// Bound on an H100: bytes.  Each distinct row the indices name is read
// once (4m bytes), plus n*k*8 bytes of indices and weights and 4*n*m of
// output, at 3.35 TB/s.  The 2*n*k*m flops are far below the fp32 rate.
//
// Design: gather_batched.cuh's body on an fp32 table with the identity
// row map: 8 row loads of a warp in flight before its FMAs, and at decode
// sizes a query split over up to 8 warps of a block (the split from n and
// the card's SM count), so that n = 128 fills the card; 4 blocks an SM
// (at most 64 registers).  With split 1 the output is bit-equal to the
// old warp-per-query body's (once in gather_rows.cuh).
//
// Tried and dropped: running the queries in the order of their top
// candidate's row (a counting sort on the card, then the gather in that
// order) so that L2 serves a row's later reads.  It paid on uniform
// queries at n = 65,536 and cost time on clustered ones, which training's
// are (PERF.md; tools/csrc/query_order.cu).  idx must lie in [0, N).

#include "gather_batched.cuh"

template <bool kOneWarp, bool kPairs>
__global__ void __launch_bounds__(gather_batched::kThreads,
                                  gather_batched::kMinBlocks)
gather_interp_kernel(const float* __restrict__ values,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out,
                     int n, int top_k, int m, int split) {
  gather_batched::gather<float, false, kOneWarp, kPairs>(
      values, nullptr, idx, w, out, n, top_k, m, split,
      gather_rows::DirectRows{});
}

template <bool kOneWarp, bool kPairs>
static void launch_instance(const void* values, const void* idx,
                            const void* w, void* out, int n, int top_k,
                            int m, int split, cudaStream_t stream) {
  gather_interp_kernel<kOneWarp, kPairs>
      <<<gather_batched::blocks_for(n, split), gather_batched::kThreads, 0,
         stream>>>(static_cast<const float*>(values),
                   static_cast<const int32_t*>(idx),
                   static_cast<const float*>(w), static_cast<float*>(out), n,
                   top_k, m, split);
}

static int launch(const void* values, const void* idx, const void* w,
                  void* out, int n, int top_k, int m, int split,
                  cudaStream_t stream) {
  const bool pairs = m % 2 == 0;  // pair loads stay aligned
  if (split == 1 && pairs)
    launch_instance<true, true>(values, idx, w, out, n, top_k, m, 1, stream);
  else if (split == 1)
    launch_instance<true, false>(values, idx, w, out, n, top_k, m, 1, stream);
  else if (pairs)
    launch_instance<false, true>(values, idx, w, out, n, top_k, m, split,
                                 stream);
  else
    launch_instance<false, false>(values, idx, w, out, n, top_k, m, split,
                                  stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_interp_f32(const void* values, const void* idx,
                                 const void* w, void* out, int n, int top_k,
                                 int m, int device, void* stream) {
  cudaSetDevice(device);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch(values, idx, w, out, n, top_k, m,
                gather_batched::split_for(n, top_k,
                                          gather_batched::sm_count(device)),
                static_cast<cudaStream_t>(stream));
}

// The same gather with an explicit split (1, 2, 4 or 8 warps a query):
// for tests and A/B runs that hold every split to the plain version.
extern "C" int gather_interp_f32_split(const void* values, const void* idx,
                                       const void* w, void* out, int n,
                                       int top_k, int m, int split,
                                       int device, void* stream) {
  cudaSetDevice(device);
  if (split != 1 && split != 2 && split != 4 && split != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch(values, idx, w, out, n, top_k, m, split,
                static_cast<cudaStream_t>(stream));
}
