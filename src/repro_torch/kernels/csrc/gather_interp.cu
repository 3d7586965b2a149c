// K1: weighted row gather  out[t] = sum_k w[t,k] * values[idx[t,k]]  over
// an fp32, bf16 or fp16 table, fp32 weights, accumulate and output.
//
// Replaces the TPU kernel src/repro/kernels/gather_interp.py
// (gather_interp_pallas, _kernel; pallas_call at :73), which DMAs one
// value row per grid step through scalar-prefetched indices and
// accumulates in VMEM.
//
// Bound on an H100: bytes.  Each distinct row the indices name is read
// once (4m bytes, 2m for a bf16 or fp16 row), plus n*k*8 bytes of indices and
// weights and 4*n*m of output, at 3.35 TB/s.  The 2*n*k*m flops are far
// below the fp32 rate.
//
// Design: gather_batched.cuh's body on an fp32 table with the identity
// row map: 8 row loads of a warp in flight before its FMAs, and at decode
// sizes a query split over up to 8 warps of a block (the split from n and
// the card's SM count), so that n = 128 fills the card; 4 blocks an SM
// (at most 64 registers).  With split 1 the output is bit-equal to the
// old warp-per-query body's (once in gather_rows.cuh).
//
// A bf16 table (gather_interp_bf16; the TPU kernel casts each row to the
// output's fp32, row_ref[...].astype(out_ref.dtype) at :40) runs the same
// body on bf16 pairs (Raw<__nv_bfloat16>, 4 bytes a lane), each widened
// to fp32 exactly before its multiply-add: the same fp32 operations in
// the same order, so its output is bit-equal to the fp32 instance's on
// values.float() at the same split.  Half the row bytes, so half the
// bound's row term.  An fp16 table (gather_interp_f16) is the same again
// on __half2 pairs (Raw<__half>, widened by __half22float2, also exact).
//
// Tried and dropped: running the queries in the order of their top
// candidate's row (a counting sort on the card, then the gather in that
// order) so that L2 serves a row's later reads.  It paid on uniform
// queries at n = 65,536 and cost time on clustered ones, which training's
// are (PERF.md; tools/csrc/query_order.cu).  idx must lie in [0, N).

#include "gather_batched.cuh"

template <typename T, bool kOneWarp, bool kPairs>
__global__ void __launch_bounds__(gather_batched::kThreads,
                                  gather_batched::kMinBlocks)
gather_interp_kernel(const T* __restrict__ values,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out,
                     int n, int top_k, int m, int split) {
  gather_batched::gather<T, false, kOneWarp, kPairs>(
      values, nullptr, idx, w, out, n, top_k, m, split,
      gather_rows::DirectRows{});
}

template <typename T, bool kOneWarp, bool kPairs>
static void launch_instance(const void* values, const void* idx,
                            const void* w, void* out, int n, int top_k,
                            int m, int split, cudaStream_t stream) {
  gather_interp_kernel<T, kOneWarp, kPairs>
      <<<gather_batched::blocks_for(n, split), gather_batched::kThreads, 0,
         stream>>>(static_cast<const T*>(values),
                   static_cast<const int32_t*>(idx),
                   static_cast<const float*>(w), static_cast<float*>(out), n,
                   top_k, m, split);
}

template <typename T>
static int launch(const void* values, const void* idx, const void* w,
                  void* out, int n, int top_k, int m, int split,
                  cudaStream_t stream) {
  const bool pairs = m % 2 == 0;  // pair loads stay aligned
  if (split == 1 && pairs)
    launch_instance<T, true, true>(values, idx, w, out, n, top_k, m, 1,
                                   stream);
  else if (split == 1)
    launch_instance<T, true, false>(values, idx, w, out, n, top_k, m, 1,
                                    stream);
  else if (pairs)
    launch_instance<T, false, true>(values, idx, w, out, n, top_k, m, split,
                                    stream);
  else
    launch_instance<T, false, false>(values, idx, w, out, n, top_k, m,
                                     split, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int entry(const void* values, const void* idx, const void* w,
                  void* out, int n, int top_k, int m, int device,
                  void* stream) {
  cudaSetDevice(device);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch<T>(values, idx, w, out, n, top_k, m,
                   gather_batched::split_for(
                       n, top_k, gather_batched::sm_count(device)),
                   static_cast<cudaStream_t>(stream));
}

// The same gather with an explicit split (1, 2, 4 or 8 warps a query):
// for tests and A/B runs that hold every split to the plain version.
template <typename T>
static int entry_split(const void* values, const void* idx, const void* w,
                        void* out, int n, int top_k, int m, int split,
                        int device, void* stream) {
  cudaSetDevice(device);
  if (split != 1 && split != 2 && split != 4 && split != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch<T>(values, idx, w, out, n, top_k, m, split,
                   static_cast<cudaStream_t>(stream));
}

#define GATHER_INTERP(NAME, T)                                               \
  extern "C" int gather_interp_##NAME(const void* values, const void* idx,   \
                                      const void* w, void* out, int n,       \
                                      int top_k, int m, int device,          \
                                      void* stream) {                        \
    return entry<T>(values, idx, w, out, n, top_k, m, device, stream);      \
  }                                                                          \
  extern "C" int gather_interp_##NAME##_split(                               \
      const void* values, const void* idx, const void* w, void* out, int n,  \
      int top_k, int m, int split, int device, void* stream) {               \
    return entry_split<T>(values, idx, w, out, n, top_k, m, split, device,   \
                          stream);                                           \
  }

GATHER_INTERP(f32, float)
GATHER_INTERP(bf16, __nv_bfloat16)
GATHER_INTERP(f16, __half)
