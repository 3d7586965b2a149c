// The query order K1 was tried with and dropped (PERF.md): a
// counting sort of K1's queries by the bucket of their top candidate's
// row, idx[t, 0] * kBuckets / rows (the torus table's mixed-radix row
// index, so a bucket is a slab of lattice neighbours), so that queries
// sharing rows run close in time and L2 serves a row's later reads.
// Built and timed by tools/kernel_ab.py (--phases order) only: no path of
// the port runs it.
//
// count: counts[key]++ for every query; the last block to finish turns the
// counts into each bucket's first position (one int4 load round trip a
// thread, one block-wide scan).  place: order[starts[key]++] = t; the
// order within a bucket is the atomics' and changes from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBuckets = 16384;
constexpr int kThreads = 1024;
constexpr int kPer = kBuckets / kThreads;  // 16 counts a thread: four int4
// scratch (int32 words): counts [kBuckets], the ticket and 3 words of
// padding (starts stays 16-byte aligned), starts [kBuckets], order [n]
constexpr int kHead = 2 * kBuckets + 4;

__device__ __forceinline__ int key_of(const int32_t* idx, int t, int top_k,
                                      int rows) {
  const int64_t r =
      min(max(idx[static_cast<int64_t>(t) * top_k], 0), rows - 1);
  return static_cast<int>(r * kBuckets / rows);
}

__global__ void __launch_bounds__(kThreads)
query_order_count_kernel(const int32_t* __restrict__ idx, int n, int top_k,
                         int rows, int* counts, unsigned* ticket,
                         int* starts) {
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += gridDim.x * blockDim.x)
    atomicAdd(counts + key_of(idx, t, top_k, rows), 1);
  __shared__ bool last;
  __shared__ int warp_sums[kThreads / 32];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int c[kPer];
#pragma unroll
  for (int v = 0; v < kPer / 4; ++v) {
    const int4 q =
        __ldcg(reinterpret_cast<const int4*>(counts) + tid * (kPer / 4) + v);
    c[4 * v] = q.x;
    c[4 * v + 1] = q.y;
    c[4 * v + 2] = q.z;
    c[4 * v + 3] = q.w;
  }
  int local = 0;
#pragma unroll
  for (int b = 0; b < kPer; ++b) local += c[b];
  int incl = local;  // inclusive scan over the warp, then over the warps
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  int run = incl - local + (warp > 0 ? warp_sums[warp - 1] : 0);
#pragma unroll
  for (int v = 0; v < kPer / 4; ++v) {
    int4 q;
    q.x = run;
    q.y = q.x + c[4 * v];
    q.z = q.y + c[4 * v + 1];
    q.w = q.z + c[4 * v + 2];
    run = q.w + c[4 * v + 3];
    reinterpret_cast<int4*>(starts)[tid * (kPer / 4) + v] = q;
  }
}

__global__ void __launch_bounds__(kThreads)
query_order_place_kernel(const int32_t* __restrict__ idx, int n, int top_k,
                         int rows, int* starts, int32_t* __restrict__ order) {
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += gridDim.x * blockDim.x)
    order[atomicAdd(starts + key_of(idx, t, top_k, rows), 1)] = t;
}

}  // namespace

extern "C" long long query_order_scratch(int n) {
  return kHead + static_cast<long long>(n);
}

// The order of the n queries of idx (n, top_k) into scratch's last n words.
extern "C" int query_order(const void* idx, void* scratch, int n, int top_k,
                           int rows, int device, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* counts = static_cast<int*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(counts + kBuckets);
  int* starts = counts + kBuckets + 4;
  cudaMemsetAsync(counts, 0, (kBuckets + 1) * sizeof(int), s);
  if (n > 0) {
    const int blocks = min((n + kThreads - 1) / kThreads, 1024);
    query_order_count_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(idx), n, top_k, rows, counts, ticket,
        starts);
    query_order_place_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(idx), n, top_k, rows, starts,
        counts + kHead);
  }
  return static_cast<int>(cudaGetLastError());
}
