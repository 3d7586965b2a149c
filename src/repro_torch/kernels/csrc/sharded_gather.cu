// Row 9's forward: the weighted gather over one rank's row-range shard of
// the table,
//
//   out[t] = sum_{k: base <= idx[t,k] < base + rows}
//                w[t,k] * (scale[r] if 1-byte) * shard[r],
//   r = idx[t,k] - base
//
// (fp32 sum), over an fp32 shard (K1 on a shard) or an int8 / e4m3 shard
// with one fp32 scale per row (B4 on a shard).  An index outside the shard
// adds nothing and its row is not read: the other ranks of the `model`
// axis hold it, and the partial outputs are summed across ranks by one
// all-reduce outside the kernel (repro_torch.distributed.sharded_lram).
//
// Replaces the shard-local gathers of src/repro/distributed/sharded_lram.py
// (sharded_gather_interp, :62-136): inside a shard_map, the TPU kernel
// src/repro/kernels/gather_interp.py gather_interp_pallas (pallas_call at
// :73, through gather_interp_vjp, :92-102) for fp32 shards and
// gather_interp_quant_pallas (pallas_call at :138, through
// gather_interp_quant, :104-118) for 1-byte shards, each run on the
// clamped local indices clip(idx - base) with the weights w * ok, so that
// an out-of-range index reads local row 0 or rows - 1 at weight 0.
//
// Bound on an H100: bytes, at 3.35 TB/s.  Each distinct in-range row is
// read once (4m bytes, or m + 4 for a 1-byte row and its scale), plus
// idx and w (4k bytes each a query) and the output (4m a query).  The
// 2*n*k*m flops of the in-range terms are far below the fp32 rate.
//
// Design: the warp-per-row gather of gather_rows.cuh with the RangeRows
// row map.  Lane l maps idx[t, l] to its shard row once; an index outside
// the shard gets weight 0 and the marker kNotMine, and the warp skips that
// broadcast row (every lane holds the same row, so the branch is uniform)
// instead of reading a clamped row at weight 0 as the TPU kernels do: with
// S shards, (S - 1) / S of the reads are skipped.  Not the NaN that the
// tiered row map gives a missing shard: "not mine" is a 0 term.

#include "gather_rows.cuh"

template <typename T, bool kScaled>
__global__ void __launch_bounds__(gather_rows::kWarps * 32)
sharded_gather_kernel(const T* __restrict__ values,
                      const float* __restrict__ scale,
                      const int32_t* __restrict__ idx,
                      const float* __restrict__ w, float* __restrict__ out,
                      int n, int top_k, int m, int base, int rows) {
  gather_rows::gather_rows<T, kScaled>(values, scale, idx, w, out, n, top_k,
                                       m, gather_rows::RangeRows{base, rows});
}

template <typename T, bool kScaled>
static int launch(const void* values, const void* scale, const void* idx,
                  const void* w, void* out, int n, int top_k, int m,
                  int base, int rows, int device, void* stream) {
  cudaSetDevice(device);
  if (n > 0) {
    sharded_gather_kernel<T, kScaled><<<gather_rows::blocks_for(n),
                                        gather_rows::kWarps * 32, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(values), static_cast<const float*>(scale),
        static_cast<const int32_t*>(idx), static_cast<const float*>(w),
        static_cast<float*>(out), n, top_k, m, base, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// fp32 shard (K1 on a shard)
extern "C" int sharded_gather_f32(const void* values, const void* idx,
                                  const void* w, void* out, int n, int top_k,
                                  int m, int base, int rows, int device,
                                  void* stream) {
  return launch<float, false>(values, nullptr, idx, w, out, n, top_k, m,
                              base, rows, device, stream);
}

// 1-byte shards with one fp32 scale per row (B4 on a shard)
extern "C" int sharded_gather_quant_i8(const void* q, const void* scale,
                                       const void* idx, const void* w,
                                       void* out, int n, int top_k, int m,
                                       int base, int rows, int device,
                                       void* stream) {
  return launch<int8_t, true>(q, scale, idx, w, out, n, top_k, m, base,
                              rows, device, stream);
}

extern "C" int sharded_gather_quant_e4m3(const void* q, const void* scale,
                                         const void* idx, const void* w,
                                         void* out, int n, int top_k, int m,
                                         int base, int rows, int device,
                                         void* stream) {
  return launch<__nv_fp8_e4m3, true>(q, scale, idx, w, out, n, top_k, m,
                                     base, rows, device, stream);
}
