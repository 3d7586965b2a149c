// Row 9's forward: the weighted gather over one rank's row-range shard of
// the table,
//
//   out[t] = sum_{k: base <= idx[t,k] < base + rows}
//                w[t,k] * (scale[r] if 1-byte) * shard[r],
//   r = idx[t,k] - base
//
// (fp32 sum), over an fp32, bf16 or fp16 shard (K1 on a shard; a 2-byte
// row is widened to fp32 exactly, as K1's bf16 and fp16 instances do) or
// an int8 / e4m3 shard with one fp32 scale per row (B4 on a shard).  An
// index outside the shard adds nothing and its row is not read: the other
// ranks of the `model` axis hold it, and the partial outputs are summed
// across ranks by one all-reduce outside the kernel
// (repro_torch.distributed.sharded_lram).
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
// read once (4m bytes, 2m for bf16 / fp16, or m + 4 for a 1-byte row and
// its scale), plus idx and w (4k bytes each a query) and the output (4m a
// query).  The
// 2*n*k*m flops of the in-range terms are far below the fp32 rate.
//
// Design: gather_batched.cuh's body with the RangeRows row map.  Lane l
// maps idx[t, l] to its shard row once; the warp compacts its candidates
// to this shard's with a ballot, in candidate order, so an index outside
// the shard costs no shuffle, branch or read (the TPU kernels read a
// clamped row at weight 0; with S shards, (S - 1) / S of the reads are
// skipped), and the in-range rows' loads go out together, kBatch at a
// time, before the first multiply-add.  At decode sizes a query is split
// over several warps of a block (from n and the card's SM count).  The
// old body (warp per query, once in gather_rows.cuh) shuffled every
// candidate and skipped the foreign ones inside its unroll-8 loop, so the
// loads it did issue came in short, ragged batches.  Not the NaN that the
// tiered row map gives a missing shard: "not mine" is a 0 term.

#include "gather_batched.cuh"

// Blocks an SM for the instances with one warp a query (the mesh step's
// n): 8, so 32 registers.  A warp here reads only the shard's part of its
// query's rows (about half on a 2-way split), so more warps keep more
// loads in flight: 8 blocks ran the range gather 4-17% faster at
// n = 32,768 than 4, where K1 ran 25-48% slower (tools/gather_sweep.py).
constexpr int kOneWarpMinBlocks = 8;

template <typename T, bool kScaled, bool kOneWarp, bool kPairs>
__global__ void __launch_bounds__(gather_batched::kThreads,
                                  kOneWarp ? kOneWarpMinBlocks
                                           : gather_batched::kMinBlocks)
sharded_gather_kernel(const T* __restrict__ values,
                      const float* __restrict__ scale,
                      const int32_t* __restrict__ idx,
                      const float* __restrict__ w, float* __restrict__ out,
                      int n, int top_k, int m, int base, int rows,
                      int split) {
  gather_batched::gather<T, kScaled, kOneWarp, kPairs>(
      values, scale, idx, w, out, n, top_k, m, split,
      gather_rows::RangeRows{base, rows});
}

template <typename T, bool kScaled, bool kOneWarp, bool kPairs>
static void launch_instance(const void* values, const void* scale,
                            const void* idx, const void* w, void* out, int n,
                            int top_k, int m, int base, int rows, int split,
                            cudaStream_t stream) {
  sharded_gather_kernel<T, kScaled, kOneWarp, kPairs>
      <<<gather_batched::blocks_for(n, split), gather_batched::kThreads, 0,
         stream>>>(static_cast<const T*>(values),
                   static_cast<const float*>(scale),
                   static_cast<const int32_t*>(idx),
                   static_cast<const float*>(w), static_cast<float*>(out), n,
                   top_k, m, base, rows, split);
}

template <typename T, bool kScaled>
static int launch(const void* values, const void* scale, const void* idx,
                  const void* w, void* out, int n, int top_k, int m,
                  int base, int rows, int device, void* stream) {
  cudaSetDevice(device);
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int split = gather_batched::split_for(
        n, top_k, gather_batched::sm_count(device));
    const bool pairs = m % 2 == 0;  // pair loads stay aligned
    if (split == 1 && pairs)
      launch_instance<T, kScaled, true, true>(values, scale, idx, w, out, n,
                                              top_k, m, base, rows, 1, s);
    else if (split == 1)
      launch_instance<T, kScaled, true, false>(values, scale, idx, w, out, n,
                                               top_k, m, base, rows, 1, s);
    else if (pairs)
      launch_instance<T, kScaled, false, true>(values, scale, idx, w, out, n,
                                               top_k, m, base, rows, split,
                                               s);
    else
      launch_instance<T, kScaled, false, false>(values, scale, idx, w, out,
                                                n, top_k, m, base, rows,
                                                split, s);
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

// bf16 shard (K1's bf16 instance on a shard: the sharded gather's
// .astype(w_l.dtype) of the reference, :105)
extern "C" int sharded_gather_bf16(const void* values, const void* idx,
                                   const void* w, void* out, int n, int top_k,
                                   int m, int base, int rows, int device,
                                   void* stream) {
  return launch<__nv_bfloat16, false>(values, nullptr, idx, w, out, n, top_k,
                                      m, base, rows, device, stream);
}

// fp16 shard (K1's fp16 instance on a shard)
extern "C" int sharded_gather_f16(const void* values, const void* idx,
                                  const void* w, void* out, int n, int top_k,
                                  int m, int base, int rows, int device,
                                  void* stream) {
  return launch<__half, false>(values, nullptr, idx, w, out, n, top_k, m,
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
