// Dense masked block top-k for Hopper (sm_90a): keep the k largest
// magnitudes of every 1024-element block, zero the rest.
//
// Replaces block_topk_pallas (pl.pallas_call at
// src/repro/kernels/block_topk.py:61, body _block_topk_kernel at :28-52)
// and its wrapper's padding of the block rows to the 8-row TPU tile
// (kernels/ops.py:43-50). One launch covers every block of every node of a
// leaf; the ragged last block reads its missing elements as 0 (the
// reference's zero padding, which can be picked as ties) and positions at
// or past n are not written, as the reference's [:n] slice drops them.
//
// What bounds it on an H100: the function's own bound is bytes, one f32
// read and one f32 write an element (8 bytes at 3.35 TB/s) against pack's
// 44 f32 operations an element at 67 TFLOP/s. This design is bound, as
// pack is, by the instruction issue of pack_tile.cuh's selection (the
// 31-pass search for the block's k-th magnitude, then the rank), and on
// the small leaves by launch latency: it keeps one launch a leaf.
// What the design does about that: it is pack's warp-per-block tile
// (pack_tile.cuh: load_block, block_max, bisect_block, rank_block, not
// copied), so it runs the same selection, with a dense epilogue: every
// lane writes its 32 elements, the survivor's value or 0, as coalesced
// 128-byte rows.
#include "pack_tile.cuh"

namespace repro_torch {

// x and out are (rows, n) row-major; warp w masks block w % nb of row w / nb.
__global__ void __launch_bounds__(kWarpsPerCta * 32)
block_topk_kernel(const float* __restrict__ x, float* __restrict__ out,
                  long long rows, long long n, long long nb, int k) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (warp >= rows * nb) return;                  // uniform within a warp
  const long long row = warp / nb;
  const long long start = (warp - row * nb) * kBlock;

  float d[kPerLane];
  load_block<false, float>(x + row * n, nullptr, start, n, lane, d);
  const float m = block_max(d);
  float lo, hi;
  bisect_block(d, m, k, lo, hi);

  // the reference keeps every definite survivor (mask_def | ...), which is
  // more than k only when k or more elements are ±inf (lo = hi = inf);
  // a NaN is neither definite nor a tie, so it becomes 0 (ROADMAP C6)
  float* orow = out + row * n;
  rank_block(d, lo, hi, k, lane, [&](int j, bool keep, int) {
    const long long e = start + j * 32 + lane;
    if (e < n) orow[e] = keep || fabsf(d[j]) >= hi ? d[j] : 0.0f;
  });
}

}  // namespace repro_torch

extern "C" int repro_block_topk(const float* x, float* out, long long rows,
                                long long n, long long nb, int k,
                                void* stream) {
  const long long warps = rows * nb;
  if (warps > 0 && n > 0) {
    const long long ctas =
        (warps + repro_torch::kWarpsPerCta - 1) / repro_torch::kWarpsPerCta;
    repro_torch::block_topk_kernel<<<(unsigned)ctas,
                                     repro_torch::kWarpsPerCta * 32, 0,
                                     (cudaStream_t)stream>>>(x, out, rows, n,
                                                             nb, k);
  }
  return (int)cudaGetLastError();
}
