// Block-top-k wire format for Hopper (sm_90a): pack and unpack.
//
// Replaces the Pallas kernels of src/repro/kernels/pack.py:
//   repro_pack_topk   <- pack_topk_pallas   (pl.pallas_call at pack.py:104,
//                        body _pack_tile at pack.py:39-80)
//   repro_unpack_topk <- unpack_topk_pallas (pl.pallas_call at pack.py:122)
//
// What bounds them on an H100:
//   pack   — the function's own bound is the read of the block: per
//            element, 4 bytes at 3.35 TB/s (1.2 ps) against 44 f32
//            operations (|x|, the max, 40 compares, 2 masks) at 67 TFLOP/s
//            (0.66 ps). This design is bound by instruction issue: the
//            k-th-magnitude search of pack_tile.cuh is up to 31 passes of 32
//            compares and adds a lane (~70 warp instructions a pass), and
//            the rank adds ~160 popcounts a lane, at 16 a clock per SM.
//   unpack — bytes: the dense (rows, n) f32 output is written once at
//            3.35 TB/s; the (rows, nb, k) input is wire-sized.
// What the design does about that:
//   pack   — one warp per block, the block held in registers (32 values a
//            lane), so the search never touches memory; it counts per lane
//            and sums the warp with one __reduce_add_sync a pass (no ballots,
//            no popcounts), and the bisection's 40 steps are replayed from
//            the k-th magnitude in scalar registers. One launch covers every
//            leaf of a table (up to kMaxLeaves): the small leaves' few blocks
//            run beside fc1.w's, not as launches of 1-24 CTAs of their own.
//   unpack — one CTA per block: coalesced fill of the block, a CTA
//            barrier, then k scattered stores. Block-local indices are
//            distinct, so the stores never conflict.
#include "pack_tile.cuh"

namespace repro_torch {

constexpr int kUnpackThreads = 256;

// vals/idx (rows, nb, k) -> out (rows, n); positions at or past n (the
// ragged last block's zero padding) are dropped, as the reference's [:n].
//
// Values follow the reference's one-hot contraction (pack.py:95-96),
// out[b] = 0 + Σ_s vals[s]·[idx[s] == b]: a -0.0 value decodes to +0.0, and
// since 0·inf and 0·NaN are NaN, a block whose values hold a non-finite
// decodes to NaN everywhere but at the index of a lone non-finite value,
// which keeps it (ROADMAP C6).
__global__ void __launch_bounds__(kUnpackThreads)
unpack_kernel(const float* __restrict__ vals, const uint16_t* __restrict__ idx,
              float* __restrict__ out, long long n, long long nb, int k) {
  const long long blk = blockIdx.x;
  const long long row = blk / nb;
  const long long start = (blk - row * nb) * kBlock;
  const float* vb = vals + blk * k;
  const uint16_t* ib = idx + blk * k;
  int bad = 0;                        // this thread's non-finite values
  for (int s = threadIdx.x; s < k; s += kUnpackThreads)
    bad += !is_finite(vb[s]);
  const int bad_threads = __syncthreads_count(bad > 0);
  const int multi = __syncthreads_or(bad > 1);
  const bool lone = bad_threads == 1 && !multi;   // one non-finite value
  const float fill = bad_threads ? quiet_nan() : 0.0f;
  float* orow = out + row * n;
  for (int e = threadIdx.x; e < kBlock; e += kUnpackThreads)
    if (start + e < n) orow[start + e] = fill;
  __syncthreads();
  for (int s = threadIdx.x; s < k; s += kUnpackThreads) {
    const float v = vb[s];
    const long long e = start + ib[s];
    if (e < n && (!bad_threads || (lone && !is_finite(v))))
      orow[e] = __fadd_rn(v, 0.0f);
  }
}

}  // namespace repro_torch

// One launch packs `count` <= kMaxLeaves leaves of `rows` rows each: leaf l
// is xs[l], (rows, ns[l]) with nbs[l] blocks a row, and its payload starts
// at element outs[l] of vals and idx.
extern "C" int repro_pack_topk(const float* const* xs, const long long* ns,
                               const long long* nbs, const long long* outs,
                               int count, long long rows, float* vals,
                               uint16_t* idx, int k, void* stream) {
  return repro_torch::launch_pack<false>(xs, nullptr, ns, nbs, outs, count,
                                         rows, vals, idx, k, stream);
}

extern "C" int repro_unpack_topk(const float* vals, const uint16_t* idx,
                                 float* out, long long rows, long long n,
                                 long long nb, int k, void* stream) {
  const long long ctas = rows * nb;
  if (ctas > 0 && n > 0)
    repro_torch::unpack_kernel<<<(unsigned)ctas, repro_torch::kUnpackThreads,
                                 0, (cudaStream_t)stream>>>(vals, idx, out, n,
                                                            nb, k);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
