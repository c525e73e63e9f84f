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
//            (0.66 ps). This design is bound by neither: it is bound by the
//            popcount issue rate. Each of the 40 passes issues 32 __popc a
//            lane, 1,024 a block, and Hopper retires 16 popcounts per SM per
//            clock. On fc1.w at K=10 (25,170 blocks) that is 1.0e9 popcounts,
//            about 0.25-0.28 ms on 132 SMs at 1.75-1.98 GHz, against a byte
//            bound of 0.031 ms.
//   unpack — bytes: the dense (rows, n) f32 output is written once at
//            3.35 TB/s; the (rows, nb, k) input is wire-sized.
// What the simple design does about that:
//   pack   — one warp per block, the block held in registers (32 values a
//            lane), so the 40 passes never touch memory: each pass is 32
//            register compares, 32 ballots and 32 popcounts per lane. The
//            two-tier rank is a prefix popcount per ballot row, with no
//            shared memory and no sort. The bisection is kept (not a radix
//            select): a radix select picks another set when two magnitudes
//            fall into the bisection's final bracket. The next step for
//            speed is to drop the popcounts from the passes: each lane counts
//            its own 32 compares and one __reduce_add_sync a pass sums the
//            warp, which moves the passes onto the compare and add pipes.
//   unpack — one CTA per block: coalesced zero fill of the block, a CTA
//            barrier, then k scattered stores. Block-local indices are
//            distinct, so the stores never conflict.
#include "pack_tile.cuh"

namespace repro_torch {

constexpr int kUnpackThreads = 256;

// vals/idx (rows, nb, k) -> out (rows, n); positions at or past n (the
// ragged last block's zero padding) are dropped, as the reference's [:n].
__global__ void __launch_bounds__(kUnpackThreads)
unpack_kernel(const float* __restrict__ vals, const uint16_t* __restrict__ idx,
              float* __restrict__ out, long long n, long long nb, int k) {
  const long long blk = blockIdx.x;
  const long long row = blk / nb;
  const long long start = (blk - row * nb) * kBlock;
  float* orow = out + row * n;
  for (int e = threadIdx.x; e < kBlock; e += kUnpackThreads)
    if (start + e < n) orow[start + e] = 0.0f;
  __syncthreads();
  for (int s = threadIdx.x; s < k; s += kUnpackThreads) {
    const long long e = start + idx[blk * k + s];
    if (e < n) orow[e] = vals[blk * k + s];
  }
}

}  // namespace repro_torch

extern "C" int repro_pack_topk(const float* x, float* vals, uint16_t* idx,
                               long long rows, long long n, long long nb,
                               int k, void* stream) {
  return repro_torch::launch_pack<false>(x, nullptr, vals, idx, rows, n, nb,
                                         k, stream);
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
