// Compress-in-update for Hopper (sm_90a): the two kernels of the fused
// block_topk|qsgd encode.
//
// 1. delta-pack: the block-top-k pack of θ − v without writing the
//    residual. Replaces delta_pack_pallas (pl.pallas_call at
//    src/repro/kernels/fused_compress.py:58, body _delta_pack_kernel at
//    :41-48) and the wrapper's aligned-head / padded-tail split
//    (kernels/ops.py:141-174). The split is a TPU tiling device (8-row
//    tiles) and is not carried over: the ragged last block reads its
//    missing elements as 0, which is what the reference's zero-padded tail
//    tile holds (θ − v = 0 − 0 there).
//    What bounds it on an H100: the function's own bound is two reads of
//    the leaf (θ and v, 8 bytes an element at 3.35 TB/s, 2.4 ps) against
//    45 f32 operations an element with the subtraction (0.67 ps at
//    67 TFLOP/s) and a wire-sized write. This design is bound by the
//    instruction issue of pack_tile.cuh's selection, as pack is (see
//    pack.cu): the 31-pass search for the block's k-th magnitude, then the
//    rank's ballots and popcounts.
//    What the design does about that: the residual d = θ − v is formed in
//    registers (__fsub_rn, the reference's f32 subtraction) and never
//    reaches device memory, which is the kernel's whole point; the shared
//    register-resident tile runs with HAS_V = true. The round encodes every
//    packed leaf with one launch over a table of the leaves (the codec's
//    one call a round), so the small leaves' blocks run beside fc1.w's.
//
// 2. grid_quant: QSGD stochastic rounding of the packed (rows, nb·k)
//    carrier onto the signed integer grid, sign(x)·q as int8, each row
//    (node) with its own norm ‖carrier‖₂ + 1e-12 (a torch reduction between
//    the two kernels, as the reference's wrapper computes it in jnp,
//    kernels/ops.py:177-196). Replaces grid_quant_pallas (pl.pallas_call at
//    src/repro/kernels/fused_compress.py:93, body _grid_quant_kernel at
//    :71-77); the wrapper's padding of the rows to the 8-row TPU tile is
//    not carried over. The level arithmetic is qsgd_round.cuh's, shared
//    with the dense qsgd kernel. q <= s <= 64 fits int8.
//    What bounds it on an H100: bytes, two f32 reads and one int8 write an
//    element (9 bytes) against ~6 f32 operations; but the carrier is
//    wire-sized (280,060 elements a round at full width and K=10, 2.5 MB),
//    so launch latency, not either bound, sets its time. One thread an
//    element, coalesced; nothing more is worth doing at this size.
#include "pack_tile.cuh"
#include "qsgd_round.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kQuantThreads)
grid_quant_kernel(const float* __restrict__ x, const float* __restrict__ u,
                  const float* __restrict__ norm, int8_t* __restrict__ q,
                  long long rows, long long m, float levels) {
  const long long stride = (long long)gridDim.x * kQuantThreads;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float nrm = norm[row];
    const long long base = row * m;
    for (long long c = (long long)blockIdx.x * kQuantThreads + threadIdx.x;
         c < m; c += stride) {
      const float f = x[base + c];
      const int level = (int)qsgd_level(f, u[base + c], nrm, levels);
      q[base + c] = (int8_t)(f > 0.0f ? level : (f < 0.0f ? -level : 0));
    }
  }
}

}  // namespace repro_torch

// One launch packs θ − v of `count` <= kMaxLeaves leaves of `rows` rows
// each: leaf l is thetas[l] and vs[l], (rows, ns[l]) with nbs[l] blocks a
// row, and its payload starts at element outs[l] of vals and idx.
extern "C" int repro_delta_pack(const float* const* thetas,
                                const float* const* vs, const long long* ns,
                                const long long* nbs, const long long* outs,
                                int count, long long rows, float* vals,
                                uint16_t* idx, int k, void* stream) {
  return repro_torch::launch_pack<true>(thetas, vs, ns, nbs, outs, count,
                                        rows, vals, idx, k, stream);
}

extern "C" int repro_grid_quant(const float* x, const float* u,
                                const float* norm, int8_t* q, long long rows,
                                long long m, float levels, void* stream) {
  if (rows > 0 && m > 0)
    repro_torch::grid_quant_kernel<<<repro_torch::rows_grid(rows, m),
                                     repro_torch::kQuantThreads, 0,
                                     (cudaStream_t)stream>>>(x, u, norm, q,
                                                             rows, m, levels);
  return (int)cudaGetLastError();
}
