// Fused delta-pack for Hopper (sm_90a): encode Q(θ − v) without writing the
// residual.
//
// Replaces delta_pack_pallas (pl.pallas_call at
// src/repro/kernels/fused_compress.py:58, body _delta_pack_kernel at :41-48)
// and the wrapper's aligned-head / padded-tail split (kernels/ops.py:141-174).
// The split is a TPU tiling device (8-row tiles) and is not carried over:
// one launch covers every block of every node of a leaf, and the ragged last
// block reads its missing elements as 0, which is what the reference's
// zero-padded tail tile holds (θ − v = 0 − 0 there).
//
// What bounds it on an H100: the function's own bound is two reads of the
// leaf (θ and v, 8 bytes an element at 3.35 TB/s, 2.4 ps) against the 40
// compare passes of the bisection (45 f32 operations an element with the
// subtraction, 0.67 ps at 67 TFLOP/s) and a wire-sized write. This design
// is bound by the popcount issue rate of its 40 passes, as pack is (see
// pack.cu). The residual d = θ − v is formed in registers (__fsub_rn, the
// reference's f32 subtraction) and never reaches device memory: that is the kernel's whole point, and the design
// keeps it by running the shared register-resident tile (pack_tile.cuh)
// with HAS_V = true.
#include "pack_tile.cuh"

extern "C" int repro_delta_pack(const float* theta, const float* v,
                                float* vals, uint16_t* idx, long long rows,
                                long long n, long long nb, int k,
                                void* stream) {
  return repro_torch::launch_pack<true>(theta, v, vals, idx, rows, n, nb, k,
                                        stream);
}
