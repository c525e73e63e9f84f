// QSGD stochastic rounding, shared by grid_quant (fused_compress.cu) and
// qsgd (qsgd.cu), on (rows, cols) operands whose rows each have their own
// norm.
//
// The level of an element is the reference's
//     scaled = |x| / norm · s;  lower = ⌊scaled⌋;  q = lower + [u < scaled − lower]
// (src/repro/kernels/fused_compress.py:71-77, src/repro/kernels/qsgd.py:
// 30-40, and QSGDCodec.encode), each operation rounded once in f32:
// __fdiv_rn is the IEEE division whatever the build's flags say, and the
// build passes --fmad=false, so nothing is contracted.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

__device__ __forceinline__ float qsgd_level(float x, float u, float norm,
                                            float levels) {
  const float scaled = __fmul_rn(__fdiv_rn(fabsf(x), norm), levels);
  const float lower = floorf(scaled);
  return __fadd_rn(lower, u < __fsub_rn(scaled, lower) ? 1.0f : 0.0f);
}

}  // namespace repro_torch
