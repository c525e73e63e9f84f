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

constexpr int kQuantThreads = 256;
constexpr long long kQuantMaxCtasX = 1024;

__device__ __forceinline__ float qsgd_level(float x, float u, float norm,
                                            float levels) {
  const float scaled = __fmul_rn(__fdiv_rn(fabsf(x), norm), levels);
  const float lower = floorf(scaled);
  return __fadd_rn(lower, u < __fsub_rn(scaled, lower) ? 1.0f : 0.0f);
}

// Grid of grid_quant's (rows, cols) pass, one thread an element: blockIdx.y walks the rows (a row's norm is
// then one load a thread), blockIdx.x strides over the columns.
inline dim3 rows_grid(long long rows, long long cols) {
  long long x = (cols + kQuantThreads - 1) / kQuantThreads;
  x = x < kQuantMaxCtasX ? x : kQuantMaxCtasX;
  const long long y = rows < 65535 ? rows : 65535;
  return dim3((unsigned)x, (unsigned)y);
}

}  // namespace repro_torch
