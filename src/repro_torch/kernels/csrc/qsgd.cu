// Dense QSGD quantize-and-dequantize for Hopper (sm_90a):
//
//     out = sign(x) · q · ‖x‖ / s · r,   r = 1 / (1 + ω) in f32
//
// Replaces qsgd_pallas (pl.pallas_call at src/repro/kernels/qsgd.py:50, body
// _qsgd_kernel at :30-40) and its wrapper's (256, 128) tiling
// (kernels/ops.py:116-132): one launch covers every node's row of a leaf,
// each with its own norm (‖x‖₂ + 1e-12, a torch reduction between
// kernels, as the reference's wrapper computes it in jnp).
//
// Rounding follows the reference as it executes. The kernel body writes
// `sign(x) * q * norm / levels / (1.0 + omega)`; XLA folds the division by
// the constant 1 + ω into a multiplication by its f32 reciprocal, which
// this kernel takes as `r` (the wrapper computes it in f32). The level
// count s is a power of two (the port's FedConfig allows no other), so
// the division by s is exact in every form. sign keeps a zero's sign, as
// jnp.sign does: −0.0 in gives −0.0 out.
//
// What bounds it on an H100: bytes. Two f32 reads (x, u) and one f32 write
// an element, 12 bytes at 3.35 TB/s, against ~8 f32 operations at
// 67 TFLOP/s. What the simple design does about that: one thread an
// element, consecutive threads on consecutive addresses, so every access
// is a coalesced 128-byte row; the norm is one load a thread a row.
#include <cuda_runtime.h>

#include "qsgd_round.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kQuantThreads)
qsgd_kernel(const float* __restrict__ x, const float* __restrict__ u,
            const float* __restrict__ norm, float* __restrict__ out,
            long long rows, long long n, float levels, float recip) {
  const long long stride = (long long)gridDim.x * kQuantThreads;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float nrm = norm[row];
    const long long base = row * n;
    for (long long c = (long long)blockIdx.x * kQuantThreads + threadIdx.x;
         c < n; c += stride) {
      const float f = x[base + c];
      const float q = qsgd_level(f, u[base + c], nrm, levels);
      const float sgn = f > 0.0f ? 1.0f : (f < 0.0f ? -1.0f : f);
      out[base + c] = __fmul_rn(
          __fdiv_rn(__fmul_rn(__fmul_rn(sgn, q), nrm), levels), recip);
    }
  }
}

}  // namespace repro_torch

extern "C" int repro_qsgd(const float* x, const float* u, const float* norm,
                          float* out, long long rows, long long n,
                          float levels, float recip, void* stream) {
  if (rows > 0 && n > 0)
    repro_torch::qsgd_kernel<<<repro_torch::rows_grid(rows, n),
                               repro_torch::kQuantThreads, 0,
                               (cudaStream_t)stream>>>(x, u, norm, out, rows,
                                                       n, levels, recip);
  return (int)cudaGetLastError();
}
