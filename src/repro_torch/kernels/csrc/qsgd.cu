// Dense QSGD quantize-and-dequantize for Hopper (sm_90a):
//
//     out = sign(x) · q · ‖x‖ / s · r,   r = 1 / (1 + ω) in f32
//
// Replaces qsgd_pallas (pl.pallas_call at src/repro/kernels/qsgd.py:50, body
// _qsgd_kernel at :30-40) and its wrapper's (256, 128) tiling
// (kernels/ops.py:116-132): one launch covers every node's row of every
// leaf of a table (up to kQsgdMaxLeaves), each row with its own norm
// (‖x‖₂ + 1e-12, a torch reduction between kernels, as the reference's
// wrapper computes it in jnp).
//
// Rounding follows the reference as it executes. The kernel body writes
// `sign(x) * q * norm / levels / (1.0 + omega)`; XLA folds the division by
// the constant 1 + ω into a multiplication by its f32 reciprocal, which
// this kernel takes as `r` (the wrapper computes it in f32, per leaf: ω
// depends on n). The level count s is a power of two (the port's
// FedConfig allows no other, and the wrapper checks it), so the division
// by s is a multiplication by its exact reciprocal: the same real number,
// rounded once, subnormals included. sign keeps a zero's sign, as
// jnp.sign does: −0.0 in gives −0.0 out.
//
// What bounds it on an H100: bytes. Two f32 reads (x, u) and one f32 write
// an element, 12 bytes at 3.35 TB/s, against ~8 f32 operations at
// 67 TFLOP/s. What the design does about that: bytes in flight. A CTA
// takes one tile of 4096 elements of one row (tiles never cross a row, so
// the leaf, row and norm are looked up once a tile); each thread issues
// all its 16-byte loads of x and u (4 float4 each, 128 bytes) before any
// arithmetic, then stores float4. Leaves whose rows do not start 16-byte
// aligned (n % 4 != 0, or a misaligned operand) take a scalar path in the
// same launch; the choice is uniform per leaf. The grid is the tiles of
// the whole table, so the small leaves' few tiles run beside fc1.w's.
#include <cstdint>
#include <cuda_runtime.h>

#include "qsgd_round.cuh"

namespace repro_torch {

constexpr int kQuantThreads = 256;
constexpr int kQsgdVecs = 4;                              // float4 a thread
constexpr int kQsgdTile = kQuantThreads * kQsgdVecs * 4;  // 4096 elements
constexpr int kQsgdMaxLeaves = 32;                        // MAX_TABLE_LEAVES

// Leaf l: (rows, n) x, u and out, (rows,) norm, and its f32 1 / (1 + ω);
// its tiles (tiles a row: ceil(n / kQsgdTile)) are the launch's CTAs
// begin .. begin + rows·tiles − 1. A kernel parameter (__grid_constant__).
struct QsgdLeaf {
  const float* x;
  const float* u;
  const float* norm;
  float* out;
  long long n, tiles, begin;
  float recip;
  int vec;
};

struct QsgdTable {
  QsgdLeaf leaf[kQsgdMaxLeaves];
  int count;
};

__device__ __forceinline__ float qsgd_value(float f, float u, float nrm,
                                            float levels, float inv_levels,
                                            float recip) {
  const float q = qsgd_level(f, u, nrm, levels);
  const float sgn = f > 0.0f ? 1.0f : (f < 0.0f ? -1.0f : f);
  return __fmul_rn(
      __fmul_rn(__fmul_rn(__fmul_rn(sgn, q), nrm), inv_levels), recip);
}

__global__ void __launch_bounds__(kQuantThreads)
qsgd_kernel(const __grid_constant__ QsgdTable table, float levels,
            float inv_levels) {
  const long long tile = blockIdx.x;
  int l = 0;
  while (l + 1 < table.count && tile >= table.leaf[l + 1].begin) ++l;
  const QsgdLeaf& leaf = table.leaf[l];
  const long long local = tile - leaf.begin;
  const long long row = local / leaf.tiles;
  const long long col = (local - row * leaf.tiles) * kQsgdTile;
  const long long n = leaf.n;
  const long long base = row * n + col;           // the tile's first element
  const float nrm = leaf.norm[row];
  const float recip = leaf.recip;

  if (leaf.vec) {                                 // uniform within the CTA
    const float4* x4 = reinterpret_cast<const float4*>(leaf.x + base);
    const float4* u4 = reinterpret_cast<const float4*>(leaf.u + base);
    float4* o4 = reinterpret_cast<float4*>(leaf.out + base);
    const long long left = (n - col) / 4;         // float4s left in the row
    float4 xv[kQsgdVecs], uv[kQsgdVecs];
#pragma unroll
    for (int j = 0; j < kQsgdVecs; ++j) {         // every load first
      const int c = threadIdx.x + j * kQuantThreads;
      if (c < left) {
        xv[j] = __ldg(x4 + c);
        uv[j] = __ldg(u4 + c);
      }
    }
#pragma unroll
    for (int j = 0; j < kQsgdVecs; ++j) {
      const int c = threadIdx.x + j * kQuantThreads;
      if (c < left) {
        float4 r;
        r.x = qsgd_value(xv[j].x, uv[j].x, nrm, levels, inv_levels, recip);
        r.y = qsgd_value(xv[j].y, uv[j].y, nrm, levels, inv_levels, recip);
        r.z = qsgd_value(xv[j].z, uv[j].z, nrm, levels, inv_levels, recip);
        r.w = qsgd_value(xv[j].w, uv[j].w, nrm, levels, inv_levels, recip);
        o4[c] = r;
      }
    }
  } else {
    const long long left = n - col;
    for (int e = threadIdx.x; e < kQsgdTile && e < left; e += kQuantThreads)
      leaf.out[base + e] = qsgd_value(leaf.x[base + e], leaf.u[base + e], nrm,
                                      levels, inv_levels, recip);
  }
}

}  // namespace repro_torch

// One launch quantizes `count` <= kQsgdMaxLeaves leaves: leaf l is
// (rows[l], ns[l]) x, u, out (xs[l], us[l], outs[l]) with (rows[l],)
// norms[l] and f32 reciprocal recips[l]; every leaf has n >= 1 and
// rows >= 1. levels is a power of two.
extern "C" int repro_qsgd(const float* const* xs, const float* const* us,
                          const float* const* norms, float* const* outs,
                          const long long* rows, const long long* ns,
                          const float* recips, int count, float levels,
                          void* stream) {
  using namespace repro_torch;
  if (count < 1 || count > kQsgdMaxLeaves) return (int)cudaErrorInvalidValue;
  QsgdTable table{};
  long long total = 0;
  for (int l = 0; l < count; ++l) {
    if (rows[l] < 1 || ns[l] < 1) return (int)cudaErrorInvalidValue;
    const long long tiles = (ns[l] + kQsgdTile - 1) / kQsgdTile;
    const bool vec = ns[l] % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(xs[l]) |
                      reinterpret_cast<uintptr_t>(us[l]) |
                      reinterpret_cast<uintptr_t>(outs[l])) % 16 == 0;
    table.leaf[l] = QsgdLeaf{xs[l], us[l], norms[l], outs[l], ns[l], tiles,
                             total, recips[l], vec};
    total += rows[l] * tiles;
  }
  table.count = count;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  qsgd_kernel<<<(unsigned)total, kQuantThreads, 0, (cudaStream_t)stream>>>(
      table, levels, 1.0f / levels);
  return (int)cudaGetLastError();
}
