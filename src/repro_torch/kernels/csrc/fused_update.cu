// Fused CD-BFL consensus + Langevin update (paper Eq. 9) for Hopper (sm_90a):
//
//     θ' = θ + ζ·(v̄ − v) + s·ξ
//
// Replaces fused_update_pallas (pl.pallas_call at
// src/repro/kernels/fused_update.py:43, body _fused_update_kernel at :27-33).
// The CD-BFL round calls it with ξ the Langevin noise already scaled by
// √(2ηT) and s = 1, which is the reference round's Eq. 9 tree_map
// (src/repro/core/algorithms.py:415-422).
//
// Rounding: the reference's executable form, XLA on the CPU, contracts the
// expression into fma(ζ, v̄ − v, θ) + s·ξ (the add of s·ξ contracts into a
// second fma when s != 1). The kernel spells that out with __fsub_rn and
// __fmaf_rn, so its result is bit-exact to the reference whatever nvcc's
// contraction flag says (the build passes --fmad=false anyway).
//
// What bounds it on an H100: bytes. Four f32 reads and one f32 write per
// element at 3.35 TB/s; 3 flops an element are nothing beside them.
// What the simple design does about that: a grid-stride loop that moves
// 16 bytes a thread per stream (float4) when every pointer is 16-byte
// aligned, with a scalar loop for the tail and for unaligned pointers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxCtas = 132 * 16;

__device__ __forceinline__ float eq9(float th, float vb, float v, float xi,
                                     float zeta, float s) {
  return __fmaf_rn(s, xi, __fmaf_rn(zeta, __fsub_rn(vb, v), th));
}

__global__ void __launch_bounds__(kThreads)
fused_update_vec4(const float4* __restrict__ th, const float4* __restrict__ vb,
                  const float4* __restrict__ v, const float4* __restrict__ xi,
                  float4* __restrict__ out, long long n4, float zeta,
                  float s) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 a = th[i], b = vb[i], c = v[i], d = xi[i];
    float4 r;
    r.x = eq9(a.x, b.x, c.x, d.x, zeta, s);
    r.y = eq9(a.y, b.y, c.y, d.y, zeta, s);
    r.z = eq9(a.z, b.z, c.z, d.z, zeta, s);
    r.w = eq9(a.w, b.w, c.w, d.w, zeta, s);
    out[i] = r;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_update_scalar(const float* __restrict__ th, const float* __restrict__ vb,
                    const float* __restrict__ v, const float* __restrict__ xi,
                    float* __restrict__ out, long long begin, long long n,
                    float zeta, float s) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = begin + (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n; i += stride)
    out[i] = eq9(th[i], vb[i], v[i], xi[i], zeta, s);
}

inline unsigned ctas_for(long long work) {
  long long c = (work + kThreads - 1) / kThreads;
  return (unsigned)(c < kMaxCtas ? c : kMaxCtas);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int repro_fused_update(const float* th, const float* vb,
                                  const float* v, const float* xi, float* out,
                                  long long n, float zeta, float s,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long done = 0;
  if (aligned16(th) && aligned16(vb) && aligned16(v) && aligned16(xi) &&
      aligned16(out)) {
    const long long n4 = n / 4;
    if (n4 > 0)
      fused_update_vec4<<<ctas_for(n4), kThreads, 0, st>>>(
          reinterpret_cast<const float4*>(th),
          reinterpret_cast<const float4*>(vb),
          reinterpret_cast<const float4*>(v),
          reinterpret_cast<const float4*>(xi), reinterpret_cast<float4*>(out),
          n4, zeta, s);
    done = 4 * n4;
  }
  if (done < n)
    fused_update_scalar<<<ctas_for(n - done), kThreads, 0, st>>>(
        th, vb, v, xi, out, done, n, zeta, s);
  return (int)cudaGetLastError();
}
