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
// Two variants are template instances of the same kernel, each the
// reference's update of a baseline round as XLA's CPU code contracts it
// (ROADMAP C10), with no pl.pallas_call behind them (the reference computes
// them as jnp tree_maps inside its jitted rounds):
//   kCffl  — CF-FL's θ + ζ·(v̄ − v), no noise operand
//            (src/repro/core/algorithms.py:602-608): fma(ζ, v̄ − v, θ);
//   kDsgld — DSGLD's m − η·g + ξ (:515-520), m the mixed θ, g the gradient,
//            ξ the scaled noise: fma(−η, g, m) + ξ; the SGLD step (:662-668)
//            is the same expression.
//
// What bounds it on an H100: bytes. Four f32 reads and one f32 write per
// element at 3.35 TB/s (three and one for the variants); 3 flops an element
// are nothing beside them.
// What the simple design does about that: a grid-stride loop that moves
// 16 bytes a thread per stream (float4) when every pointer is 16-byte
// aligned, with a scalar loop for the tail and for unaligned pointers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxCtas = 132 * 16;

// the update's variants; the kernels' operands a, b, c, d and scalars p, q
constexpr int kCdbfl = 0;   // a θ, b v̄, c v, d ξ; p ζ, q s
constexpr int kCffl = 1;    // a θ, b v̄, c v; p ζ
constexpr int kDsgld = 2;   // a m, b g, c ξ; p η

template <int V>
__device__ __forceinline__ float update(float a, float b, float c, float d,
                                        float p, float q) {
  if (V == kCdbfl) return __fmaf_rn(q, d, __fmaf_rn(p, __fsub_rn(b, c), a));
  if (V == kCffl) return __fmaf_rn(p, __fsub_rn(b, c), a);
  return __fadd_rn(__fmaf_rn(-p, b, a), c);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
fused_update_vec4(const float4* __restrict__ a, const float4* __restrict__ b,
                  const float4* __restrict__ c, const float4* __restrict__ d,
                  float4* __restrict__ out, long long n4, float p, float q) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 x = a[i], y = b[i], z = c[i];
    const float4 w = V == kCdbfl ? d[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 r;
    r.x = update<V>(x.x, y.x, z.x, w.x, p, q);
    r.y = update<V>(x.y, y.y, z.y, w.y, p, q);
    r.z = update<V>(x.z, y.z, z.z, w.z, p, q);
    r.w = update<V>(x.w, y.w, z.w, w.w, p, q);
    out[i] = r;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
fused_update_scalar(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ c, const float* __restrict__ d,
                    float* __restrict__ out, long long begin, long long n,
                    float p, float q) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = begin + (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n; i += stride)
    out[i] = update<V>(a[i], b[i], c[i], V == kCdbfl ? d[i] : 0.0f, p, q);
}

inline unsigned ctas_for(long long work) {
  long long c = (work + kThreads - 1) / kThreads;
  return (unsigned)(c < kMaxCtas ? c : kMaxCtas);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// the variant V over n elements: float4 accesses when every pointer is
// 16-byte aligned, a scalar launch for the tail and unaligned pointers
// (d is null but for kCdbfl)
template <int V>
int launch_update(const float* a, const float* b, const float* c,
                  const float* d, float* out, long long n, float p, float q,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long done = 0;
  if (aligned16(a) && aligned16(b) && aligned16(c) &&
      (V != kCdbfl || aligned16(d)) && aligned16(out)) {
    const long long n4 = n / 4;
    if (n4 > 0)
      fused_update_vec4<V><<<ctas_for(n4), kThreads, 0, st>>>(
          reinterpret_cast<const float4*>(a),
          reinterpret_cast<const float4*>(b),
          reinterpret_cast<const float4*>(c),
          reinterpret_cast<const float4*>(d), reinterpret_cast<float4*>(out),
          n4, p, q);
    done = 4 * n4;
  }
  if (done < n)
    fused_update_scalar<V><<<ctas_for(n - done), kThreads, 0, st>>>(
        a, b, c, d, out, done, n, p, q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_fused_update(const float* th, const float* vb,
                                  const float* v, const float* xi, float* out,
                                  long long n, float zeta, float s,
                                  void* stream) {
  return launch_update<kCdbfl>(th, vb, v, xi, out, n, zeta, s, stream);
}

// CF-FL: out = fma(ζ, v̄ − v, θ)
extern "C" int repro_cffl_update(const float* th, const float* vb,
                                 const float* v, float* out, long long n,
                                 float zeta, void* stream) {
  return launch_update<kCffl>(th, vb, v, nullptr, out, n, zeta, 0.0f, stream);
}

// DSGLD (and the SGLD step): out = fma(−η, g, m) + ξ
extern "C" int repro_dsgld_update(const float* m, const float* g,
                                  const float* xi, float* out, long long n,
                                  float eta, void* stream) {
  return launch_update<kDsgld>(m, g, xi, nullptr, out, n, eta, 0.0f, stream);
}
