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
// With control variates stored in bfloat16 (FedConfig.control_dtype, ROADMAP
// A3), kCdbfl and kCffl have a second form, control_update_bf16: it takes
// the round's f32 deltas (Δv of Eq. 7, the mixed Δv̄ of Eq. 8) beside the
// stored bf16 v and v̄, and computes Eqs. 7–9 as the reference's jitted
// round executes them on the CPU (ROADMAP C23): Δ rounded to bf16, the sums
// v + Δv and v̄ + Δv̄ taken in f32, Eq. 9 read from those f32 sums (XLA
// drops the bf16 rounding between Eq. 8 and Eq. 9 under its default
// excess precision), and the sums stored rounded to bf16 as the new v and
// v̄. The bf16 operands are widened in registers (exact); no f32 copy of a
// control tree is written.
//
// What bounds it on an H100: bytes. Four f32 reads and one f32 write per
// element at 3.35 TB/s (three and one for the variants); 3 flops an element
// are nothing beside them.
// What the simple design does about that: a grid-stride loop that moves
// 16 bytes a thread per stream (float4) when every pointer is 16-byte
// aligned, with a scalar loop for the tail and for unaligned pointers.
#include <cstdint>
#include <cuda_bf16.h>
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

// bf16 <-> f32: the widening is exact; the narrowing rounds to nearest
// even (cvt.rn.bf16.f32), as torch's .to(torch.bfloat16) on the card
__device__ __forceinline__ float widen(__nv_bfloat16 a) {
  return __bfloat162float(a);
}
__device__ __forceinline__ __nv_bfloat16 narrow(float a) {
  return __float2bfloat16_rn(a);
}

// Eqs. 7–9 of one element with v, v̄ stored in bf16 (V kCdbfl or kCffl):
// returns θ', writes the new v and v̄
template <int V>
__device__ __forceinline__ float control_update(
    float th, __nv_bfloat16 vb, __nv_bfloat16 v, float dvb, float dv,
    float xi, float p, float q, __nv_bfloat16& vb_out,
    __nv_bfloat16& v_out) {
  const float svb = __fadd_rn(widen(vb), widen(narrow(dvb)));
  const float sv = __fadd_rn(widen(v), widen(narrow(dv)));
  vb_out = narrow(svb);
  v_out = narrow(sv);
  return update<V>(th, svb, sv, xi, p, q);
}

// four bf16 elements in one 8-byte access
struct alignas(8) bf16x4 {
  __nv_bfloat16 x, y, z, w;
};

template <int V>
__global__ void __launch_bounds__(kThreads)
control_update_bf16_vec4(const float4* __restrict__ th,
                         const bf16x4* __restrict__ vb,
                         const bf16x4* __restrict__ v,
                         const float4* __restrict__ dvb,
                         const float4* __restrict__ dv,
                         const float4* __restrict__ xi,
                         float4* __restrict__ out, bf16x4* __restrict__ vb_out,
                         bf16x4* __restrict__ v_out, long long n4, float p,
                         float q) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 t = th[i], mb = dvb[i], m = dv[i];
    const bf16x4 b = vb[i], c = v[i];
    const float4 w = V == kCdbfl ? xi[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 r;
    bf16x4 ob, oc;
    r.x = control_update<V>(t.x, b.x, c.x, mb.x, m.x, w.x, p, q, ob.x, oc.x);
    r.y = control_update<V>(t.y, b.y, c.y, mb.y, m.y, w.y, p, q, ob.y, oc.y);
    r.z = control_update<V>(t.z, b.z, c.z, mb.z, m.z, w.z, p, q, ob.z, oc.z);
    r.w = control_update<V>(t.w, b.w, c.w, mb.w, m.w, w.w, p, q, ob.w, oc.w);
    out[i] = r;
    vb_out[i] = ob;
    v_out[i] = oc;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
control_update_bf16_scalar(const float* __restrict__ th,
                           const __nv_bfloat16* __restrict__ vb,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ dvb,
                           const float* __restrict__ dv,
                           const float* __restrict__ xi,
                           float* __restrict__ out,
                           __nv_bfloat16* __restrict__ vb_out,
                           __nv_bfloat16* __restrict__ v_out, long long begin,
                           long long n, float p, float q) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = begin + (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n; i += stride)
    out[i] = control_update<V>(th[i], vb[i], v[i], dvb[i], dv[i],
                               V == kCdbfl ? xi[i] : 0.0f, p, q, vb_out[i],
                               v_out[i]);
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

inline bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7u) == 0;
}

// the bf16 form of V over n elements: four elements a thread (float4 and
// 8-byte bf16 accesses) when the f32 pointers are 16-byte and the bf16
// ones 8-byte aligned, a scalar launch for the tail and unaligned pointers
// (xi is null but for kCdbfl)
template <int V>
int launch_control_bf16(const float* th, const __nv_bfloat16* vb,
                        const __nv_bfloat16* v, const float* dvb,
                        const float* dv, const float* xi, float* out,
                        __nv_bfloat16* vb_out, __nv_bfloat16* v_out,
                        long long n, float p, float q, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long done = 0;
  if (aligned16(th) && aligned16(dvb) && aligned16(dv) &&
      (V != kCdbfl || aligned16(xi)) && aligned16(out) && aligned8(vb) &&
      aligned8(v) && aligned8(vb_out) && aligned8(v_out)) {
    const long long n4 = n / 4;
    if (n4 > 0)
      control_update_bf16_vec4<V><<<ctas_for(n4), kThreads, 0, st>>>(
          reinterpret_cast<const float4*>(th),
          reinterpret_cast<const bf16x4*>(vb),
          reinterpret_cast<const bf16x4*>(v),
          reinterpret_cast<const float4*>(dvb),
          reinterpret_cast<const float4*>(dv),
          reinterpret_cast<const float4*>(xi), reinterpret_cast<float4*>(out),
          reinterpret_cast<bf16x4*>(vb_out), reinterpret_cast<bf16x4*>(v_out),
          n4, p, q);
    done = 4 * n4;
  }
  if (done < n)
    control_update_bf16_scalar<V><<<ctas_for(n - done), kThreads, 0, st>>>(
        th, vb, v, dvb, dv, xi, out, vb_out, v_out, done, n, p, q);
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

// CD-BFL's Eqs. 7–9 with v, v̄ in bf16: out = fma(s, ξ, fma(ζ, S̄ − S, θ)),
// S = v + bf16(Δv) and S̄ = v̄ + bf16(Δv̄) in f32; v_out = bf16(S),
// vb_out = bf16(S̄)
extern "C" int repro_fused_update_bf16(
    const float* th, const __nv_bfloat16* vb, const __nv_bfloat16* v,
    const float* dvb, const float* dv, const float* xi, float* out,
    __nv_bfloat16* vb_out, __nv_bfloat16* v_out, long long n, float zeta,
    float s, void* stream) {
  return launch_control_bf16<kCdbfl>(th, vb, v, dvb, dv, xi, out, vb_out,
                                     v_out, n, zeta, s, stream);
}

// CF-FL's with v, v̄ in bf16: out = fma(ζ, S̄ − S, θ)
extern "C" int repro_cffl_update_bf16(
    const float* th, const __nv_bfloat16* vb, const __nv_bfloat16* v,
    const float* dvb, const float* dv, float* out, __nv_bfloat16* vb_out,
    __nv_bfloat16* v_out, long long n, float zeta, void* stream) {
  return launch_control_bf16<kCffl>(th, vb, v, dvb, dv, nullptr, out, vb_out,
                                    v_out, n, zeta, 0.0f, stream);
}
