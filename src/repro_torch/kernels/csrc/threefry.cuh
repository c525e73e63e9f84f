// Threefry2x32 and the f32 arithmetic of XLA's CPU backend that the draw
// kernels share (threefry.cu, bma_sample.cu): the hash, the uniform of 32
// bits, XLA's log and the Gumbel noise of jax.random.gumbel. Every
// operation is an explicit IEEE intrinsic, so nvcc's contraction flag does
// not change a bit; repro_torch/kernels/threefry.py spells out the same
// sequences as the plain versions.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

// ---------------------------------------------------------------- threefry

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R);       // rotate left by R
  x1 ^= x0;
}

template <int A, int B, int C, int D>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  mix<A>(x0, x1);
  mix<B>(x0, x1);
  mix<C>(x0, x1);
  mix<D>(x0, x1);
}

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// ------------------------------------------------- XLA's CPU f32 arithmetic

__device__ __forceinline__ float bits_f(uint32_t b) {
  return __uint_as_float(b);
}

// log as XLA's CPU backend runs it: its Cephes-style f32 log, every
// multiply-add contracted as XLA's compiled code contracts it, a subnormal
// input read as zero (threefry.py: log_plain; bit-exact against
// jax.jit(jnp.log)).
__device__ __forceinline__ float log_xla(float a) {
  const float c = a > bits_f(0x00800000u) ? a : bits_f(0x00800000u);
  const int cb = __float_as_int(c);
  float e = __fadd_rn(__int2float_rn((cb >> 23) - 127), 1.0f);
  const float m = __int_as_float((cb & 0x7FFFFF) | 0x3F000000);
  const bool below = m < bits_f(0x3f3504f3u);            // sqrt(1/2)
  const float t = __fadd_rn(__fadd_rn(m, -1.0f), below ? m : 0.0f);
  if (below) e = __fsub_rn(e, 1.0f);
  const float t2 = __fmul_rn(t, t);
  const float t3 = __fmul_rn(t2, t);
  const float y0 = __fmaf_rn(__fmaf_rn(t, bits_f(0x3d9021bbu),
                                       bits_f(0xbdebd1b8u)),
                             t, bits_f(0x3def251au));
  const float y1 = __fmaf_rn(__fmaf_rn(t, bits_f(0xbdfe5d4fu),
                                       bits_f(0x3e11e9bfu)),
                             t, bits_f(0xbe2aae50u));
  const float y2 = __fmaf_rn(__fmaf_rn(t, bits_f(0x3e4cceacu),
                                       bits_f(0xbe7ffffcu)),
                             t, bits_f(0x3eaaaaaau));
  const float r = __fmaf_rn(t3, __fmaf_rn(t3, y0, y1), y2);
  const float s = __fadd_rn(__fmaf_rn(t3, r, __fmul_rn(e, bits_f(0xb95e8083u))),
                            __fmaf_rn(-0.5f, t2, t));
  float out = __fmaf_rn(e, bits_f(0x3f318000u), s);
  if (!(a > 0.0f)) out = bits_f(0x7fc00000u);     // a <= 0 or NaN
  if (fabsf(a) < bits_f(0x00800000u)) out = bits_f(0xff800000u);  // -inf
  if (a == bits_f(0x7f800000u)) out = a;          // +inf
  return out;
}

__device__ __forceinline__ float uniform_of(uint32_t b, float lo, float hi) {
  const float f = __uint_as_float((b >> 9) | 0x3F800000u);
  return fmaxf(__fmaf_rn(__fadd_rn(f, -1.0f), __fsub_rn(hi, lo), lo), lo);
}

// jax.random.gumbel's "low" mode from 32 random bits:
// -log(-log(u)), u uniform in [lo, hi) = [tiny, 1) (threefry.py:
// gumbel_plain).
__device__ __forceinline__ float gumbel_of(uint32_t b, float lo, float hi) {
  return -log_xla(-log_xla(uniform_of(b, lo, hi)));
}

}  // namespace repro_torch
