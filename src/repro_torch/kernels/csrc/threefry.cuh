// Threefry2x32 and the f32 arithmetic of XLA's CPU backend that the draw
// and decode kernels share (threefry.cu, bma_sample.cu,
// decode_attention.cu): the hash, the uniform of 32 bits, XLA's log and
// exp and the Gumbel noise of jax.random.gumbel. Every
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
  // the exponent as a float through the magic number (no conversion unit)
  float e = __fadd_rn(__fadd_rn(__int_as_float(0x4B400000 + (cb >> 23) - 127),
                                -12582912.0f),
                      1.0f);
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

// exp as XLA's CPU backend runs it (threefry.py: exp_plain; bit-exact
// against jax.jit(jnp.exp) and the exp of jax.nn.softmax): x clamped to
// [-87.8, 88.8]; n = floor(fma(x, log2 e, 0.5)) clamped to +-127; r = x -
// n C1 - n C2 as two fmas; p = 1 + fma(P(r), r^2, r), P a Horner chain of
// fmas; p 2^n. XLA's code runs with denormals flushed, so a result below
// the smallest normal (n = -127, or n = -126 and p < 1) is +0.
//
// floor and the int conversion go through the magic number 1.5 * 2^23
// (exact below 2^22 in magnitude) instead of the conversion unit, which
// runs at a quarter of the f32 rate.
__device__ __forceinline__ float exp_xla(float x) {
  const float c = fminf(fmaxf(x, bits_f(0xc2af999au)), bits_f(0x42b1999au));
  const float t = __fmaf_rn(c, bits_f(0x3fb8aa3bu), 0.5f);   // |t| < 129
  const float rn = __fadd_rn(__fadd_rn(t, 12582912.0f), -12582912.0f);
  const float n = fminf(fmaxf(rn > t ? __fadd_rn(rn, -1.0f) : rn, -127.0f),
                        127.0f);                              // floor, clamped
  float r = __fmaf_rn(-n, bits_f(0x3f318000u), c);
  r = __fmaf_rn(-n, bits_f(0xb95e8083u), r);
  float y = __fmaf_rn(r, bits_f(0x39506967u), bits_f(0x3ab743ceu));
  y = __fmaf_rn(y, r, bits_f(0x3c088908u));
  y = __fmaf_rn(y, r, bits_f(0x3d2aa9c1u));
  y = __fmaf_rn(y, r, bits_f(0x3e2aaaaau));
  y = __fmaf_rn(y, r, 0.5f);
  const float p = __fadd_rn(__fmaf_rn(y, __fmul_rn(r, r), r), 1.0f);
  const int ni = __float_as_int(__fadd_rn(n, 12582912.0f)) - 0x4B400000;
  float out = __fmul_rn(p, __int_as_float((ni + 127) << 23));
  out = (ni < -126 || (ni == -126 && p < 1.0f)) ? 0.0f : out;
  return x != x ? x : out;                    // a NaN passes through
}

// a / b correctly rounded for b in [1, 2^18], given y = RN(1 / b)
// (__frcp_rn): Markstein's correction of RN(a y) by the exact residual
// RN(a - b q) (one fma). It is RN(a / b) wherever |a| >= 2^-100 (checked
// against the correctly rounded quotient on 8e7 pairs, hard divisors
// included); elsewhere (a tiny, infinite or NaN; 0 is exact) it sets
// *slow, and the caller takes __fdiv_rn.
__device__ __forceinline__ float div_rn(float a, float b, float y,
                                        bool& slow) {
  const float q = __fmul_rn(a, y);
  const float r = __fmaf_rn(-q, b, a);
  slow |= a != 0.0f && !(fabsf(a) >= bits_f(0x0d800000u) &&   // 2^-100
                         fabsf(a) <= bits_f(0x7f7fffffu));
  return __fmaf_rn(r, y, q);
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
