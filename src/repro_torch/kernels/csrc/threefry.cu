// Threefry2x32 draws as jax.random makes them, for Hopper (sm_90a).
//
// JAX's default PRNG is Random123's threefry2x32 (20 rounds, rotations
// (13, 15, 26, 6) and (17, 29, 16, 24), key schedule k0 ^ k1 ^ 0x1BD11BDA, a
// key injection every 4 rounds), in its jax_threefry_partitionable form:
// element j of a draw hashes the counter pair (j >> 32, j & 0xffffffff)
// (jax/_src/prng.py, _threefry_split_foldlike and
// _threefry_random_bits_partitionable). One launch draws a table of
// requests; a request is `rows` streams, one a key row of a key tensor in
// device memory (the key is read by the kernel, never passed by value, so a
// captured graph replays with whatever keys an earlier kernel wrote), each
// n elements long, under one transform:
//
//   PAIR     both words on counters (0, counter + i): split and fold_in of a
//            whole level of keys; with has_fold, each key is folded in with
//            `fold` afterwards (a second hash), int64 pairs out.
//   BITS     b1 ^ b2 (jax.random.bits), int64 out.
//   UNIFORM  max(lo, fma(f - 1, hi - lo, lo)), f = bits >> 9 | 1.0f.
//   NORMAL   erfinv of that uniform, times mult, clipped to
//            [clip_lo, clip_hi], times scale (normal and the Langevin noise:
//            mult = fl32(sqrt 2 * scale), as XLA folds the constants inside
//            jit; truncated_normal: mult = sqrt 2, clipped, times the
//            caller's std).
//
// This kernel replaces no pl.pallas_call: the reference draws with XLA's
// jax.random, outside its Pallas kernels. Rounding follows the reference as
// XLA's CPU backend executes it: the uniform's multiply-add is one fma, and
// erfinv is XLA's ErfInv32 (w = -log1p(-x^2); two 9-coefficient polynomials
// split at w = 5, fma Horner steps) over XLA's CPU log1p (a Cephes rational
// form below |z| < sqrt 2 - 1, above it log(1 + z) by XLA's Cephes-style f32
// log, with the multiply-adds its compiled code contracts). Every operation
// is an explicit IEEE intrinsic (__fmaf_rn, __fadd_rn, __fmul_rn,
// __fdiv_rn, __fsqrt_rn), so the result does not depend on nvcc's
// contraction flag; repro_torch/kernels/threefry.py's plain version runs the
// same sequence, and the two are bit-exact.
//
// What bounds it on an H100: operations. A draw writes 4 bytes an element
// (8 for bits, 16 for a key pair) and reads nothing but its key; threefry
// alone is ~72 INT32 operations an element, on 64 INT32 lanes an SM, and
// a normal adds ~100 f32 operations. What the simple design does about it:
// every thread computes its own elements with no memory traffic but the
// store (a CTA takes 1024 consecutive elements of one row, 4 a thread,
// 256 apart, so every store is coalesced), the rotations are single
// funnel shifts, the request's kind is uniform in a CTA, and the grid is
// the tiles of the whole table, so small requests run beside large ones.
#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kDrawThreads = 256;
constexpr int kDrawPerThread = 4;
constexpr int kDrawTile = kDrawThreads * kDrawPerThread;   // 1024 elements
constexpr int kMaxRequests = 40;          // threefry.py: MAX_TABLE_REQUESTS

enum DrawKind : int { kPair = 0, kBits = 1, kUniform = 2, kNormal = 3 };

// Request q: its rows' keys at key[r * key_stride + {0, 1}] (uint32 values
// in int64), its (rows, n) output (rows, n, 2 for PAIR) at out; its tiles
// (tiles a row: ceil(n / kDrawTile)) are the launch's CTAs begin .. begin +
// rows * tiles - 1. A kernel parameter (__grid_constant__).
struct DrawRequest {
  const long long* key;
  void* out;
  const int* counter_at;  // PAIR: a device int added to counter, or null
  long long key_stride, n, tiles, begin;
  unsigned counter, fold;
  int kind, has_fold;
  float lo, hi, mult, clip_lo, clip_hi, scale;
};

struct DrawTable {
  DrawRequest req[kMaxRequests];
  int count;
};
static_assert(sizeof(DrawTable) <= 4096, "the table is a kernel parameter");

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

// log1p as XLA's CPU backend runs it (threefry.py: log1p_plain).
__device__ __forceinline__ float log1p_xla(float z) {
  // |z| >= sqrt 2 - 1: log(1 + z) by XLA's Cephes-style f32 log
  const float a = __fadd_rn(z, 1.0f);
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
  float large = __fmaf_rn(e, bits_f(0x3f318000u), s);
  if (!(a > 0.0f)) large = bits_f(0x7fc00000u);   // a <= 0 or NaN
  if (a == 0.0f) large = bits_f(0xff800000u);     // -inf
  if (a == bits_f(0x7f800000u)) large = a;        // +inf
  // |z| < sqrt 2 - 1: z - z^2/2 + z^3 P(z) / Q(z)
  const float zz = __fmul_rn(z, z);
  float den = __fadd_rn(__fmul_rn(z, 0.0f), 1.0f);
  den = __fmaf_rn(den, z, bits_f(0x417101adu));
  den = __fmaf_rn(den, z, bits_f(0x42a6185bu));
  den = __fmaf_rn(den, z, bits_f(0x435dc32du));
  den = __fmaf_rn(den, z, bits_f(0x439a8ca3u));
  den = __fmaf_rn(den, z, bits_f(0x43586d8au));
  den = __fmaf_rn(den, z, bits_f(0x42707982u));
  float num = __fadd_rn(__fmul_rn(z, 0.0f), bits_f(0x383de04bu));
  num = __fmaf_rn(num, z, bits_f(0x3eff40c5u));
  num = __fmaf_rn(num, z, bits_f(0x40d284fau));
  num = __fmaf_rn(num, z, bits_f(0x41ef4b9cu));
  num = __fmaf_rn(num, z, bits_f(0x4273cc76u));
  num = __fmaf_rn(num, z, bits_f(0x426473adu));
  num = __fmaf_rn(num, z, bits_f(0x41a05101u));
  const float small = __fadd_rn(
      z, __fmaf_rn(-0.5f, zz,
                   __fmul_rn(__fmul_rn(z, zz), __fdiv_rn(num, den))));
  return fabsf(z) < bits_f(0x3ed413cdu) ? small : large;
}

// XLA's ErfInv32 (threefry.py: erfinv_plain).
__device__ __forceinline__ float erfinv_xla(float x) {
  constexpr uint32_t kLt5[9] = {0x32f16588u, 0x34b84b36u, 0xb66c7357u,
                                0xb6935ac1u, 0x396532dbu, 0xbaa45408u,
                                0xbb88e4efu, 0x3e7c8f63u, 0x3fc02e2fu};
  constexpr uint32_t kGe5[9] = {0xb951f09bu, 0x38d3b56bu, 0x3ab0dc72u,
                                0xbb70bde7u, 0x3bbc127bu, 0xbbf9c5d7u,
                                0x3c1aa57eu, 0x3f8036dbu, 0x40354f7eu};
  const float lg = log1p_xla(__fmul_rn(x, -x));
  const bool lt = lg > -5.0f;                            // w < 5
  const float w = lt ? __fsub_rn(-2.5f, lg)
                     : __fadd_rn(__fsqrt_rn(-lg), -3.0f);
  float p = bits_f(lt ? kLt5[0] : kGe5[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(w, p, bits_f(lt ? kLt5[i] : kGe5[i]));
  if (fabsf(x) == 1.0f) p = bits_f(0x7f800000u);   // +inf
  return __fmul_rn(x, p);
}

__device__ __forceinline__ float uniform_of(uint32_t b, float lo, float hi) {
  const float f = __uint_as_float((b >> 9) | 0x3F800000u);
  return fmaxf(__fmaf_rn(__fadd_rn(f, -1.0f), __fsub_rn(hi, lo), lo), lo);
}

// ------------------------------------------------------------------ kernel

__global__ void __launch_bounds__(kDrawThreads)
threefry_kernel(const __grid_constant__ DrawTable table) {
  const long long tile = blockIdx.x;
  int q = 0;
  while (q + 1 < table.count && tile >= table.req[q + 1].begin) ++q;
  const DrawRequest& rq = table.req[q];
  const long long local = tile - rq.begin;
  const long long row = local / rq.tiles;
  const long long col = (local - row * rq.tiles) * kDrawTile;
  const long long* kp = rq.key + row * rq.key_stride;
  const uint32_t k0 = (uint32_t)kp[0], k1 = (uint32_t)kp[1];
  const long long n = rq.n;
  const long long base = row * n;
#pragma unroll
  for (int j = 0; j < kDrawPerThread; ++j) {
    const long long i = col + threadIdx.x + j * kDrawThreads;
    if (i >= n) break;
    if (rq.kind == kPair) {
      const uint32_t c0 = rq.counter +
          (rq.counter_at ? (uint32_t)__ldg(rq.counter_at) : 0u);
      uint2 y = threefry2x32(k0, k1, 0u, c0 + (uint32_t)i);
      if (rq.has_fold) y = threefry2x32(y.x, y.y, 0u, rq.fold);
      reinterpret_cast<longlong2*>(rq.out)[base + i] =
          make_longlong2((long long)y.x, (long long)y.y);
      continue;
    }
    const uint2 y = threefry2x32(k0, k1, (uint32_t)(i >> 32), (uint32_t)i);
    const uint32_t b = y.x ^ y.y;
    if (rq.kind == kBits) {
      static_cast<long long*>(rq.out)[base + i] = (long long)b;
    } else if (rq.kind == kUniform) {
      static_cast<float*>(rq.out)[base + i] = uniform_of(b, rq.lo, rq.hi);
    } else {
      const float v = __fmul_rn(erfinv_xla(uniform_of(b, rq.lo, rq.hi)),
                                rq.mult);
      static_cast<float*>(rq.out)[base + i] =
          __fmul_rn(fminf(fmaxf(v, rq.clip_lo), rq.clip_hi), rq.scale);
    }
  }
}

}  // namespace repro_torch

// One launch draws `count` <= kMaxRequests requests. Request q: rows[q]
// keys at keys[q] (row stride key_strides[q] int64s), ns[q] elements a row
// into outs[q], transform kinds[q], first counter counters[q] plus, where
// counter_ats[q] is not null, the int it points to on the device (PAIR: a
// round index that a CUDA graph reads at replay, wrapping mod 2^32), second
// counter folds[q] (PAIR; -1 for none), and params[6q .. 6q + 5] = lo, hi,
// mult, clip_lo, clip_hi, scale (UNIFORM reads the first two). Counters and
// folds are uint32; every request has rows >= 1 and n >= 1.
extern "C" int repro_threefry(const long long* const* keys,
                              const long long* key_strides,
                              const long long* rows, void* const* outs,
                              const long long* ns, const int* kinds,
                              const long long* counters,
                              const int* const* counter_ats,
                              const long long* folds, const float* params,
                              int count, void* stream) {
  using namespace repro_torch;
  if (count < 1 || count > kMaxRequests) return (int)cudaErrorInvalidValue;
  DrawTable table{};
  long long total = 0;
  for (int q = 0; q < count; ++q) {
    if (rows[q] < 1 || ns[q] < 1 || kinds[q] < kPair || kinds[q] > kNormal ||
        counters[q] < 0 || counters[q] + ns[q] > 0x100000000LL ||
        folds[q] > 0xffffffffLL)
      return (int)cudaErrorInvalidValue;
    const long long tiles = (ns[q] + kDrawTile - 1) / kDrawTile;
    const float* p = params + 6 * q;
    table.req[q] = DrawRequest{keys[q], outs[q], counter_ats[q],
                               key_strides[q], ns[q], tiles,
                               total, (unsigned)counters[q],
                               folds[q] < 0 ? 0u : (unsigned)folds[q],
                               kinds[q], folds[q] >= 0 ? 1 : 0,
                               p[0], p[1], p[2], p[3], p[4], p[5]};
    total += rows[q] * tiles;
  }
  table.count = count;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  threefry_kernel<<<(unsigned)total, kDrawThreads, 0,
                    (cudaStream_t)stream>>>(table);
  return (int)cudaGetLastError();
}
