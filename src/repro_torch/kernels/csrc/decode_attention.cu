// One decode step of grouped-query attention over every lane's KV cache,
// for Hopper (sm_90a).
//
// The reference's decode attention (repro/models/attention.py:120-142) is
// jnp on XLA, vmapped over the (sample, slot) lanes of its decode engine; no
// pl.pallas_call. For each lane (one cache of `slots` rows, its own
// position p) and each KV head, one CTA:
//
//   1. writes the lane's post-RoPE key and value row into slot
//      min(p, slots - 1), or p mod slots in a ring buffer (window > 0), in
//      the cache dtype, and sets slot_pos[slot] = p (the KV-head-0 CTA);
//   2. scores each row t against the group's r = heads / kv_heads query
//      heads: the dot product of q and the row cast to the compute dtype,
//      rounded to it, then divided by sqrt(head_dim) in it;
//   3. masks rows whose slot_pos is < 0, > p or, in a ring buffer, <= p -
//      window to -1e30 in the compute dtype;
//   4. takes the f32 softmax over the rows with XLA's exp (threefry.cuh:
//      exp_xla) and rounds the probabilities to the compute dtype;
//   5. sums the probability-weighted value rows in f32 and rounds to the
//      compute dtype.
//
// That is the reference's rounding order; no online-softmax rescaling. All
// arithmetic is f32, every operation an explicit IEEE intrinsic. The
// summation order, which the plain version (decode_attention.py:
// decode_attention_plain) follows op for op so that the two agree bit for
// bit: a row of head_dim elements is cut into TPR segments of 16 bytes of
// the cache dtype (E = 8 bfloat16 or 4 f32 elements; TPR = head_dim / E
// threads a row), and the CTA's 256 threads into RPP = 256 / TPR row
// groups, thread (g, c) = (tid / TPR, tid % TPR) taking rows g, g + RPP,
// g + 2 RPP, ... at segment c.
//
//   score: a thread's segment as an fma chain over its E elements in
//     order from +0, then a halving tree over the row's TPR threads (the
//     sum of segments c and c + TPR/2 first, by shuffles xor TPR/2, ..., 1);
//   softmax: each head's max (order-free), then thread tid's terms
//     exp_xla(s_t - max) for t = tid, tid + 256, ... added in order from +0,
//     a halving tree over the warp's 32 lanes (xor 16, ..., 1), then the 8
//     warps' sums added in index order from +0; p_t = round(e_t / sum);
//   P.V: thread (g, c) sums p_t v_t[c E + e] over its rows in order, an fma
//     chain from +0; then a halving tree over the warp's 32 / TPR row
//     groups (shuffles xor 16, ..., TPR), then the 8 warps' sums added in
//     index order from +0 through shared memory.
//
// Design: one CTA of 8 warps a (lane, KV head). Before any arithmetic each
// thread copies the K and V rows it takes (up to row_tile<TPR> of each, 16
// bytes a row) into shared memory with cp.async, two groups, so the CTA
// waits about one memory latency for K and none for V; it reads back only
// the rows it copied. The group's query heads are staged as f32 and padded
// to chunks of kHeadChunk, and each K row is dotted with a chunk's heads
// at once: four independent fma chains and shuffle trees a row, no branch
// between them. Each head's max is taken with the scores (a thread's rows,
// then a warp); the softmax's exps and divisions run on all threads, a
// chunk's heads at once; the division is Markstein's correction of a
// product by the reciprocal (threefry.cuh: div_rn), correctly rounded. A
// cache value is converted only where the cache (f32) is wider than the
// compute dtype (bf16). What bounds it: the lanes' K and V bytes, about
// 3.3 MB a layer at 32 lanes of smollm-135m, so about 1 us; at that size
// the launch and one memory latency dominate. Its first form, a thread a
// (head, row) pair summing exact products in float64 over rows staged as
// doubles, took 0.0155 ms a layer at 32 lanes; phase timings with clock64
// (chip_smoke.py's card, an NVIDIA H100 80GB HBM3 at 700 W) showed a
// phase per head, each a chain of dependent shared-memory loads,
// shuffles and conversions, which this form interleaves.
//
// The split form (decode_attention_split_kernel) takes what one CTA cannot
// hold: recurrentgemma-9b's local-attention ring of 2,048 slots with 16
// query heads of 256 over one KV head (the scores alone are 128 KB a head
// group, the P.V partials of 8 warps 128 KB more), and f32 rows of 256,
// 64 segments of 16 bytes, which a thread takes two at a time (E = 8 f32
// elements a thread, so a row still spans one warp). One (lane, KV head)
// is a thread block cluster of NC CTAs (a power of two, at most 16); CTA
// q owns the slots [q TS, (q + 1) TS), TS = ceil(slots / NC), and runs the
// one-CTA form's arithmetic over them with its own thread mapping (local
// row t - q TS). What crosses the cluster goes through distributed shared
// memory, in rank order:
//
//   the maximum: each CTA's maximum of each head, the cluster's the
//     maximum of those (order-free);
//   the softmax's sum: each CTA's sum in the one-CTA order over its own
//     rows (from +0), then the cluster's: CTA 0's sum plus CTA 1's, and so
//     on in rank order;
//   P.V: each CTA's sums in the one-CTA order over its rows (from +0),
//     then CTA 0's plus CTA 1's, ... in rank order, then rounded to the
//     compute dtype; CTA q adds and writes the q-th slice of the outputs.
//
// With NC = 1 that is the one-CTA form's order exactly. Each thread
// copies its K rows (and, where shared memory holds both, its V rows) to
// shared memory with cp.async before any arithmetic, so a CTA waits about
// one memory latency; then, four query heads at a time held in registers
// (laid out in shared memory so that a warp's reads of one element fall
// in distinct banks), it dots each of its staged K rows with them; f32
// rows stage V into K's place once the scores are done. A CTA holds 128
// slots' rows (64 KB of bf16 K, as much V) beside 72 KB of queries,
// scores and partial sums, one CTA an SM. What bounds it: the lanes' K
// and V bytes, 33.5 MB a layer at 16 lanes of recurrentgemma-9b in bf16,
// 0.0100 ms at 3.35 TB/s. Timed in a CUDA graph of 20 launches (an NVIDIA
// H100 80GB HBM3 at 700 W): 0.163 ms at 16 lanes (SDPA 0.029); a single
// CTA of 128 f32 slots 0.050 ms at 16 heads and 0.018 at 1. Rows outer
// and heads inner took 0.175; all 16 heads at once 0.194; the queries in
// row order (8-way bank conflicts) 0.285 (events around 20 eager
// launches). What holds a CTA there is not measured apart (no ncu).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {

constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kMaxGroup = 16;        // decode_attention.py: MAX_GROUP
constexpr int kHeadChunk = 4;        // query heads a thread holds

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T, as an f32 value
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// max that propagates NaN, as jnp.max and torch.amax do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// the n values of T packed in 32-bit words, as f32
__device__ __forceinline__ void unpack(const uint32_t* w, float* f, int n,
                                       float) {
  for (int k = 0; k < n; ++k) f[k] = __uint_as_float(w[k]);
}
__device__ __forceinline__ void unpack(const uint32_t* w, float* f, int n,
                                       __nv_bfloat16) {
  for (int k = 0; k < n / 2; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// E values of T at p (E * sizeof(T) a multiple of 8 bytes, p so aligned)
template <typename T, int E>
__device__ __forceinline__ void load_f32(const T* p, float (&f)[E]) {
  constexpr int kWords = E * (int)sizeof(T) / 4;
  uint32_t w[kWords];
  const uint2* src = reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int k = 0; k < kWords / 2; ++k) {
    const uint2 u = src[k];
    w[2 * k] = u.x;
    w[2 * k + 1] = u.y;
  }
  unpack(w, f, E, T());
}

// 16 bytes of the cache dtype C from E f32 values, each rounded to C
template <typename C, int E>
__device__ __forceinline__ uint4 pack16(const float (&f)[E]) {
  uint32_t w[4];
  if constexpr (sizeof(C) == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __float_as_uint(f[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k])) |
             ((uint32_t)__bfloat16_as_ushort(
                  __float2bfloat16_rn(f[2 * k + 1])) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct DecodeArgs {
  const void* q;          // (lanes, heads, hd) compute dtype
  const void* k_new;      // (lanes, kv, hd) compute dtype
  const void* v_new;
  void* k_cache;          // (lanes, slots, kv, hd) cache dtype
  void* v_cache;
  int* slot_pos;          // (lanes, slots)
  const long long* pos;   // (batch,): lane l decodes at pos[l % batch]
  void* out;              // (lanes, heads, hd) compute dtype
  int batch, heads, kv, hd, slots, window;
  float scale;            // sqrt(hd) rounded to the compute dtype
  float inv_scale;        // RN(1 / scale)
};

// rows of K (and of V) a thread stages at once: the rows of a 128-slot
// cache, at most 8
template <int TPR>
__host__ __device__ constexpr int row_tile() {
  return TPR / 2 < 1 ? 1 : (TPR / 2 > 8 ? 8 : TPR / 2);
}

// 16 bytes from global to shared memory, asynchronously (cp.async)
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a cache value as the compute dtype rounds it: an identity unless the
// cache is f32 and the compute dtype bfloat16
template <typename T, typename C>
__device__ __forceinline__ float as_compute(float x) {
  if constexpr (sizeof(C) == 4 && sizeof(T) == 2) {
    return round_to<T>(x);
  } else {
    return x;
  }
}

// four CTAs an SM where a thread holds up to 4 rows of K and V (head dims
// of 64 and below in bf16): at 256 lanes of smollm-135m 0.0223 ms a layer
// against 0.0254 with two, at 32 lanes 0.0076 against 0.0073 (an NVIDIA
// H100 80GB HBM3 at 700 W)
template <typename T, typename C, int TPR>
__global__ void __launch_bounds__(kAttnThreads, TPR <= 8 ? 4 : 2)
decode_attention_kernel(const __grid_constant__ DecodeArgs a) {
  constexpr int E = 16 / (int)sizeof(C);      // elements a 16-byte segment
  constexpr int RPP = kAttnThreads / TPR;     // row groups
  constexpr int NR = row_tile<TPR>();
  constexpr int KH = kHeadChunk;
  extern __shared__ uint4 stage[];            // (2, NR, threads): K, V rows
  __shared__ float red[2][kAttnWarps * kMaxGroup];
  const int lane = blockIdx.x / a.kv;           // lanes * kv < 2^31
  const int kvh = blockIdx.x - lane * a.kv;
  const int r = a.heads / a.kv, hd = a.hd, T_ = a.slots, kv = a.kv;
  const int rp = (r + KH - 1) / KH * KH;       // heads padded to chunks
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  const int g = tid / TPR, c = tid % TPR;
  uint4* kst = stage;                   // a thread's K rows: kst[i * 256 + tid]
  uint4* vst = stage + NR * kAttnThreads;
  float* qs = reinterpret_cast<float*>(stage + 2 * NR * kAttnThreads);
  float* ss = qs + rp * hd;             // (rp, slots): scores, then probs
  float* pv = ss + rp * T_;             // (warps, rp, hd): P.V partials

  const long long row = (long long)kv * hd;     // a cache row's stride
  const long long row16 = row / E;              // the same in 16 bytes
  const long long base = (long long)lane * T_ * row + kvh * hd + c * E;
  const uint4* kc = reinterpret_cast<const uint4*>(
      static_cast<const C*>(a.k_cache) + base);
  const uint4* vc = reinterpret_cast<const uint4*>(
      static_cast<const C*>(a.v_cache) + base);
  const int* sp = a.slot_pos + (long long)lane * T_;
  const int nrows = (T_ + RPP - 1) / RPP;       // rows of the busiest thread
  const int ntiles = (nrows + NR - 1) / NR;

  // the first tile's K and V rows copied to shared memory asynchronously
  // before any arithmetic (two groups: K, then V), so the CTA waits about
  // one memory latency; each thread reads back only the rows it copied
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int t = g + RPP * i;
    if (t < T_) copy16(kst + i * kAttnThreads + tid, kc + t * row16);
  }
  copies_commit();
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int t = g + RPP * i;
    if (t < T_) copy16(vst + i * kAttnThreads + tid, vc + t * row16);
  }
  copies_commit();
  const long long p = a.pos[lane % a.batch];
  const int slot = a.window > 0 ? (int)(p % T_)
                                : (int)(p < T_ - 1 ? p : T_ - 1);
  const T* q = static_cast<const T*>(a.q) +
               ((long long)lane * a.heads + kvh * r) * hd;
  for (int i = tid; i < rp * hd; i += kAttnThreads)
    qs[i] = i < r * hd ? to_f(q[i]) : 0.0f;     // padded heads score 0
  // 1: the new rows in the cache dtype, written by the threads that own
  // the slot's row and read back from registers
  const bool owner = slot % RPP == g;
  uint4 knew = make_uint4(0u, 0u, 0u, 0u), vnew = knew;
  if (owner) {
    float f[E];
    const long long at = ((long long)lane * kv + kvh) * hd + c * E;
    load_f32<T, E>(static_cast<const T*>(a.k_new) + at, f);
    knew = pack16<C, E>(f);
    load_f32<T, E>(static_cast<const T*>(a.v_new) + at, f);
    vnew = pack16<C, E>(f);
    uint4* kw = reinterpret_cast<uint4*>(static_cast<C*>(a.k_cache) + base);
    uint4* vw = reinterpret_cast<uint4*>(static_cast<C*>(a.v_cache) + base);
    kw[slot * row16] = knew;
    vw[slot * row16] = vnew;
  }
  if (kvh == 0 && tid == 0)
    a.slot_pos[(long long)lane * T_ + slot] = (int)p;
  __syncthreads();                      // qs

  // 2-3: the scores, KH query heads at a time against a tile of a thread's
  // rows; each thread's max over its rows, then the warp's, for each head
  const float neg_inf = round_to<T>(-1e30f);
  for (int h0 = 0; h0 < rp; h0 += KH) {
    float rmax[KH];
#pragma unroll
    for (int j = 0; j < KH; ++j) rmax[j] = -__int_as_float(0x7f800000);
    for (int tile = 0; tile < ntiles; ++tile) {
      if (ntiles > 1) {
        if (h0 > 0 || tile > 0) {
#pragma unroll
          for (int i = 0; i < NR; ++i) {
            const int t = g + RPP * (tile * NR + i);
            if (t < T_) copy16(kst + i * kAttnThreads + tid, kc + t * row16);
          }
          copies_commit();
        }
        copies_wait<0>();
      } else {
        copies_wait<1>();               // the K group
      }
      float qf[KH][E];
#pragma unroll
      for (int j = 0; j < KH; ++j)
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(
              qs + (h0 + j) * hd + c * E + e);
          qf[j][e] = v4.x;
          qf[j][e + 1] = v4.y;
          qf[j][e + 2] = v4.z;
          qf[j][e + 3] = v4.w;
        }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int t = g + RPP * (tile * NR + i);
        // the slot's row from registers; the row's validity (the slot
        // written above holds p; the other CTAs of this lane may be
        // writing slot_pos[slot] now, so it is not read)
        const uint4 kr = t == slot ? knew : kst[i * kAttnThreads + tid];
        const long long tpos = t == slot ? p : t < T_ ? (long long)sp[t] : -1;
        const bool valid = tpos >= 0 && tpos <= p &&
                           (a.window <= 0 || tpos > p - a.window);
        const uint32_t w[4] = {kr.x, kr.y, kr.z, kr.w};
        float kf[E];
        unpack(w, kf, E, C());
        float acc[KH], num[KH], sc[KH];
        bool slow = false;
#pragma unroll
        for (int j = 0; j < KH; ++j) {
          acc[j] = 0.0f;
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[j] = __fmaf_rn(qf[j][e], as_compute<T, C>(kf[e]), acc[j]);
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
#pragma unroll
          for (int j = 0; j < KH; ++j)
            acc[j] = __fadd_rn(acc[j],
                               __shfl_xor_sync(0xffffffffu, acc[j], off));
#pragma unroll
        for (int j = 0; j < KH; ++j) {
          num[j] = round_to<T>(acc[j]);
          sc[j] = div_rn(num[j], a.scale, a.inv_scale, slow);
        }
        if (slow) {
#pragma unroll
          for (int j = 0; j < KH; ++j) sc[j] = __fdiv_rn(num[j], a.scale);
        }
        if (t < T_) {
#pragma unroll
          for (int j = 0; j < KH; ++j) {
            const float v = valid ? round_to<T>(sc[j]) : neg_inf;
            rmax[j] = nan_max(rmax[j], v);
            if (c == 0) ss[(h0 + j) * T_ + t] = v;
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < KH; ++j)
        rmax[j] = nan_max(rmax[j], __shfl_xor_sync(0xffffffffu, rmax[j], off));
    if (ln == 0) {
#pragma unroll
      for (int j = 0; j < KH; ++j) red[0][warp * kMaxGroup + h0 + j] = rmax[j];
    }
  }
  __syncthreads();                      // ss, the warps' maxima

  // 4: the f32 softmax over all warps, KH heads at a time: thread tid's
  // terms exp_xla(s - max) for t = tid, tid + 256, ... in order, the warp's
  // tree, the warps in order; then the probabilities rounded to the
  // compute dtype into ss, each thread its own terms
  for (int h0 = 0; h0 < rp; h0 += KH) {
    float m[KH], sum[KH];
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      m[j] = red[0][h0 + j];
      sum[j] = 0.0f;
    }
#pragma unroll
    for (int w = 1; w < kAttnWarps; ++w)
#pragma unroll
      for (int j = 0; j < KH; ++j)
        m[j] = nan_max(m[j], red[0][w * kMaxGroup + h0 + j]);
    for (int t = tid; t < T_; t += kAttnThreads) {
#pragma unroll
      for (int j = 0; j < KH; ++j) {
        const float e = exp_xla(__fsub_rn(ss[(h0 + j) * T_ + t], m[j]));
        ss[(h0 + j) * T_ + t] = e;
        sum[j] = __fadd_rn(sum[j], e);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < KH; ++j)
        sum[j] = __fadd_rn(sum[j], __shfl_xor_sync(0xffffffffu, sum[j], off));
    if (ln == 0) {
#pragma unroll
      for (int j = 0; j < KH; ++j) red[1][warp * kMaxGroup + h0 + j] = sum[j];
    }
  }
  __syncthreads();                      // the warps' sums
  for (int h0 = 0; h0 < rp; h0 += KH) {
    float tot[KH], rtot[KH];
#pragma unroll
    for (int j = 0; j < KH; ++j) tot[j] = 0.0f;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w)
#pragma unroll
      for (int j = 0; j < KH; ++j)
        tot[j] = __fadd_rn(tot[j], red[1][w * kMaxGroup + h0 + j]);
#pragma unroll
    for (int j = 0; j < KH; ++j) rtot[j] = __frcp_rn(tot[j]);
    for (int t = tid; t < T_; t += kAttnThreads) {
      float e[KH], pt[KH];
      bool slow = false;
#pragma unroll
      for (int j = 0; j < KH; ++j) {
        e[j] = ss[(h0 + j) * T_ + t];
        pt[j] = div_rn(e[j], tot[j], rtot[j], slow);
      }
      if (slow) {
#pragma unroll
        for (int j = 0; j < KH; ++j) pt[j] = __fdiv_rn(e[j], tot[j]);
      }
#pragma unroll
      for (int j = 0; j < KH; ++j) ss[(h0 + j) * T_ + t] = round_to<T>(pt[j]);
    }
  }
  __syncthreads();                      // the probabilities

  // 5: the probability-weighted value rows, KH heads at a time; the V rows
  // come from the staged tile when a thread's rows fit one
  for (int h0 = 0; h0 < rp; h0 += KH) {
    float acc[KH][E];
#pragma unroll
    for (int j = 0; j < KH; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] = 0.0f;
    for (int tile = 0; tile < ntiles; ++tile) {
      if (ntiles > 1) {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int t = g + RPP * (tile * NR + i);
          if (t < T_) copy16(vst + i * kAttnThreads + tid, vc + t * row16);
        }
        copies_commit();
      }
      copies_wait<0>();
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int t = g + RPP * (tile * NR + i);
        if (t < T_) {
          const uint4 vr = t == slot ? vnew : vst[i * kAttnThreads + tid];
          const uint32_t w[4] = {vr.x, vr.y, vr.z, vr.w};
          float vf[E], pt[KH];
          unpack(w, vf, E, C());
#pragma unroll
          for (int j = 0; j < KH; ++j) pt[j] = ss[(h0 + j) * T_ + t];
#pragma unroll
          for (int j = 0; j < KH; ++j)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[j][e] = __fmaf_rn(pt[j], as_compute<T, C>(vf[e]),
                                    acc[j][e]);
        }
      }
    }
#pragma unroll
    for (int off = 16; off >= TPR; off >>= 1)
#pragma unroll
      for (int j = 0; j < KH; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[j][e] = __fadd_rn(acc[j][e],
                                __shfl_xor_sync(0xffffffffu, acc[j][e], off));
    if (ln < TPR) {
#pragma unroll
      for (int j = 0; j < KH; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e)
          pv[(warp * rp + h0 + j) * hd + c * E + e] = acc[j][e];
    }
  }
  __syncthreads();                      // pv
  T* out = static_cast<T*>(a.out) +
           ((long long)lane * a.heads + kvh * r) * hd;
  for (int i = tid; i < r * hd; i += kAttnThreads) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w)
      v = __fadd_rn(v, pv[w * rp * hd + i]);
    out[i] = from_f<T>(v);
  }
}

template <typename T, typename C, int TPR>
int launch(const DecodeArgs& a, long long lanes, cudaStream_t stream) {
  const int r = a.heads / a.kv;
  const int rp = (r + kHeadChunk - 1) / kHeadChunk * kHeadChunk;
  const size_t smem = sizeof(uint4) * 2 * row_tile<TPR>() * kAttnThreads +
                      sizeof(float) * ((size_t)rp * a.hd +
                                       (size_t)rp * a.slots +
                                       (size_t)kAttnWarps * rp * a.hd);
  static size_t allowed = 48 * 1024;   // raised once a size (not in a capture)
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, C, TPR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  decode_attention_kernel<T, C, TPR><<<(unsigned)(lanes * a.kv),
                                       kAttnThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the instantiations: TPR = hd / E of head dims 32, 64 and 128
template <typename T, typename C>
int launch_tpr(const DecodeArgs& a, long long lanes, cudaStream_t stream) {
  switch (a.hd / (16 / (int)sizeof(C))) {
    case 4: return launch<T, C, 4>(a, lanes, stream);
    case 8: return launch<T, C, 8>(a, lanes, stream);
    case 16: return launch<T, C, 16>(a, lanes, stream);
    case 32: return launch<T, C, 32>(a, lanes, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the split form's largest cluster, and its dynamic shared memory: the
// card's 227 KB less the kernel's static arrays
constexpr int kMaxCluster = 16;      // decode_attention.py: MAX_CLUSTER
constexpr int kSplitMaxSmem = 232448 - 1280;   // SPLIT_MAX_SMEM

// the split cluster barrier (arrive releasing this thread's shared-memory
// writes to the cluster, wait acquiring its peers')
__device__ __forceinline__ void split_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void split_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// SEG 16-byte segments of a row (a thread's E = SEG * 16 / sizeof(C)
// elements), as f32
template <typename C, int SEG>
__device__ __forceinline__ void row_f32(const uint4 (&w)[SEG],
                                        float (&f)[SEG * 16 / sizeof(C)]) {
  constexpr int E1 = 16 / (int)sizeof(C);
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    const uint32_t u[4] = {w[s].x, w[s].y, w[s].z, w[s].w};
    float g[E1];
    unpack(u, g, E1, C());
#pragma unroll
    for (int e = 0; e < E1; ++e) f[s * E1 + e] = g[e];
  }
}

// the split form's shared memory: the staged K rows (and V rows when
// `two`, else V reuses K's), then f32 queries, scores, a head chunk's
// warp sums, the CTA's P.V sums, and the tile's slot_pos
__host__ __device__ inline long long split_stage(int ts, int tpr, int seg) {
  const int rpp = kAttnThreads / tpr;
  return (long long)((ts + rpp - 1) / rpp) * kAttnThreads * seg * 16;
}
__host__ __device__ inline long long split_rest(int rp, int hd, int ts) {
  return 4LL * ((long long)rp * hd + (long long)rp * ts +
                (long long)kAttnWarps * kHeadChunk * hd + (long long)rp * hd +
                (ts + 3) / 4 * 4);
}

template <typename T, typename C, int TPR, int SEG>
__global__ void __launch_bounds__(kAttnThreads, 1)
decode_attention_split_kernel(const __grid_constant__ DecodeArgs a,
                              const int nc, const int ts, const int two) {
  constexpr int E1 = 16 / (int)sizeof(C);    // elements a segment
  constexpr int E = SEG * E1;                // elements a thread
  constexpr int RPP = kAttnThreads / TPR;    // row groups
  constexpr int KH = kHeadChunk;
  extern __shared__ uint4 dsm[];
  __shared__ float red[2][kAttnWarps * kMaxGroup];
  __shared__ float cmax[kMaxGroup], csum[kMaxGroup];   // read by the peers
  __shared__ float gmax[kMaxGroup], gsum[kMaxGroup];   // the cluster's
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int unit = blockIdx.x / nc;          // (lane, KV head)
  const int lane = unit / a.kv;
  const int kvh = unit - lane * a.kv;
  const int r = a.heads / a.kv, hd = a.hd, T_ = a.slots, kv = a.kv;
  const int rp = (r + KH - 1) / KH * KH;
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  const int g = tid / TPR, c = tid % TPR;
  const int base = rank * ts;                // this CTA's first slot
  const int nt = max(0, min(ts, T_ - base)); // its slots
  const int nr = (ts + RPP - 1) / RPP;       // rows a thread, at most
  const int nrows = nt > g ? (nt - g + RPP - 1) / RPP : 0;  // its rows
  const int nrows_all = (nt + RPP - 1) / RPP;                // uniform
  uint4* kst = dsm;                          // kst[(i * 256 + tid) * SEG]
  uint4* vst = two ? dsm + (long long)nr * kAttnThreads * SEG : dsm;
  float* qs = reinterpret_cast<float*>(   // (rp, E, TPR): see below
      dsm + (long long)(two ? 2 : 1) * nr * kAttnThreads * SEG);
  float* ss = qs + rp * hd;                  // (rp, ts): scores, probs
  float* pv = ss + rp * ts;                  // (warps, KH, hd)
  float* part = pv + kAttnWarps * KH * hd;   // (rp, hd): P.V sums
  int* sps = reinterpret_cast<int*>(part + rp * hd);  // (ts,) slot_pos

  const long long row16 = (long long)kv * hd / E1;  // a row, in 16 bytes
  const long long at = (long long)lane * T_ * kv * hd + kvh * hd + c * E;
  const uint4* kc = reinterpret_cast<const uint4*>(
      static_cast<const C*>(a.k_cache) + at);
  const uint4* vc = reinterpret_cast<const uint4*>(
      static_cast<const C*>(a.v_cache) + at);
  const int* sp = a.slot_pos + (long long)lane * T_;

  // every K row of the thread (and its V rows, with two buffers) copied to
  // shared memory asynchronously before any arithmetic: one memory
  // latency; each thread reads back only the rows it copied
  for (int i = 0; i < nrows; ++i) {
    const long long t = base + g + RPP * i;
#pragma unroll
    for (int s = 0; s < SEG; ++s)
      copy16(kst + (i * kAttnThreads + tid) * SEG + s, kc + t * row16 + s);
  }
  copies_commit();
  if (two) {
    for (int i = 0; i < nrows; ++i) {
      const long long t = base + g + RPP * i;
#pragma unroll
      for (int s = 0; s < SEG; ++s)
        copy16(vst + (i * kAttnThreads + tid) * SEG + s, vc + t * row16 + s);
    }
  }
  copies_commit();
  for (int t = tid; t < nt; t += kAttnThreads) sps[t] = sp[base + t];
  const long long p = a.pos[lane % a.batch];
  const int slot = a.window > 0 ? (int)(p % T_)
                                : (int)(p < T_ - 1 ? p : T_ - 1);
  const T* q = static_cast<const T*>(a.q) +
               ((long long)lane * a.heads + kvh * r) * hd;
  // the group's queries as f32, 16 loads a thread issued at once
  constexpr int QN = 16;
  for (int i0 = 0; i0 < rp * hd; i0 += QN * kAttnThreads) {
    float qv[QN];
#pragma unroll
    for (int k = 0; k < QN; ++k) {
      const int i = i0 + tid + k * kAttnThreads;
      qv[k] = i < r * hd ? to_f(q[i]) : 0.0f;  // padded heads score 0
    }
#pragma unroll
    for (int k = 0; k < QN; ++k) {
      // element d = c E + e of head h at h hd + e TPR + c: a warp's reads
      // of one element across its threads fall in 32 banks
      const int i = i0 + tid + k * kAttnThreads;
      const int h = i / hd, d = i - h * hd;
      if (i < rp * hd) qs[h * hd + (d % E) * TPR + d / E] = qv[k];
    }
  }
  // 1: the new rows in the cache dtype, by the CTA whose tile holds the
  // slot, from the threads of its row group
  const bool mine = slot >= base && slot < base + nt;
  const bool owner = mine && (slot - base) % RPP == g;
  uint4 knew[SEG], vnew[SEG];
#pragma unroll
  for (int s = 0; s < SEG; ++s) knew[s] = vnew[s] = make_uint4(0u, 0u, 0u, 0u);
  if (owner) {
    const long long src = ((long long)lane * kv + kvh) * hd + c * E;
#pragma unroll
    for (int s = 0; s < SEG; ++s) {
      float f[E1];
      load_f32<T, E1>(static_cast<const T*>(a.k_new) + src + s * E1, f);
      knew[s] = pack16<C, E1>(f);
      load_f32<T, E1>(static_cast<const T*>(a.v_new) + src + s * E1, f);
      vnew[s] = pack16<C, E1>(f);
    }
    uint4* kw = reinterpret_cast<uint4*>(static_cast<C*>(a.k_cache) + at);
    uint4* vw = reinterpret_cast<uint4*>(static_cast<C*>(a.v_cache) + at);
#pragma unroll
    for (int s = 0; s < SEG; ++s) {
      kw[slot * row16 + s] = knew[s];
      vw[slot * row16 + s] = vnew[s];
    }
  }
  if (mine && kvh == 0 && tid == 0)
    a.slot_pos[(long long)lane * T_ + slot] = (int)p;
  split_arrive();                       // this CTA has started
  __syncthreads();                      // qs, sps
  copies_wait<1>();                     // the K rows

  // 2-3: the scores, KH heads at a time against all of a thread's staged
  // rows (its queries in registers, each row read from shared memory once
  // a chunk); each thread's maximum of each head, then the warp's
  const float neg_inf = round_to<T>(-1e30f);
  for (int h0 = 0; h0 < rp; h0 += KH) {
    float qf[KH][E], rmax[KH];
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      rmax[j] = -__int_as_float(0x7f800000);
#pragma unroll
      for (int e = 0; e < E; ++e) qf[j][e] = qs[(h0 + j) * hd + e * TPR + c];
    }
    for (int i = 0; i < nrows_all; ++i) {
      const int tl = g + RPP * i;            // the local row
      const int t = base + tl;
      const bool live = i < nrows;           // uniform over a row's threads
      uint4 kr[SEG];
#pragma unroll
      for (int s = 0; s < SEG; ++s)
        kr[s] = (live && t != slot) ? kst[(i * kAttnThreads + tid) * SEG + s]
                                    : knew[s];
      const long long tpos = t == slot ? p : live ? (long long)sps[tl] : -1;
      const bool valid = tpos >= 0 && tpos <= p &&
                         (a.window <= 0 || tpos > p - a.window);
      float kf[E];
      row_f32<C, SEG>(kr, kf);
      float acc[KH], num[KH], sc[KH];
      bool slow = false;
#pragma unroll
      for (int j = 0; j < KH; ++j) {
        acc[j] = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[j] = __fmaf_rn(qf[j][e], as_compute<T, C>(kf[e]), acc[j]);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < KH; ++j)
          acc[j] = __fadd_rn(acc[j],
                             __shfl_xor_sync(0xffffffffu, acc[j], off));
#pragma unroll
      for (int j = 0; j < KH; ++j) {
        num[j] = round_to<T>(acc[j]);
        sc[j] = div_rn(num[j], a.scale, a.inv_scale, slow);
      }
      if (slow) {
#pragma unroll
        for (int j = 0; j < KH; ++j) sc[j] = __fdiv_rn(num[j], a.scale);
      }
      if (live) {
#pragma unroll
        for (int j = 0; j < KH; ++j) {
          const float v = valid ? round_to<T>(sc[j]) : neg_inf;
          rmax[j] = nan_max(rmax[j], v);
          if (c == 0) ss[(h0 + j) * ts + tl] = v;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < KH; ++j)
        rmax[j] = nan_max(rmax[j], __shfl_xor_sync(0xffffffffu, rmax[j], off));
    if (ln == 0) {
#pragma unroll
      for (int j = 0; j < KH; ++j) red[0][warp * kMaxGroup + h0 + j] = rmax[j];
    }
  }
  if (!two) {
    // V into the K rows' place: this thread's own, read by it alone
    for (int i = 0; i < nrows; ++i) {
      const long long t = base + g + RPP * i;
#pragma unroll
      for (int s = 0; s < SEG; ++s)
        copy16(vst + (i * kAttnThreads + tid) * SEG + s, vc + t * row16 + s);
    }
    copies_commit();
  }
  __syncthreads();
  if (tid < rp) {
    float m = red[0][tid];
    for (int w = 1; w < kAttnWarps; ++w)
      m = nan_max(m, red[0][w * kMaxGroup + tid]);
    cmax[tid] = m;
  }
  split_wait();                         // every CTA has started
  split_arrive();                       // cmax
  split_wait();
  // thread h gathers head h's maxima from the cluster into gmax[h]
  if (tid < rp) {
    float v = *cluster.map_shared_rank(&cmax[tid], 0);
    for (int qq = 1; qq < nc; ++qq)
      v = nan_max(v, *cluster.map_shared_rank(&cmax[tid], qq));
    gmax[tid] = v;
  }
  __syncthreads();

  // 4: the f32 softmax: the cluster's maximum; thread tid's terms over its
  // local rows tid, tid + 256, ..., the warp's tree, the warps in order
  // from +0 (this CTA's sum), then the CTAs' sums in rank order
  for (int h0 = 0; h0 < rp; h0 += KH) {
    float sum[KH], mh[KH];
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      sum[j] = 0.0f;
      mh[j] = gmax[h0 + j];
    }
    for (int t = tid; t < nt; t += kAttnThreads) {
#pragma unroll
      for (int j = 0; j < KH; ++j) {
        const float e = exp_xla(__fsub_rn(ss[(h0 + j) * ts + t], mh[j]));
        ss[(h0 + j) * ts + t] = e;
        sum[j] = __fadd_rn(sum[j], e);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < KH; ++j)
        sum[j] = __fadd_rn(sum[j], __shfl_xor_sync(0xffffffffu, sum[j], off));
    if (ln == 0) {
#pragma unroll
      for (int j = 0; j < KH; ++j) red[1][warp * kMaxGroup + h0 + j] = sum[j];
    }
  }
  __syncthreads();
  if (tid < rp) {
    float v = 0.0f;
    for (int w = 0; w < kAttnWarps; ++w)
      v = __fadd_rn(v, red[1][w * kMaxGroup + tid]);
    csum[tid] = v;
  }
  split_arrive();                       // csum
  split_wait();
  // thread h adds head h's sums in rank order into gsum[h]
  if (tid < rp) {
    float v = *cluster.map_shared_rank(&csum[tid], 0);
    for (int qq = 1; qq < nc; ++qq)
      v = __fadd_rn(v, *cluster.map_shared_rank(&csum[tid], qq));
    gsum[tid] = v;
  }
  __syncthreads();
  for (int h0 = 0; h0 < rp; h0 += KH) {
    float tot[KH], rtot[KH];
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      tot[j] = gsum[h0 + j];
      rtot[j] = __frcp_rn(tot[j]);
    }
    for (int t = tid; t < nt; t += kAttnThreads) {
      float e[KH], pt[KH];
      bool slow = false;
#pragma unroll
      for (int j = 0; j < KH; ++j) {
        e[j] = ss[(h0 + j) * ts + t];
        pt[j] = div_rn(e[j], tot[j], rtot[j], slow);
      }
      if (slow) {
#pragma unroll
        for (int j = 0; j < KH; ++j) pt[j] = __fdiv_rn(e[j], tot[j]);
      }
#pragma unroll
      for (int j = 0; j < KH; ++j) ss[(h0 + j) * ts + t] = round_to<T>(pt[j]);
    }
  }
  __syncthreads();                      // the probabilities
  copies_wait<0>();                     // the V rows

  // 5: P.V, KH heads at a time: thread (g, c) over its staged V rows in
  // order from +0; the warp's row groups' tree; the warps in order from +0
  // into this CTA's sums
  for (int h0 = 0; h0 < rp; h0 += KH) {
    float acc[KH][E];
#pragma unroll
    for (int j = 0; j < KH; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] = 0.0f;
    for (int i = 0; i < nrows; ++i) {
      const int tl = g + RPP * i;
      uint4 vr[SEG];
#pragma unroll
      for (int s = 0; s < SEG; ++s)
        vr[s] = base + tl != slot ? vst[(i * kAttnThreads + tid) * SEG + s]
                                  : vnew[s];
      float vf[E], pt[KH];
      row_f32<C, SEG>(vr, vf);
#pragma unroll
      for (int j = 0; j < KH; ++j) pt[j] = ss[(h0 + j) * ts + tl];
#pragma unroll
      for (int j = 0; j < KH; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[j][e] = __fmaf_rn(pt[j], as_compute<T, C>(vf[e]), acc[j][e]);
    }
#pragma unroll
    for (int off = 16; off >= TPR; off >>= 1)
#pragma unroll
      for (int j = 0; j < KH; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[j][e] = __fadd_rn(acc[j][e],
                                __shfl_xor_sync(0xffffffffu, acc[j][e], off));
    if (ln < TPR) {
#pragma unroll
      for (int j = 0; j < KH; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e)
          pv[(warp * KH + j) * hd + c * E + e] = acc[j][e];
    }
    __syncthreads();                    // pv
    for (int i = tid; i < KH * hd; i += kAttnThreads) {
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kAttnWarps; ++w)
        v = __fadd_rn(v, pv[w * KH * hd + i]);
      part[h0 * hd + i] = v;
    }
    __syncthreads();                    // pv is free again
  }
  split_arrive();                       // part
  split_wait();
  // this CTA's slice of the outputs: the CTAs' sums in rank order
  const int n_out = r * hd;
  const int per = (n_out + nc - 1) / nc;
  T* out = static_cast<T*>(a.out) +
           ((long long)lane * a.heads + kvh * r) * hd;
  for (int i = rank * per + tid; i < min(n_out, (rank + 1) * per);
       i += kAttnThreads) {
    float v = *cluster.map_shared_rank(&part[i], 0);
    for (int qq = 1; qq < nc; ++qq)
      v = __fadd_rn(v, *cluster.map_shared_rank(&part[i], qq));
    out[i] = from_f<T>(v);
  }
  split_arrive();                       // no CTA leaves while read
  split_wait();
}

template <typename T, typename C, int TPR, int SEG>
int launch_split(const DecodeArgs& a, long long lanes, int nc, int ts,
                 cudaStream_t stream) {
  const int r = a.heads / a.kv;
  const int rp = (r + kHeadChunk - 1) / kHeadChunk * kHeadChunk;
  const long long stage = split_stage(ts, TPR, SEG);
  const long long rest = split_rest(rp, a.hd, ts);
  const int two = 2 * stage + rest <= kSplitMaxSmem;
  const long long smem = (two ? 2 : 1) * stage + rest;
  if (smem > kSplitMaxSmem) return (int)cudaErrorInvalidValue;
  static long long allowed = 0;        // raised once a size (not in a capture)
  if (allowed == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_split_kernel<T, C, TPR, SEG>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    allowed = 48 * 1024;
  }
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_split_kernel<T, C, TPR, SEG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(lanes * a.kv * nc), 1, 1);
  cfg.blockDim = dim3(kAttnThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_attention_split_kernel<T, C, TPR, SEG>, a, nc, ts, two);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the split form's instantiations: a row of TPR threads of SEG segments
template <typename T, typename C>
int launch_split_tpr(const DecodeArgs& a, long long lanes, int nc, int ts,
                     cudaStream_t stream) {
  switch (a.hd / (16 / (int)sizeof(C))) {
    case 4: return launch_split<T, C, 4, 1>(a, lanes, nc, ts, stream);
    case 8: return launch_split<T, C, 8, 1>(a, lanes, nc, ts, stream);
    case 16: return launch_split<T, C, 16, 1>(a, lanes, nc, ts, stream);
    case 32: return launch_split<T, C, 32, 1>(a, lanes, nc, ts, stream);
    case 64: return launch_split<T, C, 32, 2>(a, lanes, nc, ts, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro_torch

// One launch for every lane: q (lanes, heads, hd), k_new and v_new (lanes,
// kv, hd) in the compute dtype (bf16 if compute_bf16, else f32); the caches
// (lanes, slots, kv, hd) in the cache dtype (bf16 if cache_bf16, else f32)
// and slot_pos (lanes, slots) int32, updated in place; pos (batch,) int64,
// lane l at pos[l % batch]; out (lanes, heads, hd) in the compute dtype.
// heads is a multiple of kv, heads / kv <= 16; hd is 16 bytes of the cache
// dtype times 4, 8, 16 or 32 (head dims 32, 64 and 128), or 64 in the
// split form (f32 rows of 256); the caches and the new rows are 16-byte
// aligned; scale is sqrt(hd) in the compute dtype and inv_scale RN(1 /
// scale). cluster: 0 for the one-CTA form, else the split form's CTAs a
// (lane, KV head), a power of two up to 16, each over tile slots
// (decode_attention.py: split_of).
extern "C" int repro_decode_attention(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, int* slot_pos, const long long* pos, void* out,
    long long lanes, int batch, int heads, int kv, int hd, int slots,
    int window, float scale, float inv_scale, int compute_bf16,
    int cache_bf16, int cluster, int tile, void* stream) {
  using namespace repro_torch;
  const int e = cache_bf16 ? 8 : 4, tpr = hd / e;
  const int max_tpr = cluster ? 64 : 32;
  if (lanes < 1 || batch < 1 || lanes % batch || kv < 1 || heads % kv ||
      heads / kv > kMaxGroup || hd < 1 || hd % e || tpr < 4 ||
      tpr > max_tpr || (tpr & (tpr - 1)) || slots < 1 || window < 0 ||
      lanes * kv * (cluster ? cluster : 1) > 0x7fffffffLL ||
      (cluster && (cluster > kMaxCluster || (cluster & (cluster - 1)) ||
                   tile < 1 || (long long)tile * cluster < slots)))
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{q, k_new, v_new, k_cache, v_cache, slot_pos, pos, out,
                     batch, heads, kv, hd, slots, window, scale, inv_scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (cluster) {
    if (compute_bf16)
      return cache_bf16 ? launch_split_tpr<__nv_bfloat16, __nv_bfloat16>(
                              a, lanes, cluster, tile, st)
                        : launch_split_tpr<__nv_bfloat16, float>(
                              a, lanes, cluster, tile, st);
    return cache_bf16 ? launch_split_tpr<float, __nv_bfloat16>(
                            a, lanes, cluster, tile, st)
                      : launch_split_tpr<float, float>(a, lanes, cluster,
                                                        tile, st);
  }
  if (compute_bf16) {
    return cache_bf16 ? launch_tpr<__nv_bfloat16, __nv_bfloat16>(a, lanes, st)
                      : launch_tpr<__nv_bfloat16, float>(a, lanes, st);
  }
  return cache_bf16 ? launch_tpr<float, __nv_bfloat16>(a, lanes, st)
                    : launch_tpr<float, float>(a, lanes, st);
}
