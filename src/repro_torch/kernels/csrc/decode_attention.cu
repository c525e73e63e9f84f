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
// query heads of 256 over one KV head, and any f32 row of 256. One (lane,
// KV head) is a portable thread block cluster of NC CTAs (a power of two,
// at most 8); CTA q owns the slots [q TS, (q + 1) TS), TS = ceil(slots /
// NC), with NC the least power of two with NC 256 >= slots (split_of: a
// function of the lane's shapes alone, so a lane's output does not depend
// on how many lanes share the launch). Its order, which the plain version
// follows op for op:
//
//   score: thread tid takes local rows tid, tid + 256, ... and all the
//     group's heads at once; each head's dot product is one fma chain over
//     d = 0, 1, ..., hd - 1 from +0 (no tree), then rounded, divided and
//     masked as above;
//   the maximum: each head's over the cluster (order-free);
//   softmax: thread tid's terms exp_xla(s_t - max) over its local rows in
//     order from +0, a halving tree over the warp's 32 lanes (xor 16, ...,
//     1), the 8 warps' sums in index order from +0 (the CTA's sum), then
//     the CTAs' sums in rank order from CTA 0's; p_t = round(e_t / sum);
//   P.V: each output (head, column) one fma chain over the CTA's rows in
//     order from +0, then CTA 0's sum plus CTA 1's, ... in rank order,
//     rounded to the compute dtype; CTA q adds and writes the q-th slice.
//
// Design, for the SM's 128 f32 fma lanes: each dot product and each
// weighted value is one thread's fma chain, so no warp re-reduces what a
// thread holds, and the threads are blocked so that each value read from
// shared memory feeds 4 fmas: a score lane takes 4 rows by 4 heads (K
// staged in the cache dtype, the queries in f32), a P.V thread 4 heads by
// 4 columns (the probabilities in f32, V in the cache dtype). K and V
// stream through one ring of 16 KB stages, each one tensor copy (TMA,
// cp.async.bulk.tensor) that one thread starts and an mbarrier a stage
// reports landed; stage s + ns is copied once every thread has read stage
// s, so V's first stages land while the scores run and the cluster
// exchanges its maxima and sums, and no tile has to fit at once (an f32
// row of 256 takes the same path). The ring is sized so that two CTAs fit
// an SM (5 stages, 104 KB a CTA at recurrentgemma's shapes; tiles of more
// than about 1,600 slots, where not two stages fit beside the scores,
// take the SM alone): with one CTA an SM only 15 clusters of 8 fit the
// card's GPCs at once, and 16 lanes' 128 CTAs took two waves. The
// clusters are portable (at most 8 CTAs). What crosses the cluster goes
// through distributed shared memory behind 4 cluster barriers (maxima,
// sums, P.V sums, exit), every rank's values read at once. What bounds
// it: the lanes' K and V bytes, 33.96 MB a layer at 16 lanes of
// recurrentgemma-9b in bf16, 0.0101 ms at 3.35 TB/s; its 268 M fmas take
// 0.008 ms at the card's 67 TFLOP/s f32. Measured (chip_smoke.py, an
// NVIDIA H100 80GB HBM3 at 700.00 W): 0.0532 ms a layer at 16 lanes
// against SDPA's 0.0269 (its predecessor, 16-CTA clusters of 128 slots
// with a shuffle tree a score, 0.15936); in one A/B run 0.0522-0.0529
// against 0.0549 for the same ring of cp.async copies, 16 bytes a thread;
// a ring sized for one CTA an SM took 0.0796. The 112 CTAs alone on their
// SM take 36.5-37.6 us, the 16 that share one 47.7-52.1, and those set
// the layer's time; a lone CTA spends 5.4 us before its first stage
// lands, 12.1 in the scores, 6.4 in the softmax and its two exchanges,
// 11.6 in P.V and 1.7 in the rank sums, 5.0 of them waiting for stages:
// its fmas run at about a third of the SM's rate. What holds them there
// is not measured apart (no ncu).
#include <cooperative_groups.h>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda.h>
#include <cudaTypedefs.h>
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

// The split form (decode_attention_split_kernel): a cluster of nc CTAs a
// (lane, KV head), CTA q over the slots [q ts, q ts + nt). Its constants;
// decode_attention.py mirrors each. Its dynamic shared memory: half of the
// SM's 228 KB less the 1 KB reserved a CTA, so that two CTAs share an SM,
// or where not two stages fit there the card's 227 KB a CTA; each less the
// kernel's static arrays (red, cmax ... grcp, peer and the stages'
// mbarriers: 1,984 bytes), padded to the 1 KB that the ring's alignment
// takes.
constexpr int kMaxCluster = 8;       // MAX_CLUSTER: a portable cluster
constexpr int kMaxStages = 16;       // MAX_STAGES: the ring's mbarriers
constexpr int kSplitStatic =         // SPLIT_STATIC
    (4 * (2 * kAttnWarps * kMaxGroup + 5 * kMaxGroup +
          kMaxGroup * kMaxCluster) + 8 * kMaxStages + 1023) / 1024 * 1024;
constexpr int kSplitMaxSmem = 232448 - kSplitStatic;   // SPLIT_MAX_SMEM
constexpr int kSplitTwoSmem =        // SPLIT_TWO_SMEM
    233472 / 2 - 1024 - kSplitStatic;
constexpr int kStageBytes = 16384;   // STAGE_BYTES: a K or V stage
constexpr int kSplitClocks = 13;     // SPLIT_CLOCKS: phase ends, waits

// The split form's layout for head dim HD of the cache dtype C
template <int HD, typename C>
struct SplitShape {
  static constexpr int ROWB = HD * (int)sizeof(C);      // a cache row, bytes
  static constexpr int NCC = ROWB / 64;                 // K stages a row block
  static constexpr int EL = 16 / (int)sizeof(C);        // elements a chunk
  static constexpr int RV = kStageBytes / ROWB;         // rows a V stage
  static constexpr int NCG = HD / 4;                    // P.V column groups
  static constexpr int HO = HD / 64 < 1 ? 1 : HD / 64;  // P.V heads a thread
  static constexpr int HOP = HO < 4 ? 4 : HO;           // probs row padding
};

// the heads padded to 4, and the probabilities' row (padded to HOP)
__host__ __device__ inline int split_rp(int r) { return (r + 3) / 4 * 4; }
__host__ __device__ inline int split_rps(int r, int hop) {
  return (split_rp(r) + hop - 1) / hop * hop;
}

// the f32 queries, then in their place the f32 probabilities, and the
// tile's scores in the compute dtype (tsize bytes): the shared memory
// beside the ring
__host__ __device__ inline long long split_rest(int r, int hd, int ts,
                                                int tsize) {
  const int hop = hd / 64 < 4 ? 4 : hd / 64;
  const long long qp = (long long)hd * split_rp(r) >
                               (long long)ts * split_rps(r, hop)
                           ? (long long)hd * split_rp(r)
                           : (long long)ts * split_rps(r, hop);
  return 4 * qp + (long long)tsize * ts * split_rps(r, hop);
}

// the ring's stages: as many as fit beside the rest in the shared memory
// of one of two CTAs that share an SM, or where not two fit there (tiles
// of more than about 1,600 slots) in that of one CTA; 0 where not two fit
// at all
__host__ __device__ inline int split_stages(int r, int hd, int ts,
                                            int tsize) {
  const long long rest = split_rest(r, hd, ts, tsize);
  const long long two = (kSplitTwoSmem - rest) / kStageBytes;
  const long long one = (kSplitMaxSmem - rest) / kStageBytes;
  const long long ns = two >= 2 ? two : one >= 2 ? one : 0;
  return (int)(ns < kMaxStages ? ns : kMaxStages);
}

// the split cluster barrier (arrive releasing this thread's shared-memory
// writes to the cluster, wait acquiring its peers')
__device__ __forceinline__ void split_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void split_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The ring's copies: one thread arms a stage's mbarrier for its 16 KB
// and starts one tensor copy (TMA) into it; every thread then waits on
// the mbarrier's phase
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
// wait for the phase of this parity to complete; a copy that never lands
// traps (an error to the host) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int i = 0; !done; ++i) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (i > (1 << 22)) __trap();
  }
}
// the box of map at (c0, c1, c2, c3[, c4]) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// 16 bytes of the new row (T) at element `at`, in the cache dtype C
template <typename T, typename C>
__device__ __forceinline__ uint4 new_chunk(const void* src, long long at) {
  constexpr int EL = 16 / (int)sizeof(C);
  float f[EL];
  load_f32<T, EL>(static_cast<const T*>(src) + at, f);
  return pack16<C, EL>(f);
}

// N f32 values at p (aligned to 16 bytes where N is a multiple of 4)
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + k);
      f[k] = v.x, f[k + 1] = v.y, f[k + 2] = v.z, f[k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = p[k];
  }
}

// 4 values, each exact in T, stored at p (4 * sizeof(T)-aligned)
__device__ __forceinline__ void store4(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&f)[4]) {
  uint32_t w[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    w[k] = (__float_as_uint(f[2 * k]) >> 16) |
           (__float_as_uint(f[2 * k + 1]) & 0xffff0000u);
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// Scores: lane (g, hg) = (l % 8, l / 8) of warp w takes rows rb 256 + 32
// w + g + 8 i (i < 4) against heads 4 hg ... 4 hg + 3, each dot product
// one fma chain over d = 0 ... hd - 1 from +0; each head's maximum of its
// rows, a warp's, the CTA's, the cluster's (order-free). Softmax: thread
// tid's terms exp_xla(s - max) over its local rows tid, tid + 256, ... in
// order from +0, the warp's halving tree (xor 16, ..., 1), the 8 warps'
// sums in order from +0 (the CTA's sum), the CTAs' sums in rank order
// from rank 0's; p = RN_dt(e / sum) (a thread's first row's e kept, the
// others' computed again). P.V: thread (head
// block, column group) chains p_t v_t over the tile's rows in order from
// +0 for HO heads by 4 columns; the CTAs' sums in rank order from rank
// 0's, rounded to dt, CTA q adding and writing the q-th slice.
//
// K and V stream through one ring of ns stages of 16 KB, each one tensor
// copy (km, vm) reported by its mbarrier: K stage (rb, cc) holds bytes
// [64 cc, 64 cc + 64) of the row block's 256 rows (chunk c of row x at c
// XOR (x / 2 mod 4), the map's 64-byte swizzle, so the 8 rows a warp
// reads at once hit distinct bank groups), V stage j rows [j RV, (j + 1)
// RV) whole; stage s + ns is copied as soon as every thread has read
// stage s, so V's first
// stages land while the scores run and the cluster exchanges its maxima
// and sums. With kTimed (decode_attention_split_timed, chip_smoke.py's
// phase clocks only) thread 0 of CTA 0 writes clk[0 .. kSplitClocks) and
// thread 0 of every CTA its 3 stamps (repro_decode_attention_clocks).
template <typename T, typename C, int HD, bool kTimed>
__device__ __forceinline__ void split_body(const DecodeArgs& a, const int nc,
                                           const int ts, const int ns,
                                           const CUtensorMap* km,
                                           const CUtensorMap* vm,
                                           long long* const clk) {
  using S = SplitShape<HD, C>;
  constexpr int PR = S::ROWB / 16;           // 16-byte chunks a row
  constexpr int WEL = 64 / (int)sizeof(C);   // elements a K stage's row
  constexpr int SCH = kStageBytes / 16;      // chunks a stage
  constexpr int TCH = SCH / kAttnThreads;    // chunks a thread writes
  extern __shared__ __align__(1024) uint4 dsm[];
  __shared__ unsigned long long bars[kMaxStages];      // a stage's mbarrier
  __shared__ float red[2][kAttnWarps * kMaxGroup];
  __shared__ float cmax[kMaxGroup], csum[kMaxGroup];   // read by the peers
  __shared__ float gmax[kMaxGroup], gsum[kMaxGroup];   // the cluster's
  __shared__ float grcp[kMaxGroup];                    // RN(1 / gsum)
  __shared__ float peer[kMaxGroup * kMaxCluster];      // the ranks' values
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  const bool timed = kTimed && blockIdx.x == 0 && tid == 0;
  if (timed) clk[0] = clock64();
  const bool stamp = kTimed && tid == 0;   // each CTA's thread 0
  long long* const cta =
      stamp ? clk + kSplitClocks + 3LL * blockIdx.x : nullptr;
  if (stamp) {
    unsigned sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(cta[0]));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    cta[2] = sm;
  }
  const int rank = (int)cluster.block_rank();
  const int unit = blockIdx.x / nc;          // (lane, KV head)
  const int lane = unit / a.kv;
  const int kvh = unit - lane * a.kv;
  const int r = a.heads / a.kv, T_ = a.slots, kv = a.kv;
  const int rp = split_rp(r), rps = split_rps(r, S::HOP);
  const int base = rank * ts;                // this CTA's first slot
  const int nt = max(0, min(ts, T_ - base)); // its slots
  const int nrb = (nt + kAttnThreads - 1) / kAttnThreads;  // row blocks
  const int nk = nrb * S::NCC;               // K stages
  const int n = nk + (nt + S::RV - 1) / S::RV;   // and V stages
  const int n0 = min(ns, n);                 // copied at the start

  uint4* ring = dsm;
  // the f32 queries (HD, rp), then in their place the f32 probabilities
  // (ts, rps); the tile's scores (ts, rps) in the compute dtype
  float* qs = reinterpret_cast<float*>(ring + ns * SCH);
  float* pf = qs;
  T* ps = reinterpret_cast<T*>(qs + max(HD * rp, ts * rps));
  float* part = reinterpret_cast<float*>(dsm);   // (r, HD) after the ring

  const long long row16 = (long long)kv * HD / S::EL;  // a row, in 16 bytes
  const long long at = (long long)lane * T_ * kv * HD + (long long)kvh * HD;
  const int* sp = a.slot_pos + (long long)lane * T_;
  const long long src = ((long long)lane * kv + kvh) * HD;   // the new rows
  const long long p = a.pos[lane % a.batch];
  const int slot = a.window > 0 ? (int)(p % T_)
                                : (int)(p < T_ - 1 ? p : T_ - 1);
  const bool mine = slot >= base && slot < base + nt;

  auto swz = [](int x) { return (x >> 1) & 3; };
  // stage s's copy, by thread 0: K stage (rb, cc) the 64-byte column block
  // cc of the row block's 256 rows (the tensor map's 64-byte swizzle puts
  // chunk c of row x at c XOR swz(x)), V stage j rows [j RV, (j + 1) RV)
  // whole; rows past the tile are the next tile's or, past the lane's
  // slots, zeros, and read by no thread
  auto fill = [&](int s) {
    if (tid) return;
    const uint32_t st = smem_u32(ring + (s % ns) * SCH);
    const uint32_t bar = smem_u32(bars + s % ns);
    mbar_expect(bar, kStageBytes);
    if (s < nk) {
      const int rb = s / S::NCC, cc = s - rb * S::NCC;
      tma_load(st, km, bar, cc * WEL, kvh, base + rb * kAttnThreads, lane);
    } else {
      tma_load(st, vm, bar, 0, 0, kvh, base + (s - nk) * S::RV, lane);
    }
  };
  // the new row's chunks in landed stage s written over from the new rows
  // (the copy read the slot's old row), fenced for the copy that later
  // fills their place
  auto renew = [&](int s) {
    uint4* st = ring + (s % ns) * SCH;
#pragma unroll
    for (int k = 0; k < TCH; ++k) {
      const int pi = tid + kAttnThreads * k;
      if (s < nk) {
        const int rb = s / S::NCC, cc = s - rb * S::NCC;
        const int x = pi / 4, c = pi % 4;
        if (mine && base + rb * kAttnThreads + x == slot) {
          st[x * 4 + (c ^ swz(x))] = new_chunk<T, C>(
              a.k_new, src + (long long)cc * WEL + c * S::EL);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
      } else if (mine && base + (s - nk) * S::RV + pi / PR == slot) {
        st[pi] = new_chunk<T, C>(a.v_new, src + pi % PR * S::EL);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
    }
  };
  // stage s, read by every thread: landed (its mbarrier's (s / ns)-th
  // phase), the new row written over, then (every thread being past stage
  // s - 1) stage s - 1 + ns copied into s - 1's place
  long long waited = 0;                 // thread 0's cycles in arrive
  auto arrive = [&](int s) {
    const long long t0 = timed ? clock64() : 0;
    mbar_wait(smem_u32(bars + s % ns), (uint32_t)(s / ns) & 1u);
    renew(s);
    __syncthreads();
    if (timed) waited += clock64() - t0;
    if (s >= 1 && s - 1 + ns < n) fill(s - 1 + ns);
  };
  if (tid == 0) {
    for (int i = 0; i < ns; ++i) mbar_init(smem_u32(bars + i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                      // the mbarriers
  for (int s = 0; s < n0; ++s) fill(s);

  // 1: the new rows in the cache dtype, by the CTA whose tile holds the
  // slot; slot_pos[slot] by its KV-head-0 CTA
  if (mine && tid < PR) {
    uint4* kw = reinterpret_cast<uint4*>(static_cast<C*>(a.k_cache) + at);
    uint4* vw = reinterpret_cast<uint4*>(static_cast<C*>(a.v_cache) + at);
    kw[slot * row16 + tid] = new_chunk<T, C>(a.k_new, src + tid * S::EL);
    vw[slot * row16 + tid] = new_chunk<T, C>(a.v_new, src + tid * S::EL);
  }
  if (mine && kvh == 0 && tid == 0)
    a.slot_pos[(long long)lane * T_ + slot] = (int)p;
  // the group's queries, qs[d rp + h] (padded heads 0)
  const T* q = static_cast<const T*>(a.q) +
               ((long long)lane * a.heads + kvh * r) * HD;
  for (int d = tid; d < HD; d += kAttnThreads) {
    for (int j = 0; j < rp; j += 4) {
      float f[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        f[u] = j + u < r ? to_f(q[(j + u) * HD + d]) : 0.0f;
      store4(qs + d * rp + j, f);
    }
  }
  __syncthreads();                      // qs

  // 2-3: the scores, row block by row block, K stage by K stage
  const float neg_inf = round_to<T>(-1e30f);
  const int g = ln % 8, h4 = ln / 8 * 4;     // rows g + 8 i, heads h4 + u
  const bool heads = h4 < rp;
  const int sw = swz(g);                // of each row 32 w + g + 8 i
  float rmax[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) rmax[u] = -__int_as_float(0x7f800000);
  int s = 0;
  for (int rb = 0; rb < nrb; ++rb) {
    const int tl0 = rb * kAttnThreads + warp * 32 + g;  // + 8 i
    long long tpos[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = base + tl0 + 8 * i;
      tpos[i] = t == slot ? p : tl0 + 8 * i < nt ? (long long)sp[t] : -1;
    }
    const bool busy = rb * kAttnThreads + warp * 32 < nt && heads;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = 0.0f;
    for (int cc = 0; cc < S::NCC; ++cc, ++s) {
      arrive(s);
      if (timed && s == 0) clk[1] = clock64();
      if (busy) {
        const uint4* kr = ring + (s % ns) * SCH + (warp * 32 + g) * 4;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float kf[4][S::EL];
#pragma unroll
          for (int i4 = 0; i4 < 4; ++i4) {
            const uint4 w4 = kr[i4 * 32 + (c ^ sw)];
            const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
            unpack(w, kf[i4], S::EL, C());
#pragma unroll
            for (int e = 0; e < S::EL; ++e)
              kf[i4][e] = as_compute<T, C>(kf[i4][e]);
          }
          const float* qd = qs + (cc * WEL + c * S::EL) * rp + h4;
#pragma unroll
          for (int e = 0; e < S::EL; ++e) {
            const float4 q4 = *reinterpret_cast<const float4*>(qd + e * rp);
            const float qf[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
            for (int i4 = 0; i4 < 4; ++i4)
#pragma unroll
              for (int u = 0; u < 4; ++u)
                acc[i4][u] = __fmaf_rn(qf[u], kf[i4][e], acc[i4][u]);
          }
        }
      }
    }
    if (heads) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tl = tl0 + 8 * i;
        if (tl < nt) {
          const bool valid = tpos[i] >= 0 && tpos[i] <= p &&
                             (a.window <= 0 || tpos[i] > p - a.window);
          float num[4], sc[4];
          bool slow = false;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            num[u] = round_to<T>(acc[i][u]);
            sc[u] = div_rn(num[u], a.scale, a.inv_scale, slow);
          }
          if (slow) {
#pragma unroll
            for (int u = 0; u < 4; ++u) sc[u] = __fdiv_rn(num[u], a.scale);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            sc[u] = valid ? round_to<T>(sc[u]) : neg_inf;
            rmax[u] = nan_max(rmax[u], sc[u]);
          }
          store4(ps + tl * rps + h4, sc);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      rmax[u] = nan_max(rmax[u], __shfl_xor_sync(0xffffffffu, rmax[u], off));
  }
  if (g == 0 && heads) {
#pragma unroll
    for (int u = 0; u < 4; ++u) red[0][warp * kMaxGroup + h4 + u] = rmax[u];
  }
  __syncthreads();                      // ps, the warps' maxima
  if (tid < rp) {
    float m = red[0][tid];
    for (int w = 1; w < kAttnWarps; ++w)
      m = nan_max(m, red[0][w * kMaxGroup + tid]);
    cmax[tid] = m;
  }
  if (timed) {
    clk[2] = clock64();
    clk[9] = waited;                    // of the scores' phase
    waited = 0;
  }
  split_arrive();                       // cmax (and: every CTA has started)
  const long long b0 = timed ? clock64() : 0;
  split_wait();
  if (timed) clk[11] = clock64() - b0;
  // thread (h, q) reads rank q's maximum of head h, all at once; thread h
  // takes the maximum of the nc values
  if (tid < rp * nc)
    peer[tid] = *cluster.map_shared_rank(&cmax[tid / nc], tid % nc);
  __syncthreads();
  if (tid < rp) {
    float v = peer[tid * nc];
    for (int qq = 1; qq < nc; ++qq) v = nan_max(v, peer[tid * nc + qq]);
    gmax[tid] = v;
  }
  __syncthreads();                      // gmax
  if (timed) clk[3] = clock64();

  // 4: the f32 softmax over this CTA's rows, then the cluster's sum; the
  // terms of a thread's first row kept for the probabilities, the others'
  // computed again
  float sum[kMaxGroup], e0[kMaxGroup];
#pragma unroll
  for (int j = 0; j < kMaxGroup; ++j) sum[j] = 0.0f;
  for (int tl = tid; tl < nt; tl += kAttnThreads) {
#pragma unroll
    for (int j = 0; j < kMaxGroup; j += 4) {
      if (j < rp) {
        float sc[4];
        load_f32<T, 4>(ps + tl * rps + j, sc);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float e = exp_xla(__fsub_rn(sc[u], gmax[j + u]));
          if (tl == tid) e0[j + u] = e;
          sum[j + u] = __fadd_rn(sum[j + u], e);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxGroup; ++j) {
    if (j < rp) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum[j] = __fadd_rn(sum[j], __shfl_xor_sync(0xffffffffu, sum[j], off));
      if (ln == 0) red[1][warp * kMaxGroup + j] = sum[j];
    }
  }
  __syncthreads();                      // the warps' sums
  if (timed) clk[4] = clock64();
  if (tid < rp) {
    float v = 0.0f;
    for (int w = 0; w < kAttnWarps; ++w)
      v = __fadd_rn(v, red[1][w * kMaxGroup + tid]);
    csum[tid] = v;
  }
  split_arrive();                       // csum
  const long long b1 = timed ? clock64() : 0;
  split_wait();
  if (timed) clk[12] = clock64() - b1;
  // the sums read as the maxima were, then added in rank order
  if (tid < rp * nc)
    peer[tid] = *cluster.map_shared_rank(&csum[tid / nc], tid % nc);
  __syncthreads();
  if (tid < rp) {
    float v = peer[tid * nc];
    for (int qq = 1; qq < nc; ++qq) v = __fadd_rn(v, peer[tid * nc + qq]);
    gsum[tid] = v;
    grcp[tid] = __frcp_rn(v);
  }
  __syncthreads();                      // gsum
  if (timed) clk[5] = clock64();
  for (int tl = tid; tl < nt; tl += kAttnThreads) {
#pragma unroll
    for (int j = 0; j < kMaxGroup; j += 4) {
      if (j < rp) {
        float e[4], pt[4];
        load_f32<T, 4>(ps + tl * rps + j, e);
        bool slow = false;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          e[u] = tl == tid ? e0[j + u]
                           : exp_xla(__fsub_rn(e[u], gmax[j + u]));
          pt[u] = div_rn(e[u], gsum[j + u], grcp[j + u], slow);
        }
        if (slow) {
#pragma unroll
          for (int u = 0; u < 4; ++u) pt[u] = __fdiv_rn(e[u], gsum[j + u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) pt[u] = round_to<T>(pt[u]);
        store4(pf + tl * rps + j, pt);
      }
    }
  }
  if (timed) clk[6] = clock64();

  // 5: P.V, V stage by V stage (the first one's barrier also makes the
  // probabilities visible): thread (head block, column group) over heads
  // h0 ... h0 + HO - 1 and columns 4 cg ... 4 cg + 3
  const int cg4 = tid % S::NCG * 4, h0 = tid / S::NCG * S::HO;
  const bool pv = h0 < r;
  float acc[S::HO][4];
#pragma unroll
  for (int u = 0; u < S::HO; ++u)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[u][k] = 0.0f;
  for (int j = 0; s < n; ++j, ++s) {
    arrive(s);
    if (pv) {
      const int rows = min(S::RV, nt - j * S::RV);
      const C* vrow = reinterpret_cast<const C*>(ring + (s % ns) * SCH) + cg4;
      const float* prow = pf + (long long)j * S::RV * rps + h0;
      for (int x = 0; x < rows; ++x) {
        float pt[S::HO], vf[4];
        load_n<S::HO>(prow, pt);
        load_f32<C, 4>(vrow, vf);
#pragma unroll
        for (int k = 0; k < 4; ++k) vf[k] = as_compute<T, C>(vf[k]);
#pragma unroll
        for (int u = 0; u < S::HO; ++u)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[u][k] = __fmaf_rn(pt[u], vf[k], acc[u][k]);
        vrow += HD;
        prow += rps;
      }
    }
  }
  __syncthreads();                      // the ring is read: part in its place
  if (pv) {
#pragma unroll
    for (int u = 0; u < S::HO; ++u)
      if (h0 + u < r) store4(part + (h0 + u) * HD + cg4, acc[u]);
  }
  if (timed) {
    clk[7] = clock64();
    clk[10] = waited;                    // of P.V's
  }
  split_arrive();                       // part
  split_wait();
  // this CTA's slice of the outputs: the CTAs' sums in rank order
  const int n_out = r * HD;
  const int per = ((n_out + nc - 1) / nc + 3) / 4 * 4;
  T* out = static_cast<T*>(a.out) +
           ((long long)lane * a.heads + kvh * r) * HD;
  for (int i = rank * per + 4 * tid; i < min(n_out, (rank + 1) * per);
       i += 4 * kAttnThreads) {
    // every rank's 4 sums read at once, then added in rank order
    float4 u[kMaxCluster];
#pragma unroll
    for (int qq = 0; qq < kMaxCluster; ++qq)
      if (qq < nc)
        u[qq] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part + i, qq));
    float4 v = u[0];
#pragma unroll
    for (int qq = 1; qq < kMaxCluster; ++qq) {
      if (qq < nc) {
        v.x = __fadd_rn(v.x, u[qq].x);
        v.y = __fadd_rn(v.y, u[qq].y);
        v.z = __fadd_rn(v.z, u[qq].z);
        v.w = __fadd_rn(v.w, u[qq].w);
      }
    }
    out[i] = from_f<T>(v.x);
    out[i + 1] = from_f<T>(v.y);
    out[i + 2] = from_f<T>(v.z);
    out[i + 3] = from_f<T>(v.w);
  }
  if (timed) clk[8] = clock64();
  if (stamp) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(cta[1]));
  split_arrive();                       // no CTA leaves while read
  split_wait();
}

// km, vm: the caches' tensor maps (split_maps)
template <typename T, typename C, int HD>
__global__ void __launch_bounds__(kAttnThreads, 2)
decode_attention_split_kernel(const __grid_constant__ DecodeArgs a,
                              const int nc, const int ts, const int ns,
                              const __grid_constant__ CUtensorMap km,
                              const __grid_constant__ CUtensorMap vm) {
  split_body<T, C, HD, false>(a, nc, ts, ns, &km, &vm, nullptr);
}

// the same with its phase clocks (chip_smoke.py)
template <typename T, typename C, int HD>
__global__ void __launch_bounds__(kAttnThreads, 2)
decode_attention_split_timed(const __grid_constant__ DecodeArgs a,
                             const int nc, const int ts, const int ns,
                             const __grid_constant__ CUtensorMap km,
                             const __grid_constant__ CUtensorMap vm,
                             long long* const clk) {
  split_body<T, C, HD, true>(a, nc, ts, ns, &km, &vm, clk);
}

template <typename T, typename C, int HD, bool kTimed>
const void* split_kernel() {
  if constexpr (kTimed)
    return (const void*)decode_attention_split_timed<T, C, HD>;
  else
    return (const void*)decode_attention_split_kernel<T, C, HD>;
}

// the split form's launch configuration: a cluster of nc CTAs a (lane, KV
// head), the ring's ns stages, the kernel's dynamic shared memory allowed
// once a size
template <typename T, typename C, int HD, bool kTimed>
int split_config(const DecodeArgs& a, long long lanes, int nc, int ts,
                 cudaStream_t stream, cudaLaunchConfig_t& cfg,
                 cudaLaunchAttribute* attr, int& ns) {
  ns = split_stages(a.heads / a.kv, HD, ts, (int)sizeof(T));
  const long long smem = (long long)ns * kStageBytes +
                         split_rest(a.heads / a.kv, HD, ts, (int)sizeof(T));
  if (ns < 2 || smem > kSplitMaxSmem) return (int)cudaErrorInvalidValue;
  static long long allowed = 48 * 1024;  // raised once a size
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel<T, C, HD, kTimed>(),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  cfg = {};
  cfg.gridDim = dim3((unsigned)(lanes * a.kv * nc), 1, 1);
  cfg.blockDim = dim3(kAttnThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return 0;
}

// the caches' tensor maps: K (lanes, slots, kv, HD) read in boxes of 64
// bytes by 256 rows, swizzled by 64 bytes; V as (lanes, slots, kv, HD /
// H0, H0), H0 = min(HD, 256) (a box dimension's limit), in boxes of RV
// whole rows
template <typename C, int HD>
int split_maps(const DecodeArgs& a, long long lanes, CUtensorMap& km,
               CUtensorMap& vm) {
  using S = SplitShape<HD, C>;
  constexpr int H0 = HD < 256 ? HD : 256;
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled",
                                     (void**)&encode, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", (void**)&encode,
                            cudaEnableDefault, &found);
#endif
    if (!encode) return (int)cudaErrorNotSupported;
  }
  const CUtensorMapDataType type = sizeof(C) == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t es = sizeof(C), kv = a.kv, slots = a.slots;
  const cuuint64_t kdims[4] = {HD, kv, slots, (cuuint64_t)lanes};
  const cuuint64_t kstrides[3] = {HD * es, kv * HD * es, slots * kv * HD * es};
  const cuuint32_t kbox[4] = {64 / (cuuint32_t)es, 1, kAttnThreads, 1};
  const cuuint64_t vdims[5] = {H0, HD / H0, kv, slots, (cuuint64_t)lanes};
  const cuuint64_t vstrides[4] = {H0 * es, HD * es, kv * HD * es,
                                  slots * kv * HD * es};
  const cuuint32_t vbox[5] = {H0, HD / H0, 1, S::RV, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  if (encode(&km, type, 4, a.k_cache, kdims, kstrides, kbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&vm, type, 5, a.v_cache, vdims, vstrides, vbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// the split form's launch, timed where clk is not null (the timed kernel
// is built for bf16 at head dim 256 alone, recurrentgemma-9b's layer that
// chip_smoke.py reads)
struct SplitLaunch {
  const DecodeArgs& a;
  long long lanes;
  int nc, ts;
  cudaStream_t stream;
  long long* clk;
  template <typename T, typename C, int HD>
  int run() const {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    CUtensorMap km, vm;
    int ns;
    int rc = split_maps<C, HD>(a, lanes, km, vm);
    if (rc) return rc;
    cudaError_t err;
    if (clk) {
      constexpr bool kClocked = std::is_same_v<T, __nv_bfloat16> &&
                                std::is_same_v<C, __nv_bfloat16> && HD == 256;
      if constexpr (kClocked) {
        rc = split_config<T, C, HD, true>(a, lanes, nc, ts, stream, cfg,
                                          attr, ns);
        if (rc) return rc;
        err = cudaLaunchKernelEx(&cfg,
                                 decode_attention_split_timed<T, C, HD>, a,
                                 nc, ts, ns, km, vm, clk);
      } else {
        return (int)cudaErrorInvalidValue;
      }
    } else {
      rc = split_config<T, C, HD, false>(a, lanes, nc, ts, stream, cfg, attr,
                                         ns);
      if (rc) return rc;
      err = cudaLaunchKernelEx(&cfg, decode_attention_split_kernel<T, C, HD>,
                               a, nc, ts, ns, km, vm);
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
};

// how many of the split form's clusters the card runs at once
struct SplitOccupancy {
  const DecodeArgs& a;
  long long lanes;
  int nc, ts;
  int* clusters;
  template <typename T, typename C, int HD>
  int run() const {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    int ns;
    const int rc = split_config<T, C, HD, false>(a, lanes, nc, ts, nullptr,
                                                 cfg, attr, ns);
    if (rc) return rc;
    return (int)cudaOccupancyMaxActiveClusters(
        clusters, split_kernel<T, C, HD, false>(), &cfg);
  }
};

// a split job over its instantiation: rows of 4 to 64 chunks of 16 bytes
template <typename J, typename T, typename C>
int split_hd(const J& job, int hd) {
  constexpr int E = 16 / (int)sizeof(C);
  switch (hd / E) {
    case 4: return job.template run<T, C, 4 * E>();
    case 8: return job.template run<T, C, 8 * E>();
    case 16: return job.template run<T, C, 16 * E>();
    case 32: return job.template run<T, C, 32 * E>();
    case 64: return job.template run<T, C, 64 * E>();
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename J>
int split_job(const J& job, int hd, int compute_bf16, int cache_bf16) {
  if (compute_bf16)
    return cache_bf16 ? split_hd<J, __nv_bfloat16, __nv_bfloat16>(job, hd)
                      : split_hd<J, __nv_bfloat16, float>(job, hd);
  return cache_bf16 ? split_hd<J, float, __nv_bfloat16>(job, hd)
                    : split_hd<J, float, float>(job, hd);
}

// the shapes a launch takes (see repro_decode_attention)
inline bool bad_shapes(long long lanes, int batch, int heads, int kv, int hd,
                       int slots, int window, int cache_bf16, int cluster,
                       int tile) {
  const int e = cache_bf16 ? 8 : 4, tpr = hd / e;
  const int max_tpr = cluster ? 64 : 32;
  return lanes < 1 || batch < 1 || lanes % batch || kv < 1 || heads % kv ||
         heads / kv > kMaxGroup || hd < 1 || hd % e || tpr < 4 ||
         tpr > max_tpr || (tpr & (tpr - 1)) || slots < 1 || window < 0 ||
         lanes * kv * (cluster ? cluster : 1) > 0x7fffffffLL ||
         (cluster && (cluster > kMaxCluster || (cluster & (cluster - 1)) ||
                      tile < 1 || (long long)tile * cluster < slots));
}

}  // namespace repro_torch

// One launch for every lane: q (lanes, heads, hd), k_new and v_new (lanes,
// kv, hd) in the compute dtype (bf16 if compute_bf16, else f32); the caches
// (lanes, slots, kv, hd) in the cache dtype (bf16 if cache_bf16, else f32)
// and slot_pos (lanes, slots) int32, updated in place; pos (batch,) int64,
// lane l at pos[l % batch]; out (lanes, heads, hd) in the compute dtype.
// heads is a multiple of kv, heads / kv <= 16; hd is 16 bytes of the cache
// dtype times 4, 8, 16 or 32 (head dims 32, 64 and 128), or 64 in the
// split form; the caches and the new rows are 16-byte aligned; scale is
// sqrt(hd) in the compute dtype and inv_scale RN(1 / scale). cluster: 0
// for the one-CTA form, else the split form's CTAs a (lane, KV head), a
// power of two up to 8, each over tile slots (decode_attention.py:
// split_of).
extern "C" int repro_decode_attention(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, int* slot_pos, const long long* pos, void* out,
    long long lanes, int batch, int heads, int kv, int hd, int slots,
    int window, float scale, float inv_scale, int compute_bf16,
    int cache_bf16, int cluster, int tile, void* stream) {
  using namespace repro_torch;
  if (bad_shapes(lanes, batch, heads, kv, hd, slots, window, cache_bf16,
                 cluster, tile))
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{q, k_new, v_new, k_cache, v_cache, slot_pos, pos, out,
                     batch, heads, kv, hd, slots, window, scale, inv_scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (cluster)
    return split_job(SplitLaunch{a, lanes, cluster, tile, st, nullptr}, hd,
                     compute_bf16, cache_bf16);
  if (compute_bf16) {
    return cache_bf16 ? launch_tpr<__nv_bfloat16, __nv_bfloat16>(a, lanes, st)
                      : launch_tpr<__nv_bfloat16, float>(a, lanes, st);
  }
  return cache_bf16 ? launch_tpr<float, __nv_bfloat16>(a, lanes, st)
                    : launch_tpr<float, float>(a, lanes, st);
}

// The split form's launch as repro_decode_attention's (cluster > 0, bf16
// compute and cache, hd 256), with its phase clocks: clocks, 13 int64 that the first CTA's thread 0 fills
// with clock64() at its phases' ends (start, first K stage landed, scores,
// maxima exchanged, its sums, sums exchanged, probabilities, P.V, rank
// sums), then with the cycles it waited for stages in the scores and in
// P.V and in the cluster barriers after the maxima and the sums; then 3 a
// CTA: its globaltimer at its start and before its last barrier, its SM.
extern "C" int repro_decode_attention_clocks(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, int* slot_pos, const long long* pos, void* out,
    long long lanes, int batch, int heads, int kv, int hd, int slots,
    int window, float scale, float inv_scale, int compute_bf16,
    int cache_bf16, int cluster, int tile, void* clocks, void* stream) {
  using namespace repro_torch;
  if (!cluster || !clocks ||
      bad_shapes(lanes, batch, heads, kv, hd, slots, window, cache_bf16,
                 cluster, tile))
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{q, k_new, v_new, k_cache, v_cache, slot_pos, pos, out,
                     batch, heads, kv, hd, slots, window, scale, inv_scale};
  return split_job(SplitLaunch{a, lanes, cluster, tile, (cudaStream_t)stream,
                               static_cast<long long*>(clocks)},
                   hd, compute_bf16, cache_bf16);
}

// cudaOccupancyMaxActiveClusters of the split form's launch over lanes
// lanes of these shapes (cluster CTAs of tile slots) into *clusters; no
// launch
extern "C" int repro_decode_attention_clusters(
    long long lanes, int heads, int kv, int hd, int slots, int compute_bf16,
    int cache_bf16, int cluster, int tile, int* clusters) {
  using namespace repro_torch;
  if (!cluster || bad_shapes(lanes, 1, heads, kv, hd, slots, 0, cache_bf16,
                             cluster, tile))
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, 1, heads, kv, hd, slots, 0, 1.0f,
                     1.0f};
  return split_job(SplitOccupancy{a, lanes, cluster, tile, clusters}, hd,
                   compute_bf16, cache_bf16);
}
