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
//   4. takes the f32 softmax over the rows and rounds the probabilities to
//      the compute dtype;
//   5. sums the probability-weighted value rows and rounds to the compute
//      dtype.
//
// That is the reference's rounding order. Its two dot products sum exact
// products: a product of two bfloat16 values, or of two f32 values, is
// exact in double, so the kernel sums them in double and rounds the sum to
// f32, then to the compute dtype. The plain version
// (decode_attention.py) sums the same exact products in double in another
// order; the two round to the same f32 unless a double rounding error of
// the sum lands on an f32 tie, about 2^-29 a value. exp is taken in double
// and rounded to f32, the probabilities' sum in double likewise.
//
// Design: 8 warps a CTA, the group's queries in shared memory as doubles.
// The cache rows pass through shared memory in tiles of 64 (read
// coalesced, cast to the compute dtype and to double once, rows padded to
// head_dim + 1 so that threads on consecutive rows take distinct banks): a
// thread scores one (head, row) pair of a tile, one warp a head takes the
// softmax over the row scores, then each thread sums its (head, dim)
// outputs over the value tiles in row order. Its first form, a warp a row
// reading the cache from global memory and a thread an output looping over
// 128 dependent global loads, took 0.082 ms a layer at 32 lanes; a second,
// tiles of floats converted to double in the inner loops with 4 warps a
// CTA, 0.025 ms; this one 0.0156 ms, and splitting each dot product over
// 4 lanes joined by shuffles made it slower, 0.0234 ms (chip_smoke.py on
// an NVIDIA H100 80GB HBM3 at 700 W). What bounds it: the lanes' K and V
// bytes, about 3.3 MB a layer at 32 lanes of smollm-135m, so about 1 µs,
// the launch floor.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kMaxGroup = 16;        // decode_attention.py: MAX_GROUP
constexpr int kTile = 64;            // cache rows staged a pass
constexpr int kMaxOut = 8;           // outputs a thread: r * hd <= 2048

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
};

template <typename T, typename C>
__global__ void __launch_bounds__(kAttnThreads)
decode_attention_kernel(const __grid_constant__ DecodeArgs a) {
  extern __shared__ double smem[];
  const long long lane = blockIdx.x / a.kv;
  const int kvh = blockIdx.x % a.kv;
  const int r = a.heads / a.kv, hd = a.hd, slots = a.slots, kv = a.kv;
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  const int pitch = hd + 1;             // a tile row, padded: no conflicts
  const long long p = a.pos[lane % a.batch];
  const int slot = a.window > 0 ? (int)(p % slots)
                                : (int)(p < slots - 1 ? p : slots - 1);
  double* qs = smem;                    // (r, hd)
  double* tile = qs + r * hd;           // (kTile, hd + 1): K, then V rows
  float* ss = reinterpret_cast<float*>(tile + kTile * pitch);  // (r, slots)

  const T* q = static_cast<const T*>(a.q) + (lane * a.heads + kvh * r) * hd;
  for (int i = tid; i < r * hd; i += kAttnThreads)
    qs[i] = (double)to_f(q[i]);
  C* kc = static_cast<C*>(a.k_cache) + lane * slots * kv * hd + kvh * hd;
  C* vc = static_cast<C*>(a.v_cache) + lane * slots * kv * hd + kvh * hd;
  const long long row = (long long)kv * hd;     // a cache row's stride
  const T* kn = static_cast<const T*>(a.k_new) + (lane * kv + kvh) * hd;
  const T* vn = static_cast<const T*>(a.v_new) + (lane * kv + kvh) * hd;
  for (int i = tid; i < hd; i += kAttnThreads) {
    kc[slot * row + i] = from_f<C>(to_f(kn[i]));
    vc[slot * row + i] = from_f<C>(to_f(vn[i]));
  }
  int* sp = a.slot_pos + lane * slots;
  if (kvh == 0 && tid == 0) sp[slot] = (int)p;
  __syncthreads();     // the new rows are visible to the whole CTA

  // 2-3: the scores, a tile of rows at a time: the rows (cast to the
  // compute dtype, held as doubles) staged in shared memory, then a
  // (head, row) pair a thread
  const float neg_inf = round_to<T>(-1e30f);
  for (int t0 = 0; t0 < slots; t0 += kTile) {
    const int rows = min(kTile, slots - t0);
    for (int i = tid; i < rows * hd; i += kAttnThreads) {
      const int t = i / hd, k = i - t * hd;
      tile[t * pitch + k] =
          (double)round_to<T>(to_f(kc[(t0 + t) * row + k]));
    }
    __syncthreads();
    for (int w = tid; w < r * rows; w += kAttnThreads) {
      const int j = w / rows, t = w - j * rows;
      const double* qj = qs + j * hd;
      const double* kt = tile + t * pitch;
      double acc = 0.0;
#pragma unroll 8
      for (int k = 0; k < hd; ++k) acc = fma(qj[k], kt[k], acc);
      // the slot written above holds p; the other CTAs of this lane may
      // be writing slot_pos[slot] now, so it is not read
      const long long tp = t0 + t == slot ? p : (long long)sp[t0 + t];
      const bool valid = tp >= 0 && tp <= p && (a.window <= 0 ||
                                                tp > p - a.window);
      const float s = round_to<T>(__fdiv_rn(round_to<T>((float)acc),
                                            a.scale));
      ss[j * slots + t0 + t] = valid ? s : neg_inf;
    }
    __syncthreads();
  }

  // 4: the f32 softmax of each head's row scores, one warp a head
  for (int j = warp; j < r; j += kAttnWarps) {
    float* sj = ss + j * slots;
    float m = -__int_as_float(0x7f800000);
    for (int t = ln; t < slots; t += 32) m = nan_max(m, sj[t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    double sum = 0.0;
    for (int t = ln; t < slots; t += 32) {
      const float e = (float)exp((double)__fsub_rn(sj[t], m));
      sj[t] = e;
      sum += (double)e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float tot = (float)sum;
    for (int t = ln; t < slots; t += 32)
      sj[t] = round_to<T>(__fdiv_rn(sj[t], tot));
  }
  __syncthreads();

  // 5: the probability-weighted value rows, a tile of rows at a time, each
  // thread summing its (head, dim) outputs over the rows in order
  double acc[kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) acc[o] = 0.0;
  for (int t0 = 0; t0 < slots; t0 += kTile) {
    const int rows = min(kTile, slots - t0);
    for (int i = tid; i < rows * hd; i += kAttnThreads) {
      const int t = i / hd, k = i - t * hd;
      tile[t * pitch + k] =
          (double)round_to<T>(to_f(vc[(t0 + t) * row + k]));
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      const int i = tid + o * kAttnThreads;
      if (i < r * hd) {
        const int j = i / hd, k = i - j * hd;
        const float* pj = ss + j * slots + t0;
#pragma unroll 8
        for (int t = 0; t < rows; ++t)
          acc[o] = fma((double)pj[t], tile[t * pitch + k], acc[o]);
      }
    }
    __syncthreads();
  }
  T* out = static_cast<T*>(a.out) + (lane * a.heads + kvh * r) * hd;
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) {
    const int i = tid + o * kAttnThreads;
    if (i < r * hd) out[i] = from_f<T>((float)acc[o]);
  }
}

template <typename T, typename C>
int launch(const DecodeArgs& a, long long lanes, cudaStream_t stream) {
  const int r = a.heads / a.kv;
  const size_t smem = sizeof(double) * ((size_t)r * a.hd +
                                        (size_t)kTile * (a.hd + 1)) +
                      sizeof(float) * (size_t)r * a.slots;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_attention_kernel<T, C><<<(unsigned)(lanes * a.kv), kAttnThreads,
                                  smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// One launch for every lane: q (lanes, heads, hd), k_new and v_new (lanes,
// kv, hd) in the compute dtype (bf16 if compute_bf16, else f32); the caches
// (lanes, slots, kv, hd) in the cache dtype (bf16 if cache_bf16, else f32)
// and slot_pos (lanes, slots) int32, updated in place; pos (batch,) int64,
// lane l at pos[l % batch]; out (lanes, heads, hd) in the compute dtype.
// heads is a multiple of kv, heads / kv <= 16; scale is sqrt(hd) in the
// compute dtype.
extern "C" int repro_decode_attention(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, int* slot_pos, const long long* pos, void* out,
    long long lanes, int batch, int heads, int kv, int hd, int slots,
    int window, float scale, int compute_bf16, int cache_bf16, void* stream) {
  using namespace repro_torch;
  if (lanes < 1 || batch < 1 || lanes % batch || kv < 1 || heads % kv ||
      heads / kv > kMaxGroup || hd < 1 || (heads / kv) * hd >
      kMaxOut * kAttnThreads || slots < 1 || window < 0 ||
      lanes * kv > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{q, k_new, v_new, k_cache, v_cache, slot_pos, pos, out,
                     batch, heads, kv, hd, slots, window, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (compute_bf16) {
    return cache_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, lanes, st)
                      : launch<__nv_bfloat16, float>(a, lanes, st);
  }
  return cache_bf16 ? launch<float, __nv_bfloat16>(a, lanes, st)
                    : launch<float, float>(a, lanes, st);
}
