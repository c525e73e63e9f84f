// The gossip mixers' fma chain over the node axis for Hopper (sm_90a).
//
// Replaces no pl.pallas_call: the reference mixes in jnp, inside its jitted
// rounds (ROADMAP C16): schedule_mix's matchings and _roll_mix's shifts
// (src/repro/core/gossip.py:158-197) and the back-compat ring_mix (:80-90).
// Row k of a (K, n) leaf x becomes, over M terms m with source row
// src[m][k] and weight w[m][k]:
//   Laplacian (the schedule mixer): a = x[k];       a = fma(w, x[src] − x[k], a)
//   circulant (the roll mixer):     a = c0 · x[k];  a = fma(w, x[src], a)
//   ring (ring_mix, M = 2):         a = fma(c0, x[k], w[0][k]·(x[src0] + x[src1]))
// which is how XLA's CPU code contracts `out + w·(x[perm] − x)`,
// `Σ_s c_s·roll(x, −s)` and `ω₀₀·x + ω₀₁·(roll(x, 1) + roll(x, −1))`, term
// by term in that order with __fmaf_rn, __fsub_rn, __fadd_rn and __fmul_rn
// (the build passes --fmad=false besides). The weights are read from device
// memory, so a time-varying round's masked weights never leave the card.
//
// What bounds it on an H100: bytes. Each element is read once and written
// once, 2·K·N·4 bytes a round over the N columns of all leaves, at 3.35 TB/s;
// 2M + 1 flops an element are nothing beside them. The first design, one CTA
// row a node row k, read x[src[m][k]] from device memory again for every
// term: M + 1 reads an element, and at K = 10 fc1.w alone (103 MB)
// outgrows the 50 MB L2, so it ran at 20% of the bound, one launch a leaf.
// What this design does about that: one launch mixes a table of up to
// kMaxLeaves leaves. A CTA takes a tile of T columns of one leaf for all K
// rows, stages the K x T tile in shared memory with cp.async (16 bytes a
// thread where the leaf's rows are 16-byte aligned, else 4), beside the
// (M, K) sources and weights, and every output of the tile is then made from
// shared memory and written once (float4 stores on aligned leaves). T is the
// widest multiple of 32 columns, at most 1024, whose tile and terms fit
// 48 KB, so no launch needs the opt-in shared-memory attribute (the scan
// engine captures the round as a CUDA graph) and 5 CTAs an SM keep some
// 200 KB of loads in flight at K = 10. Where not even 32 columns fit (K
// above about 380 at 7 terms), the row kernel, picked by shape, reads each
// term from device memory as the first design did. On "NVIDIA H100 80GB
// HBM3, 700.00 W": 0.0800 ms a round over the 10 full-width leaves at K = 10
// and 7 matchings, 78% of the 0.0621 ms bound (PERF.md §6, chip_smoke.py).
#include "pack_tile.cuh"

namespace repro_torch {

constexpr int kMixThreads = 256;
constexpr long long kMaxTile = 1024;       // columns a CTA stages
constexpr long long kMixSmem = 48 * 1024;  // bytes of dynamic shared memory

constexpr int kLaplacian = 0, kCirculant = 1, kRing = 2;   // the forms

// Leaf l of a table: its (K, n) input and output, and the first tile (or
// row-kernel chunk) of the launch that is its. vec: both start 16-byte
// aligned and n % 4 == 0, so each row is staged and stored as float4.
struct MixLeaf {
  const float* x;
  float* out;
  long long n, begin;
  int vec;
};

struct MixTable {
  MixLeaf leaf[kMaxLeaves];
  int count;
};

__device__ __forceinline__ float vfma(float w, float p, float a) {
  return __fmaf_rn(w, p, a);
}
__device__ __forceinline__ float4 vfma(float w, float4 p, float4 a) {
  return make_float4(__fmaf_rn(w, p.x, a.x), __fmaf_rn(w, p.y, a.y),
                     __fmaf_rn(w, p.z, a.z), __fmaf_rn(w, p.w, a.w));
}
__device__ __forceinline__ float vsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float4 vsub(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                     __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
}
__device__ __forceinline__ float vadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float vmul(float c, float a) {
  return __fmul_rn(c, a);
}
__device__ __forceinline__ float4 vmul(float c, float4 a) {
  return make_float4(__fmul_rn(c, a.x), __fmul_rn(c, a.y), __fmul_rn(c, a.z),
                     __fmul_rn(c, a.w));
}

// Output row k of one column (or four): col[r * stride] is row r of it,
// src and w the (M, K) sources and weights, row-major.
template <int F, class V, class S>
__device__ __forceinline__ V chain(const V* col, S stride,
                                   const int* src, const float* w, int terms,
                                   int rows, int k, float c0) {
  const V xk = col[k * stride];
  if (F == kRing)
    return vfma(c0, xk, vmul(w[k], vadd(col[src[k] * stride],
                                        col[src[rows + k] * stride])));
  V a = F == kLaplacian ? xk : vmul(c0, xk);
  for (int m = 0; m < terms; ++m) {
    const V p = col[src[m * rows + k] * stride];
    a = vfma(w[m * rows + k], F == kLaplacian ? vsub(p, xk) : p, a);
  }
  return a;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ int find_leaf(const MixTable& table,
                                         long long unit) {
  int l = 0;
  while (l + 1 < table.count && unit >= table.leaf[l + 1].begin) ++l;
  return l;
}

// CTA t mixes tile t of the table: `tile` columns of one leaf, all rows.
// Shared memory: the rows x tile values, then the (M, K) weights and
// sources.
template <int F>
__global__ void __launch_bounds__(kMixThreads)
gossip_mix_tiles(const __grid_constant__ MixTable table,
                 const int* __restrict__ src, const float* __restrict__ w,
                 int rows, int terms, int tile, float c0) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws = xs + (long long)rows * tile;
  int* ss = reinterpret_cast<int*>(ws + terms * rows);

  const MixLeaf& leaf = table.leaf[find_leaf(table, blockIdx.x)];
  const long long n = leaf.n;
  const long long first = (blockIdx.x - leaf.begin) * tile;
  const int width = (int)min((long long)tile, n - first);
  const float* x = leaf.x + first;
  float* out = leaf.out + first;

  for (int i = threadIdx.x; i < terms * rows; i += kMixThreads) {
    ws[i] = w[i];
    ss[i] = src[i];
  }
  if (leaf.vec) {                                 // uniform within the CTA
    const int w4 = width / 4, t4 = tile / 4;
    for (int i = threadIdx.x; i < rows * w4; i += kMixThreads) {
      const int r = i / w4, g = i - r * w4;
      cp_async16(smem4 + r * t4 + g, x + r * n + 4 * g);
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += kMixThreads) {
      const int r = i / width, c = i - r * width;
      cp_async4(xs + r * tile + c, x + r * n + c);
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::);
  __syncthreads();

  if (leaf.vec) {
    const int w4 = width / 4, t4 = tile / 4;
    for (int i = threadIdx.x; i < rows * w4; i += kMixThreads) {
      const int k = i / w4, g = i - k * w4;
      reinterpret_cast<float4*>(out + k * n)[g] =
          chain<F>(smem4 + g, t4, ss, ws, terms, rows, k, c0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += kMixThreads) {
      const int k = i / width, c = i - k * width;
      out[k * n + c] = chain<F>(xs + c, tile, ss, ws, terms, rows, k, c0);
    }
  }
}

// The row kernel, for K whose 32-column tile does not fit: CTA (t, k) makes
// row k of kMixThreads columns (chunk t of the table), reading every term
// from device memory.
template <int F>
__global__ void __launch_bounds__(kMixThreads)
gossip_mix_rows(const __grid_constant__ MixTable table,
                const int* __restrict__ src, const float* __restrict__ w,
                int rows, int terms, float c0) {
  const MixLeaf& leaf = table.leaf[find_leaf(table, blockIdx.x)];
  const long long i =
      (blockIdx.x - leaf.begin) * kMixThreads + threadIdx.x;
  if (i >= leaf.n) return;
  const int k = blockIdx.y;
  leaf.out[k * leaf.n + i] =
      chain<F>(leaf.x + i, leaf.n, src, w, terms, rows, k, c0);
}

template <int F>
void launch_form(const MixTable& table, long long units, bool staged,
                 const int* src, const float* w, int rows, int terms,
                 int tile, float c0, cudaStream_t st) {
  if (staged) {
    const size_t bytes = 4 * ((size_t)rows * tile + 2 * (size_t)terms * rows);
    gossip_mix_tiles<F><<<(unsigned)units, kMixThreads, bytes, st>>>(
        table, src, w, rows, terms, tile, c0);
  } else {
    gossip_mix_rows<F><<<dim3((unsigned)units, (unsigned)rows), kMixThreads,
                         0, st>>>(table, src, w, rows, terms, c0);
  }
}

}  // namespace repro_torch

// One launch mixes `count` <= kMaxLeaves leaves of `rows` rows each: leaf l
// is xs[l], (rows, ns[l]) f32, into outs[l]; src (int32) and w (f32) are the
// (terms, rows) sources and weights on the device; form is kLaplacian,
// kCirculant or kRing (terms == 2). The sources must lie in [0, rows).
extern "C" int repro_gossip_mix(const float* const* xs, float* const* outs,
                                const long long* ns, int count,
                                long long rows, const int* src,
                                const float* w, int terms, int form,
                                float c0, void* stream) {
  using namespace repro_torch;
  if (count < 1 || count > kMaxLeaves || rows < 0 || rows > 65535 ||
      terms < 0 || form < kLaplacian || form > kRing ||
      (form == kRing && terms != 2))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  // the widest tile of 32-column steps whose values and terms fit kMixSmem
  long long tile = (kMixSmem - 8 * (long long)terms * rows) / (4 * rows);
  tile = (tile < kMaxTile ? tile : kMaxTile) / 32 * 32;
  const bool staged = tile >= 32;
  const long long per = staged ? tile : kMixThreads;
  MixTable table{};
  long long units = 0;
  for (int l = 0; l < count; ++l) {
    const int vec = staged && ns[l] % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(xs[l]) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(outs[l]) % 16 == 0;
    table.leaf[l] = MixLeaf{xs[l], outs[l], ns[l], units, vec};
    units += (ns[l] + per - 1) / per;
  }
  table.count = count;
  if (units == 0) return 0;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int r = (int)rows, t = (int)tile;
  if (form == kLaplacian)
    launch_form<kLaplacian>(table, units, staged, src, w, r, terms, t, c0, st);
  else if (form == kCirculant)
    launch_form<kCirculant>(table, units, staged, src, w, r, terms, t, c0, st);
  else
    launch_form<kRing>(table, units, staged, src, w, r, terms, t, c0, st);
  return (int)cudaGetLastError();
}
