// Compress-in-update for Hopper (sm_90a): the two kernels of the fused
// block_topk|qsgd encode.
//
// 1. delta-pack: the block-top-k pack of θ − v without writing the
//    residual. Replaces delta_pack_pallas (pl.pallas_call at
//    src/repro/kernels/fused_compress.py:58, body _delta_pack_kernel at
//    :41-48) and the wrapper's aligned-head / padded-tail split
//    (kernels/ops.py:141-174). The split is a TPU tiling device (8-row
//    tiles) and is not carried over: the ragged last block reads its
//    missing elements as 0, which is what the reference's zero-padded tail
//    tile holds (θ − v = 0 − 0 there).
//    What bounds it on an H100: the function's own bound is two reads of
//    the leaf (θ and v, 8 bytes an element at 3.35 TB/s, 2.4 ps) against
//    45 f32 operations an element with the subtraction (0.67 ps at
//    67 TFLOP/s) and a wire-sized write. This design is bound by the
//    instruction issue of pack_tile.cuh's selection, as pack is (see
//    pack.cu): the 31-pass search for the block's k-th magnitude, then the
//    rank's ballots and popcounts.
//    What the design does about that: the residual d = θ − v is formed in
//    registers (__fsub_rn, the reference's f32 subtraction) and never
//    reaches device memory, which is the kernel's whole point; the shared
//    register-resident tile runs with HAS_V = true. The round encodes every
//    packed leaf with one launch over a table of the leaves (the codec's
//    one call a round), so the small leaves' blocks run beside fc1.w's.
//
// 2. grid_quant: QSGD stochastic rounding of the packed (rows, m) carriers
//    onto the signed integer grid, sign(x)·q as int8, each row (node) under
//    its own norm ‖row‖₂ + 1e-12, which the kernel computes. Replaces
//    grid_quant_pallas (pl.pallas_call at
//    src/repro/kernels/fused_compress.py:93, body _grid_quant_kernel at
//    :71-77) together with the norm its wrapper computes in jnp
//    (kernels/ops.py:177-196); the padding of the rows to the 8-row TPU
//    tile is not carried over. The level arithmetic is qsgd_round.cuh's,
//    shared with the dense qsgd kernel. q <= s <= 64 fits int8.
//    What bounds it on an H100: bytes, two f32 reads and one int8 write an
//    element (9 bytes) against ~8 f32 operations with the norm's square
//    and add; but the carriers are wire-sized (280,060 elements a round at
//    full width and K=10, 2.5 MB: 0.75 µs at 3.35 TB/s), so the launch and
//    the latency of a row's dependent steps (load, norm across the row,
//    quantize) set its time.
//    What the design does about that: one launch a round over a table of
//    the leaves' carriers (up to kMaxLeaves), so the round's norms are no
//    longer torch reductions of their own. A long row (m > kNarrowRow, such
//    as fc1.w's 27,687) is split over a thread-block cluster of kCluster
//    CTAs (8: the fastest of 1, 2, 4 and 8 in an A/B on the card, PERF.md),
//    whose partial sums meet through
//    distributed shared memory; short rows take a CTA each, C rows a
//    cluster, so the table fits in one wave. Every thread issues all its
//    loads of x and u first and keeps them in registers (a lane's elements
//    are 512 apart, so a warp's loads are coalesced), then sums its lanes,
//    and quantizes from the registers once the norm is known: x is read
//    from device memory once. A row too long for the registers is read
//    twice instead (the norm, then the grid). A first design staged each
//    CTA's share in shared memory by TMA bulk copies under an mbarrier,
//    with 1024 lanes; the copy's round trip and the longer per-thread
//    chains made it about 2x slower (PERF.md, kernel table).
//    The norm's summation order is a function of the row's length m alone
//    (carrier_norms_plain in fused_compress.py transcribes it):
//    4096 lanes, lane p = 512·g + q adding x[g·S + q + 512·j]² for j = 0, 1,
//    … in sequence over segment g = 0..7 of S = ⌈m/8⌉ elements (cut at m),
//    then the 4096 lane sums added pairwise, neighbours first: a thread's
//    adjacent lanes, the warp's threads by shuffles, the CTA's warps, then
//    the cluster's CTAs in rank order. Every product and sum is one f32
//    rounding (__fmul_rn, __fadd_rn, __fsqrt_rn).
#include <cooperative_groups.h>

#include "pack_tile.cuh"
#include "qsgd_round.cuh"

namespace repro_torch {

constexpr int kNormSegments = 8;                    // fused_compress.py
constexpr int kSegmentLanes = 512;                  // fused_compress.py
constexpr int kGridQuantThreads = kSegmentLanes;    // a CTA
constexpr int kLaneRegs = 8;                        // x (and u) a thread
constexpr long long kNarrowRow = 4096;              // one CTA a row
constexpr int kCluster = 8;                         // CTAs a cluster

// Leaf l: (rows, m) carrier x and uniforms u, its (rows, m) int8 grid q and
// (rows,) norms; seg is S; its clusters are the launch's begin, begin + 1,
// …. A wide leaf's cluster quantizes one row, its kCluster CTAs a part
// each; a narrow leaf's (m <= kNarrowRow) quantizes kCluster rows, one a
// CTA. A kernel parameter (__grid_constant__).
struct GridQuantLeaf {
  const float* x;
  const float* u;
  int8_t* q;
  float* norm;
  long long m, seg, begin;
  int wide;
};

struct GridQuantTable {
  GridQuantLeaf leaf[kMaxLeaves];
  long long rows;
  int count;
};

// The cluster's barrier in two halves (barrier.cluster: every thread of
// every CTA of the cluster arrives, then waits).
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ int8_t grid_value(float f, float u, float nrm,
                                             float levels) {
  const int level = (int)qsgd_level(f, u, nrm, levels);
  return (int8_t)(f > 0.0f ? level : (f < 0.0f ? -level : 0));
}

// The row's norm from this thread's partial sum: pairwise, neighbours
// first, over the warp's threads, the CTA's warps, then (wide) the
// cluster's CTAs in rank order.
__device__ __forceinline__ float row_norm_of(float acc, bool wide) {
  __shared__ float warp_sums[kGridQuantThreads / 32];
  __shared__ float cta_sum, norm;
  const int t = threadIdx.x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  if ((t & 31) == 0) warp_sums[t >> 5] = acc;
  __syncthreads();
  if (t < 32) {
    constexpr int kWarps = kGridQuantThreads / 32;
    float w = t < kWarps ? warp_sums[t] : 0.0f;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1)
      w = __fadd_rn(w, __shfl_xor_sync(kFull, w, off));
    if (t == 0) cta_sum = w;
  }
  if (wide) {
    cluster_wait();                   // every CTA of the cluster started
    cluster_arrive_release();         // cta_sum, to the cluster
    cluster_wait();
    if (t == 0) {
      namespace cg = cooperative_groups;
      float z[kCluster];
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        z[r] = *cg::this_cluster().map_shared_rank(&cta_sum, r);
#pragma unroll
      for (int w = kCluster; w > 1; w >>= 1)
#pragma unroll
        for (int i = 0; i < w / 2; ++i)
          z[i] = __fadd_rn(z[2 * i], z[2 * i + 1]);
      norm = __fadd_rn(__fsqrt_rn(z[0]), 1e-12f);
    }
    cluster_arrive_relaxed();         // done reading the peers' cta_sum
  } else if (t == 0) {
    norm = __fadd_rn(__fsqrt_rn(cta_sum), 1e-12f);
  }
  __syncthreads();
  return norm;
}

// This thread's L adjacent lanes q0 .. q0 + L − 1 of segment [gb, ge) of a
// row: lane q0 + i adds x[gb + q0 + i + 512·j]² for j = 0, 1, … below ge.
// Its elements are held in registers when a lane has at most kLaneRegs / L
// of them (every element loaded once, before any arithmetic), else read
// from device memory twice (the norm, then the grid).
template <int L>
__device__ __forceinline__ void row_part(
    const float* __restrict__ xr, const float* __restrict__ ur,
    int8_t* __restrict__ qr, float* __restrict__ norm_out, int gb, int ge,
    int q0, int seg, bool wide, float levels) {
  constexpr int J = kLaneRegs / L;
  const bool regs = seg <= J * kSegmentLanes;
  const int e0 = gb + q0;
  float x[L][J], u[L][J];
  if (regs) {
#pragma unroll
    for (int i = 0; i < L; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int e = e0 + i + kSegmentLanes * j;
        x[i][j] = e < ge ? __ldg(xr + e) : 0.0f;
        u[i][j] = e < ge ? __ldg(ur + e) : 0.0f;
      }
  }
  // the lanes' sums in sequence (a missing element adds +0.0, which leaves
  // a sum of squares as it is), then the thread's L lanes pairwise
  float lane[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    float acc = 0.0f;
    if (regs) {
#pragma unroll
      for (int j = 0; j < J; ++j)
        acc = __fadd_rn(acc, __fmul_rn(x[i][j], x[i][j]));
    } else {
      for (int e = e0 + i; e < ge; e += kSegmentLanes) {
        const float f = __ldg(xr + e);
        acc = __fadd_rn(acc, __fmul_rn(f, f));
      }
    }
    lane[i] = acc;
  }
#pragma unroll
  for (int w = L; w > 1; w >>= 1)
#pragma unroll
    for (int i = 0; i < w / 2; ++i)
      lane[i] = __fadd_rn(lane[2 * i], lane[2 * i + 1]);
  const float nrm = row_norm_of(lane[0], wide);
  if (norm_out && threadIdx.x == 0) *norm_out = nrm;

  if (regs) {
#pragma unroll
    for (int i = 0; i < L; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int e = e0 + i + kSegmentLanes * j;
        if (e < ge) qr[e] = grid_value(x[i][j], u[i][j], nrm, levels);
      }
  } else {
#pragma unroll
    for (int i = 0; i < L; ++i)
      for (int e = e0 + i; e < ge; e += kSegmentLanes)
        qr[e] = grid_value(__ldg(xr + e), __ldg(ur + e), nrm, levels);
  }
}

// CTA rank r of cluster c: part r of a wide leaf's row, lanes 512·r ..
// 512·r + 511, one a thread; or a whole row of a narrow leaf, 8 adjacent
// lanes a thread.
__global__ void __launch_bounds__(kGridQuantThreads)
grid_quant_kernel(const __grid_constant__ GridQuantTable table,
                  float levels) {
  static_assert(kCluster == kNormSegments, "a wide row's CTA is a segment");
  const long long c = blockIdx.x / kCluster;
  const int rank = blockIdx.x % kCluster;
  int l = 0;
  while (l + 1 < table.count && c >= table.leaf[l + 1].begin) ++l;
  const GridQuantLeaf& leaf = table.leaf[l];
  const bool wide = leaf.wide;        // uniform within the cluster
  if (wide) cluster_arrive_relaxed(); // this CTA has started
  const long long row =
      wide ? c - leaf.begin : (c - leaf.begin) * kCluster + rank;
  if (row >= table.rows) return;      // a narrow leaf's last cluster
  const int part = wide ? rank : 0;
  const int p0 = wide ? part * kGridQuantThreads + (int)threadIdx.x
                      : (int)threadIdx.x * kNormSegments;  // first lane
  const int m = (int)leaf.m, seg = (int)leaf.seg;
  const int gb = (p0 / kSegmentLanes) * seg;
  const int ge = min(m, gb + seg);
  const int q0 = p0 % kSegmentLanes;
  const float* xr = leaf.x + row * m;
  const float* ur = leaf.u + row * m;
  int8_t* qr = leaf.q + row * m;
  float* norm_out = part == 0 ? leaf.norm + row : nullptr;
  if (wide)
    row_part<1>(xr, ur, qr, norm_out, gb, ge, q0, seg, true, levels);
  else
    row_part<kNormSegments>(xr, ur, qr, norm_out, gb, ge, q0, seg, false,
                            levels);
  if (wide) cluster_wait();           // no peer reads this CTA's cta_sum
}

}  // namespace repro_torch

// One launch packs θ − v of `count` <= kMaxLeaves leaves of `rows` rows
// each: leaf l is thetas[l] and vs[l], (rows, ns[l]) with nbs[l] blocks a
// row, and its payload starts at element outs[l] of vals and idx.
extern "C" int repro_delta_pack(const float* const* thetas,
                                const float* const* vs, const long long* ns,
                                const long long* nbs, const long long* outs,
                                int count, long long rows, float* vals,
                                uint16_t* idx, int k, void* stream) {
  return repro_torch::launch_pack<true>(
      thetas, reinterpret_cast<const void* const*>(vs), ns, nbs, outs, count,
      rows, vals, idx, k, stream);
}

// The same with v stored in bfloat16 (FedConfig.control_dtype): each
// element of v widened to f32 in registers before the subtraction.
extern "C" int repro_delta_pack_bf16(const float* const* thetas,
                                     const __nv_bfloat16* const* vs,
                                     const long long* ns, const long long* nbs,
                                     const long long* outs, int count,
                                     long long rows, float* vals,
                                     uint16_t* idx, int k, void* stream) {
  return repro_torch::launch_pack<true, __nv_bfloat16>(
      thetas, reinterpret_cast<const void* const*>(vs), ns, nbs, outs, count,
      rows, vals, idx, k, stream);
}

// One launch quantizes `count` <= kMaxLeaves carriers of `rows` rows each:
// leaf l is the (rows, ms[l]) carrier xs[l] and uniforms us[l], its int8
// grid goes to qs[l] and its (rows,) norms to norms[l].
extern "C" int repro_grid_quant(const float* const* xs,
                                const float* const* us, int8_t* const* qs,
                                float* const* norms, const long long* ms,
                                int count, long long rows, float levels,
                                void* stream) {
  using namespace repro_torch;
  if (count < 1 || count > kMaxLeaves || rows < 0)
    return (int)cudaErrorInvalidValue;
  GridQuantTable table{};
  long long total = 0;                            // clusters
  for (int l = 0; l < count; ++l) {
    if (ms[l] < 0 || ms[l] > 0x7fffffffLL - 8 * kSegmentLanes)
      return (int)cudaErrorInvalidValue;
    const long long seg = (ms[l] + kNormSegments - 1) / kNormSegments;
    const bool wide = ms[l] > kNarrowRow;
    table.leaf[l] = GridQuantLeaf{xs[l], us[l], qs[l], norms[l], ms[l], seg,
                                  total, wide};
    total += wide ? rows : (rows + kCluster - 1) / kCluster;
  }
  table.rows = rows;
  table.count = count;
  if (rows == 0) return (int)cudaGetLastError();
  if (total * kCluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(total * kCluster));
  cfg.blockDim = dim3((unsigned)kGridQuantThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, grid_quant_kernel, table, levels);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
