// Gilbert–Elliott burst-channel keep masks for Hopper (sm_90a).
//
// Replaces no pl.pallas_call: the reference draws the masks in jnp inside
// its jitted round, as a lax.scan over the frames of one (node, leaf, ARQ
// attempt) chain (GilbertElliottLoss.keep, src/repro/core/transport.py:
// 255-273). A chain starts bad when its start uniform u0 < fl32(π_bad) and
// then, frame by frame,
//     keep = u_l >= (bad ? loss_bad : loss_good)
//     bad ^= u_t < (bad ? p_exit : p_enter)
// on the f32 constants the reference compares its uniforms with. The
// comparisons are exact, so the kernel is bit-equal to its plain version and
// to the reference whatever the compiler does.
//
// One launch covers every chain of a round: a table of up to kMaxLeaves
// leaves, each `rows` chains (nodes x attempts) of its own frame count n,
// its uniforms and its keeps (rows, n) row-major, and its start uniforms a
// strided column of one (rows, leaves) array.
//
// What bounds it on an H100: nothing of the card's width. The work is 12
// bytes a frame (two uniforms read, a keep written), about 0.125 MB a round
// at K = 10 with three ARQ attempts, so the byte bound is a few hundredths
// of a microsecond; a round has some 300 chains, only 30 of them long (335
// frames of fc1.w at MTU 256), so the time is the longest chain's latency.
//
// The design: the recurrence only looks serial. Frame t maps the 2-state
// chain by one of four maps (keep, flip, set-bad, clear), written as 2 bits,
// bit s the image of state s:
//     m = (u_t < p_enter) | (!(u_t < p_exit) << 1),   identity 0b10,
// and composing maps is associative, so the states are a prefix scan. A
// warp takes a chain and 32 frames a tile, one a lane: coalesced 128-byte
// loads of u_t and u_l, in groups of kAhead tiles, the next group issued
// before the current one is scanned (two groups, 512 frames, are in flight
// at the start, so a chain up to that long pays one memory latency); a
// 5-level Hillis–Steele scan of the maps with __shfl_up_sync; the exclusive
// prefix applied to the tile's incoming state gives the state before each
// frame, which picks its loss threshold; lane 31's inclusive map carries the
// state to the next tile. Lanes past n carry the identity and write nothing.
// Cost model of the longest chain: one load latency, then its ceil(n / 32)
// tiles' scans, which do not depend on the state and overlap, and a carry of
// two dependent operations a tile; 11 tiles at n = 335.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                 // warps a CTA, one chain each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxLeaves = 64;
constexpr int kAhead = 8;                 // tiles a group of loads
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kIdentity = 2u;        // good -> good, bad -> bad

struct GilbertLeaf {
  const float* u_t;   // (rows, n) transition uniforms
  const float* u_l;   // (rows, n) loss uniforms
  float* keep;        // (rows, n) 0/1 keeps
  const float* u0;    // start uniform of row r at u0[r * u0_stride]
  long long n;
};

struct GilbertTable {
  GilbertLeaf leaf[kMaxLeaves];
  int count;
  long long rows;
  float pi_bad, p_enter, p_exit, loss_good, loss_bad;
};

// the map "g after f": state s goes to g(f(s))
__device__ __forceinline__ unsigned compose(unsigned g, unsigned f) {
  return ((g >> (f & 1u)) & 1u) | (((g >> (f >> 1)) & 1u) << 1);
}

__global__ void __launch_bounds__(kThreads)
gilbert_keep_kernel(const __grid_constant__ GilbertTable table,
                    long long u0_stride) {
  const int lane = threadIdx.x & 31;
  const long long chain =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  // the whole warp returns together, before any full-mask shuffle
  if (chain >= table.rows * table.count) return;
  const int l = (int)(chain / table.rows);
  const long long r = chain - (long long)l * table.rows;
  const GilbertLeaf& leaf = table.leaf[l];
  const long long n = leaf.n;
  const float* ut = leaf.u_t + r * n;
  const float* ul = leaf.u_l + r * n;
  float* out = leaf.keep + r * n;
  unsigned bad = leaf.u0[r * u0_stride] < table.pi_bad ? 1u : 0u;

  // loads of the next kAhead tiles, in flight while this group scans
  float na[kAhead], nb[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const long long t = 32LL * j + lane;
    na[j] = t < n ? __ldg(ut + t) : 0.f;
    nb[j] = t < n ? __ldg(ul + t) : 0.f;
  }
  for (long long t0 = 0; t0 < n; t0 += 32LL * kAhead) {
    float a[kAhead], b[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      a[j] = na[j];
      b[j] = nb[j];
    }
    if (t0 + 32LL * kAhead < n) {
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const long long t = t0 + 32LL * (kAhead + j) + lane;
        na[j] = t < n ? __ldg(ut + t) : 0.f;
        nb[j] = t < n ? __ldg(ul + t) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const long long base = t0 + 32LL * j;
      if (base >= n) break;                       // the same for the warp
      const long long t = base + lane;
      const bool live = t < n;
      unsigned inc = live ? ((a[j] < table.p_enter ? 1u : 0u) |
                             (a[j] < table.p_exit ? 0u : 2u))
                          : kIdentity;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned earlier = __shfl_up_sync(kFull, inc, d);
        if (lane >= d) inc = compose(inc, earlier);
      }
      unsigned excl = __shfl_up_sync(kFull, inc, 1);
      if (lane == 0) excl = kIdentity;
      const unsigned before = (excl >> bad) & 1u;   // the state at frame t
      if (live)
        out[t] = b[j] >= (before ? table.loss_bad : table.loss_good) ? 1.f
                                                                    : 0.f;
      bad = (__shfl_sync(kFull, inc, 31) >> bad) & 1u;
    }
  }
}

}  // namespace

// u_t, u_l, keep: `count` leaves of (rows, ns[i]) f32; u0: (rows, count)
// f32, leaf i's column i; params: pi_bad, p_enter, p_exit, loss_good,
// loss_bad. Returns cudaGetLastError() after the launch.
extern "C" int repro_gilbert_keep(const float* const* u_t,
                                  const float* const* u_l,
                                  float* const* keep, const long long* ns,
                                  int count, long long rows, const float* u0,
                                  const float* params, void* stream) {
  if (count <= 0 || rows <= 0) return 0;
  if (count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  GilbertTable table;
  for (int i = 0; i < count; ++i)
    table.leaf[i] = GilbertLeaf{u_t[i], u_l[i], keep[i], u0 + i, ns[i]};
  table.count = count;
  table.rows = rows;
  table.pi_bad = params[0];
  table.p_enter = params[1];
  table.p_exit = params[2];
  table.loss_good = params[3];
  table.loss_bad = params[4];
  const long long chains = rows * count;
  const unsigned blocks = (unsigned)((chains + kWarps - 1) / kWarps);
  gilbert_keep_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, count);
  return (int)cudaGetLastError();
}
