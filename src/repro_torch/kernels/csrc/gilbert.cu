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
// bytes a frame (two uniforms read, a keep written), about 0.25 MB a round
// at K = 10 with three ARQ attempts, so the byte bound is a few
// microseconds; the recurrence makes each chain a dependent sequence of n
// steps, so the longest chain (some 400 frames of fc1.w at MTU 256) sets
// the time. What the simple design does about that: one thread a chain,
// the state in a register, and the loads, which do not depend on the state,
// issued kUnroll frames ahead of the steps that use them. A warp-level scan
// over the four maps a frame applies to the 2-state chain is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLeaves = 64;
constexpr int kUnroll = 8;

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

__global__ void __launch_bounds__(kThreads)
gilbert_keep_kernel(const __grid_constant__ GilbertTable table,
                    long long u0_stride) {
  const long long chain = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (chain >= table.rows * table.count) return;
  const int l = (int)(chain / table.rows);
  const long long r = chain - (long long)l * table.rows;
  const GilbertLeaf& leaf = table.leaf[l];
  const long long n = leaf.n;
  const float* ut = leaf.u_t + r * n;
  const float* ul = leaf.u_l + r * n;
  float* out = leaf.keep + r * n;
  bool bad = leaf.u0[r * u0_stride] < table.pi_bad;
  long long t = 0;
  for (; t + kUnroll <= n; t += kUnroll) {
    float a[kUnroll], b[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      a[j] = __ldg(ut + t + j);
      b[j] = __ldg(ul + t + j);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      out[t + j] = b[j] >= (bad ? table.loss_bad : table.loss_good) ? 1.f
                                                                    : 0.f;
      bad ^= a[j] < (bad ? table.p_exit : table.p_enter);
    }
  }
  for (; t < n; ++t) {
    const float a = __ldg(ut + t), b = __ldg(ul + t);
    out[t] = b >= (bad ? table.loss_bad : table.loss_good) ? 1.f : 0.f;
    bad ^= a < (bad ? table.p_exit : table.p_enter);
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
  const unsigned blocks = (unsigned)((chains + kThreads - 1) / kThreads);
  gilbert_keep_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, count);
  return (int)cudaGetLastError();
}
