// The reverse sweep of a masked LSTM layer as one persistent launch:
// `lstm_bwd_sweep` runs every step of the layer's backward, from the last to
// the first, where `lstm_layer_backward` (train_common.cuh) launches
// `lstm_bwd_step` once a step. K4b (tf_train.cu) sweeps its encoder layers
// with it; K3b keeps the per-step launches.
//
// What bounds the per-step version: each step is a (B, 4H) . (4H, H) product
// (33.5 M FMAs at B = 128, H = 256: about 0.5 us at the float32 SIMT peak)
// and a cell backward, but a launch takes about 65 us: a grid of 32 blocks
// on 132 SMs, each walking K = 4H in 32-wide tiles of W_hh and dpre read
// again from L2 every step, with two __syncthreads a tile. The sweep is
// bound by its serial latency, not by arithmetic or bytes.
//
// What this design does about it. A reverse sweep never mixes rows, so a
// thread-block cluster that owns R rows runs all S steps of its rows with
// no grid-wide synchronisation:
// - the cluster's n CTAs split the hidden units, U = H / n each; each CTA
//   keeps its columns of W_hh (4H x U floats, 128 KB at H = 256, n = 8) in
//   shared memory for the whole sweep, loaded once by cp.async while the
//   last step, which has no product, runs;
// - each step, each CTA computes dh for its R x U (row, unit) pairs, a
//   thread each, as the carry plus dpre_{t+1} . W_hh[:, its units] (8
//   warps split the 4H-deep sum, then add their partials in a fixed order)
//   plus ext * m, runs the cell backward, writes its slice of dpre_t over the gates (for the
//   weight-gradient GEMMs after the sweep) and into every peer's shared
//   memory through distributed shared memory (double-buffered by step
//   parity), and meets the cluster barrier once;
// - the dh and dc carries stay in the registers of the thread that owns
//   the pair; step t-1's gates, c, m and ext are loaded into registers at
//   the start of step t, so their latency hides behind step t's product
//   and barrier;
// - R is chosen at launch so that the clusters fit on the card at once
//   (up to kSweepMaxRows rows; a larger batch runs in waves).
// float32 on the SIMT cores, as the trainers; every sum runs in a fixed
// order independent of R, n and the card, with no atomics, so the sweep
// gives the same bits on every run.
#pragma once

#include <cooperative_groups.h>

#include "train_common.cuh"

namespace probnmn {
namespace {

namespace cg = cooperative_groups;

constexpr int kSweepWarps = 8;       // the warps that split the product's 4H-deep sum
constexpr int kSweepMaxRows = 10;    // rows a cluster owns at most (the lanes' accumulators)
constexpr int kSweepMaxUnits = 32;   // units a CTA owns at most: one a lane
// A CTA has a thread for each of its (row, unit) pairs, and at least the
// product's warps.
constexpr int kSweepMaxThreads = kSweepMaxRows * kSweepMaxUnits;
constexpr int kSweepMaxCluster = 8;  // the portable cluster size
constexpr size_t kSweepMaxSmem = 232448;  // the H100's shared memory a block can use

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared memory: W_hh's columns as ws[j][u][q] = W_hh[q * H + j][j0 + u]
// (H * U * 4 floats); two dpre buffers buf[p][r][4 * j + q] = dpre_q[row0 +
// r][j] (2 * R * 4H floats); the warps' partial products part[w][r][u].
size_t sweep_smem_bytes(int H, int U, int R) {
  return (static_cast<size_t>(H) * U * 4 + 2ull * R * 4 * H +
          static_cast<size_t>(kSweepWarps) * R * U) * sizeof(float);
}

// One step's operands of a (row, unit) pair: its four activated gates, the
// post-freeze c of this step and of the step before, the step mask and the
// gradient reaching its output.
struct SweepIn {
  float gi, gf, gg, go, c_post, c_prev, m, ext;
};

// Grid: ceil(B / R) clusters of n CTAs, each of max(8 warps, R * U threads
// rounded up to a warp). gates, c:
// (T*B, 4H) and (T*B, H) rows t * B + b; m (T*B); ext (T*B, H); dh_last
// (B, H) or null. dpre overwrites the gates.
__global__ void __launch_bounds__(kSweepMaxThreads, 1)
lstm_bwd_sweep(const float* __restrict__ w_hh, float* gates, const float* __restrict__ c,
               const float* __restrict__ m, const float* __restrict__ ext,
               const float* __restrict__ dh_last, int T, int B, int H, int U, int R) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x) / n * R;
  const int j0 = rank * U;
  const int G = 4 * H;
  float* ws = smem;
  float* buf = ws + static_cast<ll>(H) * U * 4;
  float* part = buf + 2ll * R * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // W_hh's columns j0 .. j0 + U - 1, read row by row (coalesced), zero past H.
  for (int e = tid; e < G * U; e += blockDim.x) {
    const int k = e / U, u = e % U;
    const int q = k / H, j = k % H, col = j0 + u;
    cp_async4(ws + (static_cast<ll>(j) * U + u) * 4 + q,
              w_hh + static_cast<ll>(k) * H + (col < H ? col : 0), col < H);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // The (row, unit) pair this thread owns in the cell backward.
  const bool owner = tid < R * U;
  const int r = owner ? tid / U : 0, u = owner ? tid % U : 0;
  const int b = row0 + r, j = j0 + u;
  const bool live = owner && b < B && j < H;
  auto load = [&](int t, float c_post) {
    SweepIn in{};
    if (!live) return in;
    const ll row = static_cast<ll>(t) * B + b;
    const float* gp = gates + row * G;
    in.gi = gp[j];
    in.gf = gp[H + j];
    in.gg = gp[2 * H + j];
    in.go = gp[3 * H + j];
    in.c_post = c_post;
    in.c_prev = t > 0 ? c[(row - B) * H + j] : 0.f;
    in.m = m[row];
    in.ext = ext[row * H + j];
    return in;
  };
  float dh_state = live && dh_last != nullptr ? dh_last[static_cast<ll>(b) * H + j] : 0.f;
  float dc_state = 0.f;
  SweepIn cur = load(T - 1, live ? c[(static_cast<ll>(T - 1) * B + b) * H + j] : 0.f);
  cluster.sync();  // every CTA of the cluster runs before any writes into its shared memory

  for (int t = T - 1; t >= 0; --t) {
    SweepIn nxt{};
    if (t > 0) nxt = load(t - 1, cur.c_prev);  // in flight through this step
    float prod = 0.f;
    if (t < T - 1) {
      if (t == T - 2) {
        cp_async_wait_all();
        __syncthreads();
      }
      // dpre_{t+1} . W_hh[:, j0 .. j0 + U): warp w takes units jj = w, w + 8, ...
      const float* d = buf + ((t + 1) & 1) * R * G;
      if (warp < kSweepWarps && lane < U) {
        float acc[kSweepMaxRows];
#pragma unroll
        for (int rr = 0; rr < kSweepMaxRows; ++rr) acc[rr] = 0.f;
#pragma unroll 2
        for (int jj = warp; jj < H; jj += kSweepWarps) {
          const float4 wv = *reinterpret_cast<const float4*>(ws + (static_cast<ll>(jj) * U + lane) * 4);
#pragma unroll
          for (int rr = 0; rr < kSweepMaxRows; ++rr) {
            if (rr < R) {
              const float4 dv = *reinterpret_cast<const float4*>(d + rr * G + 4 * jj);
              float a = acc[rr];
              a = fmaf(dv.x, wv.x, a);
              a = fmaf(dv.y, wv.y, a);
              a = fmaf(dv.z, wv.z, a);
              a = fmaf(dv.w, wv.w, a);
              acc[rr] = a;
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < kSweepMaxRows; ++rr)
          if (rr < R) part[(warp * R + rr) * U + lane] = acc[rr];
      }
      __syncthreads();
      if (owner)
        for (int w = 0; w < kSweepWarps; ++w) prod += part[(w * R + r) * U + u];
    }
    float dpre[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      const float dh = dh_state + prod + cur.ext * cur.m;
      const LstmGates g{cur.gi, cur.gf, cur.gg, cur.go};
      float dh_carry, dc_carry;
      lstm_cell_backward(g, cur.c_post, cur.c_prev, cur.m, dh, dc_state, dpre, dh_carry,
                         dc_carry);
      float* gp = gates + (static_cast<ll>(t) * B + b) * G;
      gp[j] = dpre[0];
      gp[H + j] = dpre[1];
      gp[2 * H + j] = dpre[2];
      gp[3 * H + j] = dpre[3];
      dh_state = dh_carry;
      dc_state = dc_carry;
    }
    if (t > 0) {
      // This step's dpre slice into every CTA's buffer (its own included).
      if (owner && j < H) {
        const float4 v = make_float4(dpre[0], dpre[1], dpre[2], dpre[3]);
        float* slot = buf + (t & 1) * R * G + r * G + 4 * j;
        for (int p = 0; p < n; ++p)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(slot, p)) = v;
      }
      cluster.sync();
    }
    cur = nxt;
  }
  cp_async_wait_all();  // a one-step sweep never waited for W_hh
}

// The launch plan for hidden size H and batch B: the cluster size n (the
// smallest of 1, 2, 4, 8 with at most kSweepMaxUnits units a CTA), the rows
// R a cluster owns (the fewest that let every cluster run at once, at most
// kSweepMaxRows and what shared memory holds), and the shared memory.
struct SweepPlan {
  int cluster, units, rows, threads, clusters, fit;  // fit: the clusters the card runs at once
  size_t smem;
};

int sweep_threads(int R, int U) {
  const int pairs = (R * U + 31) / 32 * 32;
  return pairs > 32 * kSweepWarps ? pairs : 32 * kSweepWarps;
}

void sweep_config(int n, int threads, size_t smem, int clusters, cudaStream_t s,
                  cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(clusters * n));
  cfg->blockDim = dim3(static_cast<unsigned>(threads));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(n);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// cudaErrorInvalidValue where no cluster holds the layer (H > 256).
cudaError_t sweep_plan(int H, int B, cudaStream_t s, SweepPlan* plan) {
  int n = 1;
  while (n <= kSweepMaxCluster && (H + n - 1) / n > kSweepMaxUnits) n *= 2;
  if (n > kSweepMaxCluster) return cudaErrorInvalidValue;
  const int U = (H + n - 1) / n;
  int r_max = kSweepMaxRows;
  while (r_max > 0 && sweep_smem_bytes(H, U, r_max) > kSweepMaxSmem) --r_max;
  if (r_max == 0) return cudaErrorInvalidValue;
  const size_t smem_max = sweep_smem_bytes(H, U, r_max);
  TRAIN_TRY(cudaFuncSetAttribute(lstm_bwd_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem_max)));
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  sweep_config(n, sweep_threads(r_max, U), smem_max, ceil_div(B, r_max), s, &cfg, &attr);
  int fit = 0;
  TRAIN_TRY(cudaOccupancyMaxActiveClusters(&fit, lstm_bwd_sweep, &cfg));
  if (fit < 1) return cudaErrorInvalidValue;
  const int R = ceil_div(B, fit) < r_max ? ceil_div(B, fit) : r_max;
  *plan = SweepPlan{n, U, R, sweep_threads(R, U), ceil_div(B, R), fit,
                    sweep_smem_bytes(H, U, R)};
  return cudaSuccess;
}

// The layer's reverse sweep in one launch: as lstm_layer_backward's loop over
// lstm_bwd_step, with the carries starting at dh_last (or 0) and 0.
cudaError_t lstm_layer_sweep(cudaStream_t s, const LayerArgs& a, const float* ext,
                             const float* dh_last) {
  SweepPlan p;
  TRAIN_TRY(sweep_plan(a.H, a.B, s, &p));
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  sweep_config(p.cluster, p.threads, p.smem, p.clusters, s, &cfg, &attr);
  return cudaLaunchKernelEx(&cfg, lstm_bwd_sweep, a.w_hh, a.gates, a.c, a.m, ext, dh_last, a.T,
                            a.B, a.H, p.units, p.rows);
}

}  // namespace
}  // namespace probnmn
