// A masked LSTM layer's recurrence as one persistent launch, in each
// direction: `lstm_fwd_sweep` runs every step of the layer's forward, from
// the first to the last, and `lstm_bwd_sweep` every step of its backward,
// from the last to the first. `lstm_layer_forward` (below) takes the forward
// sweep wherever a cluster holds the layer (H <= 256) and launches
// `lstm_fwd_step` (train_common.cuh) once a step above that; K3f, K3b's
// replay of it and K4f's encoder (lm_train.cu, tf_train.cu) run through it.
// K4b sweeps its encoder layers back with `lstm_bwd_sweep`; K3b keeps the
// per-step `lstm_bwd_step` launches.
//
// What bounds the per-step versions: each step is a (B, H) . (H, 4H)
// product forward, or a (B, 4H) . (4H, H) one backward (33.5 M FMAs at
// B = 128, H = 256: about 0.5 us at the float32 SIMT peak), and a cell, but
// a launch takes 30-65 us: a grid of 32-64 blocks on 132 SMs, each walking
// K in 32-wide tiles of W_hh and of h or dpre read again from L2 every step,
// with two __syncthreads a tile. A sweep is bound by its serial latency, not
// by arithmetic or bytes.
//
// What this design does about it. A sweep never mixes rows, so a
// thread-block cluster that owns R rows runs all S steps of its rows with
// no grid-wide synchronisation:
// - the cluster's n CTAs split the hidden units, U = H / n each; each CTA
//   keeps its slice of W_hh (4H x U floats, 128 KB at H = 256, n = 8) in
//   shared memory for the whole sweep, loaded once by cp.async while the
//   first step of the sweep, which has no product, runs;
// - each step, each CTA forms its units' part of the product for its R
//   rows, runs the cell, writes the step's results to the same workspace
//   addresses as the per-step kernels do, pushes its slice of the vector
//   the next step's product reads (h forward, dpre backward) into every
//   peer's shared memory through distributed shared memory (double-buffered
//   by step parity), and meets the cluster barrier once;
// - the carries (c and h forward, dh and dc backward) stay in the registers
//   of the thread that owns the (row, unit) pair; the next step's operands
//   are loaded into registers at the start of a step, so their latency
//   hides behind the step's product and barrier;
// - R is chosen at launch so that the clusters fit on the card at once (a
//   larger batch runs in waves).
// The forward: a thread owns one unit and up to kFwdMaxRpt rows, its four
// gates of each, and sums h_{t-1} . W_hh^T over k = 0 .. H-1 in order with
// fmaf from 0, then adds the pre-activation the layer's GEMM wrote: the
// order of lstm_fwd_step, so the sweep gives its bits. Each 16-byte read
// (4 k) of a gate's W_hh row serves all of the thread's rows, and each of
// h all four gates; a warp's lanes are 8 units x 4 row groups, so its reads
// fall on distinct banks. The backward: a thread owns one (row, unit) pair,
// and 8 warps split the 4H-deep product, adding their partials in a fixed
// order.
// float32 on the SIMT cores, as the trainers; every sum runs in a fixed
// order independent of R, n and the card, with no atomics, so a sweep gives
// the same bits on every run. The copies, the push into the cluster, the
// split barrier and the launch plan are cluster_sweep.cuh's, shared with
// K1's encoder sweep (seq2seq_decode.cu).
#pragma once

#include "cluster_sweep.cuh"
#include "train_common.cuh"

namespace probnmn {
namespace {

constexpr int kSweepWarps = 8;       // the warps that split the product's 4H-deep sum
constexpr int kSweepMaxRows = 10;    // rows a cluster owns at most (the lanes' accumulators)
constexpr int kSweepMaxUnits = 32;   // units a CTA owns at most: one a lane
// A CTA has a thread for each of its (row, unit) pairs, and at least the
// product's warps.
constexpr int kSweepMaxThreads = kSweepMaxRows * kSweepMaxUnits;

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
  cp_async_commit();

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
        push_to_cluster(cluster, reinterpret_cast<float4*>(slot), v, n);
      }
      cluster.sync();
    }
    cur = nxt;
  }
  cp_async_wait_all();  // a one-step sweep never waited for W_hh
}

// ------------------------------------------------------------------ forward sweep
constexpr int kFwdMaxRpt = 4;    // rows a thread owns at most (four accumulators each)
constexpr int kFwdMaxRows = 32;  // rows a cluster owns at most
// Row groups come in fours (a warp's lanes are 8 units x 4 groups); a CTA
// has a thread for each (unit, group): at most 8 groups of 32 units.
constexpr int kFwdMaxThreads = kSweepMaxUnits * 4 * ((kFwdMaxRows + 4 * kFwdMaxRpt - 1) /
                                                     (4 * kFwdMaxRpt));

// The row groups G of a cluster's R rows (a multiple of 4, each group at
// most kFwdMaxRpt rows: row r is in group r % G) and the rows a group owns.
int fwd_groups(int R) { return 4 * ((R + 4 * kFwdMaxRpt - 1) / (4 * kFwdMaxRpt)); }
int fwd_rpt(int R) { return (R + fwd_groups(R) - 1) / fwd_groups(R); }

// W_hh's and h's depth, padded with zeros to whole float4s. Rows of both
// lie depth + 4 floats apart in shared memory, so that the 8 units or 4
// rows a warp reads at one k fall on distinct banks.
__host__ __device__ __forceinline__ int fwd_depth(int H) { return (H + 3) / 4 * 4; }

// Shared memory: W_hh's rows of the CTA's units' gates as ws[q][u][k] =
// W_hh[q * H + j0 + u][k] (4 * U rows); two h buffers hb[p][r][k] =
// h_{t-1}[row0 + r][k] (2 * R rows).
size_t fwd_sweep_smem_bytes(int H, int U, int R) {
  return (4ll * U + 2ll * R) * (fwd_depth(H) + 4) * sizeof(float);
}

// One step's operands of a thread's rows: the pre-activations x . W_ih^T +
// bias of their units' four gates (what the layer's GEMM wrote) and the
// step mask.
template <int RPT>
struct FwdIn {
  float pre[RPT][4], m[RPT];
};

// Grid: ceil(B / R) clusters of n CTAs of U * G threads (rounded up to a
// warp), G = fwd_groups(R), RPT = fwd_rpt(R). gates (T*B, 4H) holds the
// pre-activations and receives the activated gates; h, c, y (T*B, H); m
// (T*B); rows t * B + b. As lstm_fwd_step's loop over t from zero states.
template <int RPT>
__global__ void __launch_bounds__(kFwdMaxThreads, 1)
lstm_fwd_sweep(const float* __restrict__ w_hh, float* gates, const float* __restrict__ m,
               float* h_out, float* c_out, float* y_out, int T, int B, int H, int U, int R,
               int G) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x) / n * R;
  const int j0 = rank * U;
  const int depth = fwd_depth(H), hs = depth + 4;
  const ll G4 = 4ll * H;
  float* ws = smem;
  float* hb = ws + 4ll * U * hs;
  const int tid = threadIdx.x;

  // W_hh's rows, along k in global and shared memory alike; zero past H in
  // either direction.
  for (int e = tid; e < 4 * U * depth; e += blockDim.x) {
    const int k = e % depth, qu = e / depth;
    const int u = qu % U, q = qu / U, col = j0 + u;
    const bool valid = col < H && k < H;
    cp_async4(ws + static_cast<ll>(qu) * hs + k,
              w_hh + (valid ? (static_cast<ll>(q) * H + col) * H + k : 0), valid);
  }
  cp_async_commit();
  for (int e = tid; e < 2 * R * hs; e += blockDim.x) hb[e] = 0.f;  // h_{-1} = 0, and the padding

  // This thread's unit u and row group g: lanes run over 4 groups, then units.
  const bool owner = tid < U * G;
  const int u = owner ? tid / 4 % U : 0, g = owner ? tid / 4 / U * 4 + tid % 4 : 0;
  const int j = j0 + u;
  int r[RPT];
  bool live[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int rr = g + G * i;
    live[i] = owner && rr < R && row0 + rr < B && j < H;
    r[i] = rr < R ? rr : 0;  // a slot past R reads row 0 and writes nothing
  }
  auto load = [&](int t) {
    FwdIn<RPT> in;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const ll row = static_cast<ll>(t) * B + row0 + r[i];
      const float* gp = gates + row * G4;
#pragma unroll
      for (int q = 0; q < 4; ++q) in.pre[i][q] = live[i] ? gp[q * H + j] : 0.f;
      in.m[i] = live[i] ? m[row] : 0.f;
    }
    return in;
  };
  float h_state[RPT], c_state[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) h_state[i] = c_state[i] = 0.f;
  FwdIn<RPT> cur = load(0);
  cluster.sync();  // every CTA of the cluster runs, its buffers zeroed, before any writes into them

  for (int t = 0; t < T; ++t) {
    float acc[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    if (t > 0) {
      if (t == 1) {
        cp_async_wait_all();
        __syncthreads();
      }
      // h_{t-1} . W_hh[q * H + j, :]^T, k = 0, 1, ... in order, as lstm_fwd_step.
      const float* h = hb + ((t - 1) & 1) * R * hs;
      if (owner) {
#pragma unroll 2
        for (int k = 0; k < depth; k += 4) {
          float hv[RPT][4], wv[4][4];
#pragma unroll
          for (int i = 0; i < RPT; ++i) load4(h + r[i] * hs + k, hv[i]);
#pragma unroll
          for (int q = 0; q < 4; ++q) load4(ws + static_cast<ll>(q * U + u) * hs + k, wv[q]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(hv[i][kk], wv[q][kk], acc[i][q]);
        }
      }
    }
    LstmGates a[RPT];
    float y[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      a[i] = lstm_activate(cur.pre[i][0] + acc[i][0], cur.pre[i][1] + acc[i][1],
                           cur.pre[i][2] + acc[i][2], cur.pre[i][3] + acc[i][3]);
      float h_new, c_new;
      lstm_cell_forward(a[i], h_state[i], c_state[i], cur.m[i], h_new, c_new, y[i]);
      h_state[i] = h_new;
      c_state[i] = c_new;
    }
    const bool more = t + 1 < T;
    if (more) {
      // This step's h into every CTA's buffer (its own included), then the
      // barrier's arrival: its release orders these pushes alone, so the
      // stores and loads below overlap the wait for the other CTAs.
      float* slot = hb + (t & 1) * R * hs + j;
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (live[i])
          push_to_cluster(cluster, slot + r[i] * hs, h_state[i], n);
      cluster_arrive();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (!live[i]) continue;
      const ll row = static_cast<ll>(t) * B + row0 + r[i];
      float* gp = gates + row * G4;
      gp[j] = a[i].i;
      gp[H + j] = a[i].f;
      gp[2 * H + j] = a[i].g;
      gp[3 * H + j] = a[i].o;
      h_out[row * H + j] = h_state[i];
      c_out[row * H + j] = c_state[i];
      y_out[row * H + j] = y[i];
    }
    if (more) {
      cur = load(t + 1);  // in flight through the wait and the next step's product
      cluster_wait();
    }
  }
  cp_async_wait_all();  // a one-step sweep never waited for W_hh
}

// ------------------------------------------------------------------ launch plans
// Whether a cluster holds a layer of H units: the shape that picks the
// sweep, decided on the host before any launch.
bool sweep_holds(int H) {
  return H > 0 && (H + kSweepMaxCluster - 1) / kSweepMaxCluster <= kSweepMaxUnits;
}

// The cluster size: the smallest of 1, 2, 4, 8 with at most kSweepMaxUnits
// units a CTA.
int sweep_cluster(int H) {
  int n = 1;
  while ((H + n - 1) / n > kSweepMaxUnits) n *= 2;
  return n;
}

int sweep_threads(int R, int U) {
  const int pairs = (R * U + 31) / 32 * 32;
  return pairs > 32 * kSweepWarps ? pairs : 32 * kSweepWarps;
}

int fwd_sweep_threads(int R, int U) { return (U * fwd_groups(R) + 31) / 32 * 32; }

// cudaErrorInvalidValue where no cluster holds the layer (H > 256).
cudaError_t sweep_plan(int H, int B, cudaStream_t s, SweepPlan* plan) {
  if (!sweep_holds(H)) return cudaErrorInvalidValue;
  const int n = sweep_cluster(H), U = (H + n - 1) / n;
  return plan_for(
      lstm_bwd_sweep, [=](int R) { return sweep_smem_bytes(H, U, R); },
      [=](int R) { return sweep_threads(R, U); }, kSweepMaxRows, n, U, B, s, plan);
}

// The forward's plan; the occupancy is read at the widest instance, and the
// launch sets the shared memory of the one it takes.
cudaError_t fwd_sweep_plan(int H, int B, cudaStream_t s, SweepPlan* plan) {
  if (!sweep_holds(H)) return cudaErrorInvalidValue;
  const int n = sweep_cluster(H), U = (H + n - 1) / n;
  return plan_for(
      lstm_fwd_sweep<kFwdMaxRpt>, [=](int R) { return fwd_sweep_smem_bytes(H, U, R); },
      [=](int R) { return fwd_sweep_threads(R, U); }, kFwdMaxRows, n, U, B, s, plan);
}

// ------------------------------------------------------------------ layers
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

// The forward sweep's instance for R rows a cluster (rows a thread: fwd_rpt).
typedef void (*FwdSweep)(const float*, float*, const float*, float*, float*, float*, int, int, int,
                         int, int, int);
FwdSweep fwd_sweep_kernel(int R) {
  switch (fwd_rpt(R)) {
    case 1: return lstm_fwd_sweep<1>;
    case 2: return lstm_fwd_sweep<2>;
    case 3: return lstm_fwd_sweep<3>;
    default: return lstm_fwd_sweep<4>;
  }
}

// A masked layer's forward: one GEMM for x . W_ih^T + bias over all steps,
// then the recurrence: one lstm_fwd_sweep launch where a cluster holds the
// layer (H <= 256), else one lstm_fwd_step launch a step. y = h * m is what
// the layer above reads.
cudaError_t lstm_layer_forward(cudaStream_t s, const LayerArgs& a) {
  const ll G = 4ll * a.H, bh = static_cast<ll>(a.B) * a.H;
  TRAIN_TRY(gemm(s, a.x, a.din, 1, a.w_ih, 1, a.din, a.gates, G, a.T * a.B, static_cast<int>(G),
                 a.din, a.bias, false, nullptr));
  if (sweep_holds(a.H)) {
    SweepPlan p;
    TRAIN_TRY(fwd_sweep_plan(a.H, a.B, s, &p));
    const FwdSweep kernel = fwd_sweep_kernel(p.rows);
    TRAIN_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(p.smem)));
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    sweep_config(p.cluster, p.threads, p.smem, p.clusters, s, &cfg, &attr);
    return cudaLaunchKernelEx(&cfg, kernel, a.w_hh, a.gates, a.m, a.h, a.c, a.y, a.T, a.B, a.H,
                              p.units, p.rows, fwd_groups(p.rows));
  }
  const dim3 grid(ceil_div(a.H, kFUnits), ceil_div(a.B, kFRows));
  for (int t = 0; t < a.T; ++t) {
    const float* hp = t > 0 ? a.h + (t - 1) * bh : nullptr;
    lstm_fwd_step<<<grid, 256, 0, s>>>(hp, a.H, a.w_hh, a.H, hp,
                                       t > 0 ? a.c + (t - 1) * bh : nullptr, a.gates + t * a.B * G,
                                       a.m + t * a.B, a.h + t * bh, a.c + t * bh, a.y + t * bh,
                                       a.B, a.H);
    TRAIN_LAUNCHED();
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace probnmn
