// K4's attentive decoder as one persistent launch a pass in each direction:
// `tf_decoder_fwd_sweep` runs every step of K4f's teacher-forced decoder,
// from the first to the last, and `tf_decoder_bwd_sweep` every step of K4b's
// decoder backward, from the last to the first, each with the attention
// inside the cluster. They replace the per-step launches of
// probnmn_tpu/ops/pallas/seq2seq_train.py's `dec_step` (_tf_forward_kernel)
// and `dec_bwd` (_tf_backward_kernel) that tf_train.cu ran one to three
// kernels a step: the attention (`tf_attend`) and the cell (`lstm_fwd_step`)
// forward; the cell backward, dpre . [W_ih[:, :H], W_hh] (a split-K GEMM)
// and the attention backward in reverse. tf_train.cu keeps the forward's
// per-step route for H > 256, where no cluster holds the cell.
//
// What bounds the per-step version: each step does about 0.13 GFLOP at
// B = 128, H = 256 (a few us at the float32 SIMT peak), but each of its
// launches takes 15-45 us: a grid that re-reads the (4H, 2H) weights (2 MiB)
// from L2 every step and leaves most SMs idle, and a host-side chain of
// 2 T launches forward and about 4 T backward.
//
// What this design does about it. Rows never mix, so a thread-block cluster
// of n CTAs (16 at H = 256, above the portable 8) owns R rows for all T
// steps with no grid-wide synchronisation, and each CTA owns U = 16 hidden
// units (n = H / 16 rounded up to a power of two; U a multiple of 4). A CTA
// keeps its units' four gate rows of dec_w = [W_ih[:, :H], W_hh] resident in
// shared memory for the whole pass (4U x 2H floats, 128 KiB at H = 256),
// loaded once by cp.async while the first step's attention runs. Row r of
// the cluster is owned, for the row-wise work, by CTA r % n (rows rank,
// rank + n, ...: at most 2 at B = 128 on 7 clusters).
//
// The forward, a step (two cluster barriers):
// - each CTA computes, for the rows it owns, the attention of h_{t-1} over
//   the source (the scores, the masked softmax, the context), reading the
//   encoder's outputs from L2, writes the attention weights and the residual
//   [attended, h_prev] row, and copies the attended vector into every CTA
//   of the cluster through distributed shared memory (16-byte pieces);
// - after the barrier, each CTA computes its units' four gates for all R
//   rows (a thread: one unit, up to 4 rows), the activation and the cell,
//   writes the activated gates, h and c, and copies its units' slice of h_t
//   into every CTA (h double-buffered by step parity, so the copies need not
//   wait for the other CTAs' products). c stays in registers.
// Sum orders are those of the per-step kernels: a score is summed by a warp
// over k = lane, lane + 32, ... and reduced by warp_sum, the softmax and the
// context as tf_attend; a gate by fmaf over k = 0 .. 2H-1 from 0 (the
// attended half, then h), then the pre-activation added, and the cell is
// lstm_cell_forward. So K4f's loss and residuals keep their bits.
//
// The reverse, a step (two cluster barriers):
// - each CTA runs the cell backward for every unit of the rows it owns (the
//   gradient reaching h_t and the dc carry stay in its shared memory),
//   writes dpre over the gates and copies each CTA's units' slice of dpre
//   to that CTA;
// - after the barrier, each CTA forms its units' part of
//   dcat = dpre . [W_ih[:, :H], W_hh] for all R rows (the 4U gate rows it
//   keeps resident for the forward, all 2H columns) and copies each row's
//   part to the row's owner;
// - after the second barrier, each owner adds the n parts in rank order and
//   runs the attention backward of its rows: dw_s = enc_s . datt, ds_s =
//   w_s (dw_s - sum w dw), the gradient reaching h_{t-1} (sum_s ds_s enc_s +
//   dcat[H:] + the head's), and denc[s, b] += ds_s h_prev + w_s datt; a row's
//   encoder gradient is its owner's alone, so no atomics. What reaches the
//   initial h is written for the top encoder layer's reverse sweep.
// Splitting dcat's 4H-deep sum by the CTAs' gate rows moves 2H floats a
// row to its owner instead of moving every row's whole dpre into every CTA,
// and keeps the forward's resident rows. Its order (gate-major over a
// CTA's 4U rows, then the CTAs' parts in rank order) is set by H alone, not
// by R or the card; every other sum runs in a fixed order too, with no
// atomics, so K4b gives the same bits on every run. It differs from the
// per-step split-K order and is held to a float64 reference.
//
// float32 on the SIMT cores, as the trainers. R is the fewest rows that let
// every cluster run at once (cudaOccupancyMaxActiveClusters), up to what
// shared memory allows; a larger batch runs in waves.
#pragma once

#include "lstm_sweep.cuh"

namespace probnmn {
namespace {

constexpr int kDecThreads = 256;                 // threads a CTA: 8 warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecMaxUnits = 16;                 // units a CTA owns at most
constexpr int kDecMaxCluster = 16;               // CTAs a cluster at most (non-portable above 8)
constexpr int kDecFwdMaxRows = 64;               // forward: rows a cluster at most (4 a thread)
constexpr int kDecMaxOwn = 4;                    // rows a CTA owns for the row-wise work at most
constexpr int kDecBwdMaxRpt = 16;                // reverse: rows a thread of the dcat parts at most
constexpr int kDecScoreBatch = 8;                // source positions a warp scores at once
// (row, unit) pairs a thread takes in the owned rows' work at most: own x H
// <= 4 x 256.
constexpr int kDecCellPairs = kDecMaxOwn * kDecMaxCluster * kDecMaxUnits / kDecThreads;

// Whether a cluster holds the decoder cell of H units: the route, decided
// on the host before any launch.
bool dec_sweep_holds(int H) { return H > 0 && H <= kDecMaxCluster * kDecMaxUnits; }

// The cluster size: the smallest power of two with at most 16 units a CTA.
int dec_sweep_cluster(int H) {
  int n = 1;
  while ((H + n - 1) / n > kDecMaxUnits) n *= 2;
  return n;
}

// Units a CTA: H / n rounded up to a multiple of 4, so that a CTA's slice of
// a row is whole 16-byte pieces (units past H are idle).
int dec_sweep_units(int H, int n) { return ((H + n - 1) / n + 3) / 4 * 4; }

// Pitches in floats: dec_w's rows keep the attended half at [0, Hp) and the
// h half at [Hp, 2 Hp), Hp = H rounded up to 4 (fwd_depth), zeros between;
// rows of dec_w, h and the attended vector lie 4 floats more apart, so that
// the 8 units or 4 rows a warp reads at one k fall on distinct banks.
__host__ __device__ __forceinline__ int dec_wpitch(int H) { return 2 * fwd_depth(H) + 4; }
__host__ __device__ __forceinline__ int dec_hpitch(int H) { return fwd_depth(H) + 4; }
__host__ __device__ __forceinline__ int dec_own(int R, int n) { return (R + n - 1) / n; }
__host__ __device__ __forceinline__ int dec_spitch(int S) { return (S + 3) / 4 * 4; }

// Forward shared memory: dec_w's rows (4U), the attended vectors (R rows),
// two h buffers (2 R rows), the owned rows' scores.
size_t dec_fwd_smem_bytes(int H, int S, int U, int n, int R) {
  return (4ll * U * dec_wpitch(H) + 3ll * R * dec_hpitch(H) +
          static_cast<ll>(dec_own(R, n)) * dec_spitch(S)) * sizeof(float);
}

// Reverse shared memory: dec_w's rows (4U), the CTA's units' dpre of every
// row (R x 4U), the n CTAs' parts of the owned rows' dcat (own x n x 2Hp),
// the owned rows' dpre (own x 4Hp), dcat (own x 2Hp), dh and dc (own x Hp
// each), and their attention's ds, weights and mask (own x S each), and one
// total a row.
size_t dec_bwd_smem_bytes(int H, int S, int U, int n, int R) {
  const ll Hp = fwd_depth(H), own = dec_own(R, n);
  return (4ll * U * dec_wpitch(H) + 4ll * R * U + own * n * 2 * Hp + own * 8 * Hp +
          3 * own * dec_spitch(S) + (own + 3) / 4 * 4) * sizeof(float);
}

// Rows a thread owns in the reverse's dcat parts: the columns come in 2Hp / 4
// quads, and the rest of the 256 threads split the rows.
__host__ __device__ __forceinline__ int dec_bwd_quads(int H) { return fwd_depth(H) / 2; }
__host__ __device__ __forceinline__ int dec_bwd_row_sets(int H) {
  return kDecThreads / dec_bwd_quads(H);
}

struct DecSweepArgs {
  const float* enc;      // (S*B, H): the top encoder layer's outputs, rows s * B + b
  const float* src_m;    // (S*B): 1 at the source positions attention sees
  const float* w;        // dec_w (4H, 2H) = [W_ih[:, :H], W_hh]
  float* gates;          // (T*B, 4H): forward, pre-activations in, activated gates out;
                         // reverse, activated gates in, dpre out
  float* hdec;           // (B + T*B, H): h_{t-1} of step t at row block t
  float* cdec;           // (T*B, H)
  float* cat;            // forward: step t's [attended, h_prev] (B, 2H) at cat + t * cat_step
  ll cat_step;
  float* attn_w;         // (T, S*B)
  const float* dh_head;  // reverse: (T*B, H), the head's gradient reaching each step's h
  float* dh0;            // reverse: (B, H), the gradient reaching the initial h
  float* denc;           // reverse: (S*B, H), the encoder outputs' gradient (added to)
  int T, S, B, H, U, R;
};

// dec_w's rows of the CTA's units' gates into ws[q * U + u] (both halves at
// [0, Hp) and [Hp, 2 Hp)), zeros past H, asynchronously.
__device__ __forceinline__ void dec_load_w(float* ws, const float* w, int H, int U, int j0,
                                           int tid) {
  const int Hp = fwd_depth(H), wp = dec_wpitch(H);
  for (int e = tid; e < 4 * U * 2 * Hp; e += kDecThreads) {
    const int kk = e % (2 * Hp), qu = e / (2 * Hp);
    const int u = qu % U, q = qu / U, col = j0 + u;
    const int half = kk / Hp, k = kk % Hp;
    const bool valid = col < H && k < H;
    cp_async4(ws + static_cast<ll>(qu) * wp + kk,
              w + (valid ? (static_cast<ll>(q) * H + col) * 2 * H + half * H + k : 0), valid);
  }
  cp_async_commit();
}

// For the owned rows o (cluster row rank + n o, batch row b = row0 + rank +
// n o): out[o * sp + s] = enc_s(b) . v[o] summed by a warp as tf_attend does
// (lanes over k = lane, lane + 32, ..., then warp_sum) at the positions
// with m = 1, `pad` elsewhere; kDecScoreBatch positions a warp at a time.
// v[o] is at v + (rank + n o) * vs when by_rank, else at v + o * vs.
__device__ __forceinline__ void dec_scores(const float* enc, const float* src_m, int S, int B,
                                           int H, int row0, int rank, int n, int own, int R,
                                           const float* v, int vs, bool by_rank, float* out,
                                           int sp, float pad, int warp, int lane) {
  for (int e0 = kDecScoreBatch * warp; e0 < own * S; e0 += kDecScoreBatch * kDecWarps) {
    const float* ep[kDecScoreBatch];
    const float* vp[kDecScoreBatch];
    bool ok[kDecScoreBatch], real[kDecScoreBatch];
    float acc[kDecScoreBatch];
#pragma unroll
    for (int i = 0; i < kDecScoreBatch; ++i) {
      const int e = e0 + i, o = e / S, s = e % S, r = rank + n * o, b = row0 + r;
      ok[i] = e < own * S && r < R && b < B;
      real[i] = ok[i] && src_m[static_cast<ll>(s) * B + b] != 0.f;
      ep[i] = real[i] ? enc + (static_cast<ll>(s) * B + b) * H : enc;
      vp[i] = v + (ok[i] ? (by_rank ? r : o) : 0) * vs;
      acc[i] = 0.f;
    }
#pragma unroll 4
    for (int k = lane; k < H; k += 32) {
#pragma unroll
      for (int i = 0; i < kDecScoreBatch; ++i)
        if (real[i]) acc[i] = fmaf(ep[i][k], vp[i][k], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kDecScoreBatch; ++i) {
      if (real[i]) acc[i] = warp_sum(acc[i]);
      const int e = e0 + i;
      if (lane == 0 && ok[i]) out[e / S * sp + e % S] = real[i] ? acc[i] : pad;
    }
  }
}

// ------------------------------------------------------------------ forward
// The pre-activations of a thread's rows' four gates.
template <int RPT>
struct DecFwdIn {
  float pre[RPT][4];
};

// Grid: clusters of n CTAs of kDecThreads threads; RPT = fwd_rpt(R) rows a
// thread in the gates, fwd_groups(R) row groups. As tf_train.cu's per-step
// loop of tf_attend and lstm_fwd_step, from h_{-1} = hdec's first row block
// and c = 0.
template <int RPT>
__global__ void __launch_bounds__(kDecThreads, 1) tf_decoder_fwd_sweep(const DecSweepArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int T = a.T, S = a.S, B = a.B, H = a.H, U = a.U, R = a.R;
  const int row0 = static_cast<int>(blockIdx.x) / n * R, j0 = rank * U;
  const int Hp = fwd_depth(H), wp = dec_wpitch(H), hp = dec_hpitch(H), sp = dec_spitch(S);
  const int own = dec_own(R, n);
  const ll G4 = 4ll * H, SB = static_cast<ll>(S) * B, bh = static_cast<ll>(B) * H;
  float* ws = smem;                          // 4U rows of wp
  float* xa = ws + 4ll * U * wp;             // R rows of hp: the attended vectors
  float* hb = xa + static_cast<ll>(R) * hp;  // 2 x R rows: h_{t-1} at parity t & 1
  float* sc = hb + 2ll * R * hp;             // own rows of sp: scores, then weights
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  auto row_live = [&](int o) { return rank + n * o < R && row0 + rank + n * o < B; };

  dec_load_w(ws, a.w, H, U, j0, tid);
  // The attended vectors 0, h_{-1} = the encoder's final state, zeros past H
  // and past the batch.
  for (int e = tid; e < 3 * R * hp; e += kDecThreads) {
    const int r = e / hp % R, k = e % hp;
    const bool h0 = e / hp / R == 1 && k < H && row0 + r < B;
    xa[e] = h0 ? a.hdec[static_cast<ll>(row0 + r) * H + k] : 0.f;
  }

  // This thread's unit and rows in the gates: lanes run over 4 row groups,
  // then 8 units (lstm_fwd_sweep's layout).
  const int groups = fwd_groups(R);
  const bool gowner = tid < U * groups;
  const int u = gowner ? tid / 4 % U : 0, g = gowner ? tid / 4 / U * 4 + tid % 4 : 0;
  const int j = j0 + u;
  int r[RPT];
  bool live[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int rr = g + groups * i;
    live[i] = gowner && rr < R && row0 + rr < B && j < H;
    r[i] = rr < R ? rr : 0;  // a slot past R reads row 0 and writes nothing
  }
  auto load = [&](int t) {
    DecFwdIn<RPT> in;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float* gp = a.gates + (static_cast<ll>(t) * B + row0 + r[i]) * G4;
#pragma unroll
      for (int q = 0; q < 4; ++q) in.pre[i][q] = live[i] ? gp[q * H + j] : 0.f;
    }
    return in;
  };
  float c_state[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) c_state[i] = 0.f;
  cluster.sync();  // every CTA runs, its buffers set, before any copy into them

  for (int t = 0; t < T; ++t) {
    const float* hprev = hb + (t & 1) * R * hp;
    float* hnext = hb + ((t + 1) & 1) * R * hp;
    // 1. The owned rows' attention: scores, masked softmax (as tf_attend),
    // the attended vector and the residual row [attended, h_prev].
    dec_scores(a.enc, a.src_m, S, B, H, row0, rank, n, own, R, hprev, hp, true, sc, sp,
               -INFINITY, warp, lane);
    __syncthreads();
    for (int o = warp; o < own; o += kDecWarps) {
      if (!row_live(o)) continue;
      const int b = row0 + rank + n * o;
      float* w = sc + o * sp;
      float mx = -INFINITY;
      for (int s = lane; s < S; s += 32) mx = fmaxf(mx, w[s]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int s = lane; s < S; s += 32) {
        const float ex = w[s] == -INFINITY ? 0.f : expf(w[s] - mx);
        w[s] = ex;
        sum += ex;
      }
      sum = warp_sum(sum);
      for (int s = lane; s < S; s += 32) {
        w[s] /= sum;
        a.attn_w[t * SB + static_cast<ll>(s) * B + b] = w[s];
      }
    }
    __syncthreads();
    {
      // A thread's (row, unit) pairs e = tid, tid + 256, ..., each summed
      // over s in order, skipping weights of 0 (tf_attend's sum); eight
      // positions' loads of every pair at a time.
      float acc[kDecCellPairs];
      const float* col[kDecCellPairs];
      const float* w[kDecCellPairs];
      bool use[kDecCellPairs];
#pragma unroll
      for (int i = 0; i < kDecCellPairs; ++i) {
        const int e = tid + i * kDecThreads, o = e / H, k = e % H;
        use[i] = e < own * H && row_live(o);
        col[i] = a.enc + (use[i] ? static_cast<ll>(row0 + rank + n * o) * H + k : 0);
        w[i] = sc + (use[i] ? o : 0) * sp;
        acc[i] = 0.f;
      }
      for (int s0 = 0; s0 < S; s0 += 8) {
        float ev[kDecCellPairs][8];
#pragma unroll
        for (int i = 0; i < kDecCellPairs; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            ev[i][j] = use[i] && s0 + j < S ? col[i][static_cast<ll>(s0 + j) * bh] : 0.f;
#pragma unroll
        for (int i = 0; i < kDecCellPairs; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (use[i] && s0 + j < S && w[i][s0 + j] != 0.f)
              acc[i] = fmaf(w[i][s0 + j], ev[i][j], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < kDecCellPairs; ++i) {
        if (!use[i]) continue;
        const int e = tid + i * kDecThreads, o = e / H, k = e % H;
        const int rr = rank + n * o, b = row0 + rr;
        xa[rr * hp + k] = acc[i];
        float* row = a.cat + t * a.cat_step + static_cast<ll>(b) * 2 * H;
        row[k] = acc[i];
        row[H + k] = hprev[rr * hp + k];
      }
    }
    if (t == 0) cp_async_wait_all();  // dec_w's rows have landed
    __syncthreads();
    for (int e = tid; e < own * (Hp / 4); e += kDecThreads) {
      const int o = e / (Hp / 4);
      if (row_live(o))
        copy_to_peers(cluster, reinterpret_cast<uint4*>(xa + (rank + n * o) * hp) + e % (Hp / 4),
                      rank, n);
    }
    cluster_arrive();
    const DecFwdIn<RPT> cur = load(t);  // in flight through the wait
    cluster_wait();

    // 2. The gates of the CTA's units for every row: fmaf over the attended
    // half, then over h_{t-1}, from 0 (lstm_fwd_step's order), then the cell.
    float acc[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    if (gowner) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* x = half == 0 ? xa : hprev;
        const float* wrow = ws + half * Hp;
#pragma unroll 2
        for (int k = 0; k < Hp; k += 4) {
          float xv[RPT][4], wv[4][4];
#pragma unroll
          for (int i = 0; i < RPT; ++i) load4(x + r[i] * hp + k, xv[i]);
#pragma unroll
          for (int q = 0; q < 4; ++q) load4(wrow + static_cast<ll>(q * U + u) * wp + k, wv[q]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(xv[i][kk], wv[q][kk], acc[i][q]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const LstmGates act = lstm_activate(cur.pre[i][0] + acc[i][0], cur.pre[i][1] + acc[i][1],
                                          cur.pre[i][2] + acc[i][2], cur.pre[i][3] + acc[i][3]);
      float h, c, y;
      lstm_cell_forward(act, 0.f, c_state[i], 1.f, h, c, y);
      c_state[i] = c;
      if (!live[i]) continue;
      const ll row = static_cast<ll>(t) * B + row0 + r[i];
      float* gp = a.gates + row * G4;
      gp[j] = act.i;
      gp[H + j] = act.f;
      gp[2 * H + j] = act.g;
      gp[3 * H + j] = act.o;
      a.hdec[(row + B) * H + j] = h;
      a.cdec[row * H + j] = c;
      hnext[r[i] * hp + j] = h;
    }
    if (t + 1 < T) {
      // The CTA's units of h_t into every CTA of the cluster.
      __syncthreads();
      for (int e = tid; e < R * (U / 4); e += kDecThreads) {
        const int rr = e / (U / 4), p = e % (U / 4);
        if (row0 + rr < B && j0 + 4 * p < Hp)
          copy_to_peers(cluster, reinterpret_cast<uint4*>(hnext + rr * hp + j0) + p, rank, n);
      }
      cluster_arrive();
      cluster_wait();
    }
  }
  cp_async_wait_all();  // a pass without a step never waited for dec_w
}

// ------------------------------------------------------------------ reverse
// Grid: clusters of n CTAs of kDecThreads threads. From the forward's
// residuals (the activated gates, c, h and the attention weights) and the
// head's gradient dh_head; writes dpre over the gates, adds the attention's
// part to denc and writes dh0.
__global__ void __launch_bounds__(kDecThreads, 1) tf_decoder_bwd_sweep(const DecSweepArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int T = a.T, S = a.S, B = a.B, H = a.H, U = a.U, R = a.R;
  const int row0 = static_cast<int>(blockIdx.x) / n * R, j0 = rank * U;
  const int Hp = fwd_depth(H), wp = dec_wpitch(H), sp = dec_spitch(S);
  const int own = dec_own(R, n);
  const ll G4 = 4ll * H, SB = static_cast<ll>(S) * B, bh = static_cast<ll>(B) * H;
  float* ws = smem;                                   // 4U rows of wp
  float* dps = ws + 4ll * U * wp;                     // R rows of 4U: dpre of the CTA's units
  float* parts = dps + 4ll * R * U;                   // own x n rows of 2Hp: parts of dcat
  float* stage = parts + static_cast<ll>(own) * n * 2 * Hp;  // own rows of 4Hp: their dpre
  float* dcat = stage + own * 4 * Hp;                 // own rows of 2Hp
  float* dh = dcat + own * 2 * Hp;                    // own rows of Hp: gradient reaching h_t
  float* dc = dh + own * Hp;                          // own rows of Hp: the dc carry
  float* ds = dc + own * Hp;                          // own rows of sp: w dw, then ds
  float* wt = ds + own * sp;                          // own rows of sp: the attention weights
  float* mk = wt + own * sp;                          // own rows of sp: the source mask
  float* tot = mk + own * sp;                         // own: sum over s of w dw
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  auto row_live = [&](int o) { return rank + n * o < R && row0 + rank + n * o < B; };

  dec_load_w(ws, a.w, H, U, j0, tid);
  for (int e = tid; e < 4 * R * U + own * (n * 2 + 4) * Hp; e += kDecThreads) dps[e] = 0.f;
  for (int e = tid; e < own * Hp; e += kDecThreads) {
    const int o = e / Hp, k = e % Hp;
    const bool ok = row_live(o) && k < H;
    dh[e] = ok ? a.dh_head[(static_cast<ll>(T - 1) * B + row0 + rank + n * o) * H + k] : 0.f;
    dc[e] = 0.f;
  }

  // This thread's column quad and rows in the dcat parts.
  const int quads = dec_bwd_quads(H), sets = dec_bwd_row_sets(H);
  const bool powner = tid < quads * sets;
  const int cq = powner ? tid % quads : 0, rs = powner ? tid / quads : 0;
  cluster.sync();  // every CTA runs, its buffers set, before any copy into them

  for (int t = T - 1; t >= 0; --t) {
    // 1. The cell backward of every unit of the owned rows; dpre over the
    // gates, and each CTA's units' slice of it into that CTA's dps.
    // A thread's (row, unit) pairs are e = tid, tid + 256, ... (at most
    // kDecCellPairs); all their loads go before any store.
    LstmGates act[kDecCellPairs];
    float c_post[kDecCellPairs], c_prev[kDecCellPairs];
#pragma unroll
    for (int i = 0; i < kDecCellPairs; ++i) {
      const int e = tid + i * kDecThreads, o = e / H, k = e % H;
      if (e >= own * H || !row_live(o)) continue;
      const ll row = static_cast<ll>(t) * B + row0 + rank + n * o;
      const float* gp = a.gates + row * G4;
      act[i] = LstmGates{gp[k], gp[H + k], gp[2 * H + k], gp[3 * H + k]};
      c_post[i] = a.cdec[row * H + k];
      c_prev[i] = t > 0 ? a.cdec[(row - B) * H + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kDecCellPairs; ++i) {
      const int e = tid + i * kDecThreads, o = e / H, k = e % H;
      if (e >= own * H || !row_live(o)) continue;
      float dpre[4], dh_carry, dc_carry;
      lstm_cell_backward(act[i], c_post[i], c_prev[i], 1.f, dh[o * Hp + k], dc[o * Hp + k], dpre,
                         dh_carry, dc_carry);
      dc[o * Hp + k] = dc_carry;
      float* gp = a.gates + (static_cast<ll>(t) * B + row0 + rank + n * o) * G4;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        gp[q * H + k] = dpre[q];
        stage[o * 4 * Hp + q * Hp + k] = dpre[q];
      }
    }
    __syncthreads();
    for (int e = tid; e < own * Hp; e += kDecThreads) {  // 16-byte pieces: (o, gate, 4 units)
      const int o = e / Hp, q = e % Hp / (Hp / 4), k = 4 * (e % (Hp / 4));
      if (!row_live(o)) continue;
      const int c = k / U;
      const float4 v = *reinterpret_cast<const float4*>(stage + o * 4 * Hp + q * Hp + k);
      float4* slot = reinterpret_cast<float4*>(dps + (rank + n * o) * 4 * U + q * U + k - c * U);
      *cluster.map_shared_rank(slot, c) = v;
    }
    cluster_arrive();
    cluster_wait();

    // 2. The CTA's part of dcat = dpre . dec_w for every row: its 4U gate
    // rows, g = 0, 1, ... in order, into each row's owner.
    if (t == T - 1) {
      cp_async_wait_all();  // dec_w's rows have landed
      __syncthreads();
    }
    if (powner) {
      float acc[kDecBwdMaxRpt][4];
#pragma unroll
      for (int i = 0; i < kDecBwdMaxRpt; ++i)
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) acc[i][c4] = 0.f;
      for (int gq = 0; gq < 4 * U; gq += 4) {
        float wv[4][4];
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) load4(ws + static_cast<ll>(gq + gg) * wp + 4 * cq, wv[gg]);
#pragma unroll
        for (int i = 0; i < kDecBwdMaxRpt; ++i) {
          const int rr = rs + sets * i;
          if (rr < R) {
            float d[4];
            load4(dps + rr * 4 * U + gq, d);
#pragma unroll
            for (int gg = 0; gg < 4; ++gg)
#pragma unroll
              for (int c4 = 0; c4 < 4; ++c4) acc[i][c4] = fmaf(d[gg], wv[gg][c4], acc[i][c4]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kDecBwdMaxRpt; ++i) {
        const int rr = rs + sets * i;
        if (rr < R && row0 + rr < B) {
          float4* slot = reinterpret_cast<float4*>(parts + ((rr / n) * n + rank) * 2 * Hp + 4 * cq);
          *cluster.map_shared_rank(slot, rr % n) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      }
    }
    cluster_arrive();
    cluster_wait();

    // 3. The owned rows: dcat, the sum of the n parts in rank order, then
    // the attention backward (tf_attend_bwd's steps).
    for (int e = tid; e < own * 2 * Hp; e += kDecThreads) {
      const int o = e / (2 * Hp), kk = e % (2 * Hp);
      if (!row_live(o)) continue;
      const float* p = parts + static_cast<ll>(o) * n * 2 * Hp + kk;
      float v = p[0];
      for (int c = 1; c < n; ++c) v += p[c * 2 * Hp];
      dcat[e] = v;
    }
    for (int e = tid; e < own * S; e += kDecThreads) {
      const int o = e / S, s = e % S;
      if (!row_live(o)) continue;
      const ll idx = static_cast<ll>(s) * B + row0 + rank + n * o;
      wt[o * sp + s] = a.attn_w[t * SB + idx];
      mk[o * sp + s] = a.src_m[idx];
    }
    __syncthreads();
    dec_scores(a.enc, a.src_m, S, B, H, row0, rank, n, own, R, dcat, 2 * Hp, false, ds, sp,
               0.f, warp, lane);
    __syncthreads();
    for (int o = warp; o < own; o += kDecWarps) {  // w dw, then its sum over s
      if (!row_live(o)) continue;
      float sum = 0.f;
      for (int s = lane; s < S; s += 32) {
        ds[o * sp + s] *= wt[o * sp + s];
        sum += ds[o * sp + s];
      }
      sum = warp_sum(sum);
      if (lane == 0) tot[o] = sum;
    }
    __syncthreads();
    for (int e = tid; e < own * S; e += kDecThreads) {
      const int o = e / S, s = e % S;
      if (row_live(o)) ds[o * sp + s] -= wt[o * sp + s] * tot[o];
    }
    __syncthreads();
    {
      // A thread's (row, unit) pairs, eight positions' loads of every pair
      // at a time, all before their stores (denc might alias enc, so a
      // store would hold back the next loads).
      float acc[kDecCellPairs], hk[kDecCellPairs], ak[kDecCellPairs];
      ll col[kDecCellPairs];
      int ob[kDecCellPairs];
      bool use[kDecCellPairs];
#pragma unroll
      for (int i = 0; i < kDecCellPairs; ++i) {
        const int e = tid + i * kDecThreads, o = e / H, k = e % H;
        use[i] = e < own * H && row_live(o);
        ob[i] = use[i] ? o : 0;
        col[i] = use[i] ? static_cast<ll>(row0 + rank + n * o) * H + k : 0;
        hk[i] = use[i] ? a.hdec[static_cast<ll>(t) * bh + col[i]] : 0.f;
        ak[i] = use[i] ? dcat[o * 2 * Hp + k] : 0.f;
        acc[i] = 0.f;
      }
      for (int s0 = 0; s0 < S; s0 += 8) {
        float ev[kDecCellPairs][8], dv[kDecCellPairs][8];
#pragma unroll
        for (int i = 0; i < kDecCellPairs; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const bool real = use[i] && s0 + j < S && mk[ob[i] * sp + s0 + j] != 0.f;
            const ll idx = static_cast<ll>(real ? s0 + j : 0) * bh + col[i];
            ev[i][j] = real ? a.enc[idx] : 0.f;
            dv[i][j] = real ? a.denc[idx] : 0.f;
          }
#pragma unroll
        for (int i = 0; i < kDecCellPairs; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int s = s0 + j;
            if (use[i] && s < S && mk[ob[i] * sp + s] != 0.f) {
              const float dss = ds[ob[i] * sp + s];
              acc[i] = fmaf(dss, ev[i][j], acc[i]);
              a.denc[static_cast<ll>(s) * bh + col[i]] =
                  dv[i][j] + (dss * hk[i] + wt[ob[i] * sp + s] * ak[i]);
            }
          }
      }
#pragma unroll
      for (int i = 0; i < kDecCellPairs; ++i) {
        if (!use[i]) continue;
        const int e = tid + i * kDecThreads, o = e / H, k = e % H;
        const float v = acc[i] + dcat[o * 2 * Hp + Hp + k] +
                        (t > 0 ? a.dh_head[static_cast<ll>(t - 1) * bh + col[i]] : 0.f);
        if (t > 0)
          dh[o * Hp + k] = v;
        else
          a.dh0[col[i]] = v;
      }
    }
    __syncthreads();
  }
  cp_async_wait_all();  // a pass without a step never waited for dec_w
}

// ------------------------------------------------------------------ plans and launches
typedef void (*DecSweep)(const DecSweepArgs);

// The forward's instance for R rows a cluster (rows a thread: fwd_rpt).
DecSweep dec_fwd_kernel(int R) {
  switch (fwd_rpt(R)) {
    case 1: return tf_decoder_fwd_sweep<1>;
    case 2: return tf_decoder_fwd_sweep<2>;
    case 3: return tf_decoder_fwd_sweep<3>;
    default: return tf_decoder_fwd_sweep<4>;
  }
}

// Rows a cluster at most: kDecMaxOwn a CTA; the forward's 4 a thread in 16
// row groups; the reverse's kDecBwdMaxRpt a thread of the dcat parts.
int dec_row_cap(int H, int n, bool forward) {
  const int own = kDecMaxOwn * n;
  const int cap = forward ? kDecFwdMaxRows : kDecBwdMaxRpt * dec_bwd_row_sets(H);
  return own < cap ? own : cap;
}

// The plan of a decoder sweep for B rows of H units over S source
// positions, forward or reverse (plan_for: the occupancy is read at the
// widest instance). cudaErrorInvalidValue where no cluster holds the cell.
cudaError_t dec_sweep_plan(int H, int S, int B, bool forward, cudaStream_t s, SweepPlan* plan) {
  if (!dec_sweep_holds(H) || S < 1) return cudaErrorInvalidValue;
  const int n = dec_sweep_cluster(H), U = dec_sweep_units(H, n);
  const DecSweep widest = forward ? tf_decoder_fwd_sweep<kFwdMaxRpt> : tf_decoder_bwd_sweep;
  return plan_for(
      widest,
      [=](int R) {
        return forward ? dec_fwd_smem_bytes(H, S, U, n, R) : dec_bwd_smem_bytes(H, S, U, n, R);
      },
      [](int) { return kDecThreads; }, dec_row_cap(H, n, forward), n, U, B, s, plan);
}

// One decoder sweep over a pass, forward or reverse; `a` without the plan.
cudaError_t dec_sweep_launch(cudaStream_t s, DecSweepArgs a, bool forward) {
  SweepPlan p;
  SWEEP_TRY(dec_sweep_plan(a.H, a.S, a.B, forward, s, &p));
  a.U = p.units;
  a.R = p.rows;
  const DecSweep kernel = forward ? dec_fwd_kernel(p.rows) : tf_decoder_bwd_sweep;
  SWEEP_TRY(sweep_attributes(kernel, p.smem, p.cluster));
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  sweep_config(p.cluster, p.threads, p.smem, p.clusters, s, &cfg, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

}  // namespace
}  // namespace probnmn
