// Kernels K3f and K3b: the ProgramPrior LM loss (masked multi-layer LSTM
// over [start, program, end], projection, logits through the tied embedding,
// per-example masked cross entropy) and its backward, in float32 on the SIMT
// cores.
//
// Replaces probnmn_tpu/ops/pallas/seq2seq_train.py::_lm_forward_kernel (K3f)
// and ::_lm_backward_kernel (K3b), the two halves of the custom VJP
// `fused_lm_loss`. The TPU ran each as one kernel over batch blocks with
// every step's matmuls inside a fori_loop; here the work is ordered by what
// depends on what:
//
// - Forward, layer by layer. A layer's input product x . W_ih^T is known for
//   all T steps at once, so it is one tiled GEMM over T*B rows (with the
//   summed bias in its epilogue). Only h . W_hh^T and the cell are serial:
//   one launch per step, each block owning 32 rows x 16 hidden units (all
//   four gates of them), so the cell and the pad freeze fuse into the
//   product's epilogue. The head (projection, logits, log-sum-exp, CE) runs
//   over all T*B rows at once.
// - Backward (K3b replays the forward first, keeping h, c and the activated
//   gates of every step in the workspace). The head's gradients are GEMMs
//   over all rows; then the top layer is swept over all steps (one launch per
//   step: dpre_{t+1} . W_hh plus the cell backward, writing dpre over the
//   gates), the lower layer's dh input for all steps is one GEMM
//   (dpre . W_ih), and the next layer down is swept. Layers couple only
//   through x/dx at the same step, so this equals the TPU's step-interleaved
//   sweep.
// - Weight gradients are contractions over T*B = 6,912 rows: the same GEMM
//   with split-K, its partial sums added in a fixed order by a second pass.
//   The bias gradient is a column sum, split the same way.
// - The embedding's input-side gradient is reduced per token id (one block
//   per (id, 256-row chunk), rows visited in order, chunks added in order):
//   deterministic, no float atomics. Its output side (dlogits^T . proj_out,
//   pad row included) is a split-K GEMM.
//
// What bounds it on an H100: at B=256, T=27, D=H=256, V=44, 2 layers, K3f is
// ~15.6 GFLOP (0.23 ms at the 67 TFLOP/s float32 SIMT peak) and K3b ~46.8
// GFLOP (0.70 ms); bytes in and out are a few MB, so both are bound by
// operations, and in this first version by the 2*T serial launches, each too
// small to fill the card. Later work, not done here: a persistent kernel with
// grid sync over the steps, W_hh (1 MB) held in shared memory across a
// cluster, TF32/bf16 on the tensor cores (wgmma), double-buffered GEMM tiles.
//
// Every entry point launches on the caller's stream, allocates nothing (the
// caller passes a workspace of probnmn_lm_workspace_floats() floats) and
// returns cudaGetLastError().

#include "lstm.cuh"

namespace probnmn {
namespace {

typedef long long ll;

// ------------------------------------------------------------------ GEMM
// C[m, n] (+)= sum_k A[m, k] B[k, n] (+ bias[n]), A and B addressed through
// strides so that transposed operands need no copy. 64 x 64 tiles, depth 16,
// 256 threads with 4 x 4 outputs each. With gridDim.z > 1 each z sums its
// own k_chunk into partial + z * M * N, and splitk_reduce adds the partials.
constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;
constexpr int kSplitRows = 512;  // K per split of the weight-gradient contractions
constexpr int kChunkRows = 256;  // rows per block of the column sums and the embedding gradient

struct GemmArgs {
  const float* A;
  ll sam, sak;
  const float* B;
  ll sbk, sbn;
  float* C;  // row-major, leading dimension ldc; or the split-K partials
  ll ldc;
  const float* bias;
  int M, N, K, k_chunk;
  bool accumulate;
};

__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs g) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * g.k_chunk;
  const int k_end = min(g.K, k_begin + g.k_chunk);
  const bool a_k_fast = g.sak == 1;
  const bool b_n_fast = g.sbn == 1;
  float acc[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kGemmThreads) {
      const int mm = a_k_fast ? e / kBK : e % kBM;
      const int kk = a_k_fast ? e % kBK : e / kBM;
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < g.M && k < k_end) ? g.A[m * g.sam + k * g.sak] : 0.f;
    }
    for (int e = tid; e < kBN * kBK; e += kGemmThreads) {
      const int nn = b_n_fast ? e % kBN : e / kBK;
      const int kk = b_n_fast ? e / kBN : e % kBK;
      const int n = n0 + nn, k = k0 + kk;
      Bs[kk][nn] = (n < g.N && k < k_end) ? g.B[k * g.sbk + n * g.sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  const bool split = gridDim.z > 1;
  float* out = split ? g.C + static_cast<ll>(blockIdx.z) * g.M * g.N : g.C;
  const ll ld = split ? g.N : g.ldc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.N) continue;
      float v = acc[i][j];
      if (g.bias != nullptr) v += g.bias[n];
      float* dst = out + m * ld + n;
      *dst = (!split && g.accumulate) ? *dst + v : v;
    }
  }
}

// C[m, n] (+)= sum over s of partial[s][m][n], in the order s = 0, 1, ...
__global__ void splitk_reduce(const float* __restrict__ partial, int splits, int M, int N,
                              float* C, ll ldc, bool accumulate) {
  const ll idx = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  const ll total = static_cast<ll>(M) * N;
  if (idx >= total) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[s * total + idx];
  float* dst = C + (idx / N) * ldc + idx % N;
  *dst = accumulate ? *dst + v : v;
}

int ceil_div(ll a, ll b) { return static_cast<int>((a + b - 1) / b); }

// `partial` non-null: split K into kSplitRows chunks (for the long
// contractions over T*B rows) and add them in a fixed order.
cudaError_t gemm(cudaStream_t s, const float* A, ll sam, ll sak, const float* B, ll sbk, ll sbn,
                 float* C, ll ldc, int M, int N, int K, const float* bias, bool accumulate,
                 float* partial) {
  GemmArgs g{A, sam, sak, B, sbk, sbn, C, ldc, bias, M, N, K, K, accumulate};
  int splits = 1;
  if (partial != nullptr && K > kSplitRows) {
    splits = ceil_div(K, kSplitRows);
    g.k_chunk = kSplitRows;
    g.C = partial;
  }
  const dim3 grid(ceil_div(N, kBN), ceil_div(M, kBM), splits);
  gemm_kernel<<<grid, kGemmThreads, 0, s>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  splitk_reduce<<<ceil_div(static_cast<ll>(M) * N, 256), 256, 0, s>>>(partial, splits, M, N, C,
                                                                       ldc, accumulate);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ token streams
// Row r = t * B + b of every (T, B) array. Labels are the program with @end@
// after its last token and pad after that; inputs are [start, labels[:-1]];
// m_in is 1 where the input is not pad. Ids outside [0, V) are clamped so
// that no read leaves the embedding; the trainer and the evaluator reject
// such ids on the host first (ProgramPriorDataset.check_tokens).
__global__ void lm_prep(const int* __restrict__ tok, int B, int Lt, int V, int pad, int start,
                        int end, int* lm_in, int* label, float* m_in) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int T = Lt + 1;
  if (idx >= T * B) return;
  const int t = idx / B, b = idx % B;
  const int* row = tok + static_cast<ll>(b) * Lt;
  int lens = 0;
  for (int i = 0; i < Lt; ++i) lens += row[i] != pad;
  auto with_end = [&](int s) { return s < lens ? row[s] : (s == lens ? end : pad); };
  const int lab = min(max(with_end(t), 0), V - 1);
  const int in = min(max(t == 0 ? start : with_end(t - 1), 0), V - 1);
  lm_in[idx] = in;
  label[idx] = lab;
  m_in[idx] = in != pad ? 1.f : 0.f;
}

// x0[r] = embedding[lm_in[r]] * m_in[r]
__global__ void lm_embed(const float* __restrict__ emb, const int* __restrict__ lm_in,
                         const float* __restrict__ m_in, float* x0, int TB, int D) {
  const ll idx = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<ll>(TB) * D) return;
  const int r = static_cast<int>(idx / D), d = static_cast<int>(idx % D);
  x0[idx] = m_in[r] != 0.f ? emb[static_cast<ll>(lm_in[r]) * D + d] : 0.f;
}

// ------------------------------------------------------------------ recurrent steps
// One forward step of one layer. `gates` holds this step's x . W_ih^T + bias
// (B, 4H) and receives the activated gates. Block: 32 rows x 16 units; thread
// (unit u, rows rl and rl + 16) keeps all four gates of its unit.
constexpr int kFRows = 32, kFUnits = 16, kFK = 32;

__global__ void __launch_bounds__(256)
lstm_fwd_step(const float* __restrict__ h_prev, const float* __restrict__ c_prev,
              const float* __restrict__ w_hh, float* gates, const float* __restrict__ m,
              float* h_out, float* c_out, float* y_out, int B, int H) {
  __shared__ float hs[kFRows][kFK + 1];
  __shared__ float ws[4 * kFUnits][kFK + 1];
  const int tid = threadIdx.x;
  const int u = tid % kFUnits, rl = tid / kFUnits;
  const int j0 = blockIdx.x * kFUnits, b0 = blockIdx.y * kFRows;
  float acc[2][4] = {};
  if (h_prev != nullptr) {
    for (int k0 = 0; k0 < H; k0 += kFK) {
      for (int e = tid; e < kFRows * kFK; e += 256) {
        const int rr = e / kFK, kk = e % kFK;
        const int b = b0 + rr, k = k0 + kk;
        hs[rr][kk] = (b < B && k < H) ? h_prev[static_cast<ll>(b) * H + k] : 0.f;
      }
      for (int e = tid; e < 4 * kFUnits * kFK; e += 256) {
        const int gr = e / kFK, kk = e % kFK;
        const int j = j0 + gr % kFUnits, k = k0 + kk;
        const int grow = (gr / kFUnits) * H + j;
        ws[gr][kk] = (j < H && k < H) ? w_hh[static_cast<ll>(grow) * H + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kFK; ++kk) {
        const float a0 = hs[rl][kk], a1 = hs[rl + 16][kk];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float w = ws[q * kFUnits + u][kk];
          acc[0][q] = fmaf(a0, w, acc[0][q]);
          acc[1][q] = fmaf(a1, w, acc[1][q]);
        }
      }
      __syncthreads();
    }
  }
  const int j = j0 + u;
  if (j >= H) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int b = b0 + rl + 16 * rr;
    if (b >= B) continue;
    float* gp = gates + static_cast<ll>(b) * 4 * H;
    const LstmGates a = lstm_activate(gp[j] + acc[rr][0], gp[H + j] + acc[rr][1],
                                      gp[2 * H + j] + acc[rr][2], gp[3 * H + j] + acc[rr][3]);
    gp[j] = a.i;
    gp[H + j] = a.f;
    gp[2 * H + j] = a.g;
    gp[3 * H + j] = a.o;
    const ll idx = static_cast<ll>(b) * H + j;
    const float hp = h_prev != nullptr ? h_prev[idx] : 0.f;
    const float cp = c_prev != nullptr ? c_prev[idx] : 0.f;
    float h, c, y;
    lstm_cell_forward(a, hp, cp, m[b], h, c, y);
    h_out[idx] = h;
    c_out[idx] = c;
    y_out[idx] = y;
  }
}

// One backward step of one layer. dh = dh_state + dpre_{t+1} . W_hh + ext * m,
// dc = dc_state; the cell backward writes this step's dpre over its gates and
// leaves the carries in dh_state / dc_state. Block: 32 rows x 32 units;
// thread (unit u, rows rl + 8 i).
constexpr int kBRows = 32, kBUnits = 32, kBKd = 32;

__global__ void __launch_bounds__(256)
lstm_bwd_step(const float* __restrict__ dpre_next, const float* __restrict__ w_hh, float* gates,
              const float* __restrict__ c_post, const float* __restrict__ c_prev,
              const float* __restrict__ m, const float* __restrict__ ext, float* dh_state,
              float* dc_state, int B, int H) {
  __shared__ float ds[kBRows][kBKd + 1];
  __shared__ float ws[kBKd][kBUnits + 1];
  const int tid = threadIdx.x;
  const int u = tid % kBUnits, rl = tid / kBUnits;
  const int j0 = blockIdx.x * kBUnits, b0 = blockIdx.y * kBRows;
  const int G = 4 * H;
  float acc[4] = {};
  if (dpre_next != nullptr) {
    for (int k0 = 0; k0 < G; k0 += kBKd) {
      for (int e = tid; e < kBRows * kBKd; e += 256) {
        const int rr = e / kBKd, kk = e % kBKd;
        const int b = b0 + rr, k = k0 + kk;
        ds[rr][kk] = (b < B && k < G) ? dpre_next[static_cast<ll>(b) * G + k] : 0.f;
      }
      for (int e = tid; e < kBKd * kBUnits; e += 256) {
        const int kk = e / kBUnits, uu = e % kBUnits;
        const int k = k0 + kk, j = j0 + uu;
        ws[kk][uu] = (k < G && j < H) ? w_hh[static_cast<ll>(k) * H + j] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBKd; ++kk) {
        const float w = ws[kk][u];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(ds[rl + 8 * i][kk], w, acc[i]);
      }
      __syncthreads();
    }
  }
  const int j = j0 + u;
  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + rl + 8 * i;
    if (b >= B) continue;
    const ll idx = static_cast<ll>(b) * H + j;
    const float mm = m[b];
    const float dh = dh_state[idx] + acc[i] + ext[idx] * mm;
    float* gp = gates + static_cast<ll>(b) * G;
    const LstmGates a{gp[j], gp[H + j], gp[2 * H + j], gp[3 * H + j]};
    float dpre[4], dh_carry, dc_carry;
    lstm_cell_backward(a, c_post[idx], c_prev != nullptr ? c_prev[idx] : 0.f, mm, dh,
                       dc_state[idx], dpre, dh_carry, dc_carry);
    gp[j] = dpre[0];
    gp[H + j] = dpre[1];
    gp[2 * H + j] = dpre[2];
    gp[3 * H + j] = dpre[3];
    dh_state[idx] = dh_carry;
    dc_state[idx] = dc_carry;
  }
}

// ------------------------------------------------------------------ head
// One warp per row r: ce[r] = (label != pad) * (logsumexp(logits[r]) - logits[r, label]).
__global__ void lm_head_fwd(const float* __restrict__ logits, const int* __restrict__ label,
                            float* ce, int rows, int V, int pad) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;
  const float* lg = logits + static_cast<ll>(r) * V;
  float mx = -INFINITY;
  for (int v = lane; v < V; v += 32) mx = fmaxf(mx, lg[v]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int v = lane; v < V; v += 32) sum += expf(lg[v] - mx);
  sum = warp_sum(sum);
  if (lane == 0) {
    const int lab = label[r];
    ce[r] = lab != pad ? logf(sum) + mx - lg[lab] : 0.f;
  }
}

// One warp per row, in place: logits[r] <- dnum[b] * (label != pad) * (softmax - onehot(label)).
__global__ void lm_head_bwd(float* logits, const int* __restrict__ label,
                            const float* __restrict__ dnum, int rows, int B, int V, int pad) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;
  float* lg = logits + static_cast<ll>(r) * V;
  float mx = -INFINITY;
  for (int v = lane; v < V; v += 32) mx = fmaxf(mx, lg[v]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int v = lane; v < V; v += 32) sum += expf(lg[v] - mx);
  sum = warp_sum(sum);
  const int lab = label[r];
  const float scale = lab != pad ? dnum[r % B] : 0.f;
  for (int v = lane; v < V; v += 32) {
    const float p = expf(lg[v] - mx) / sum;
    lg[v] = scale * (p - (v == lab ? 1.f : 0.f));
  }
}

// Per example b, summing over t in order: den = number of real labels,
// loss = sum ce / (den + 1e-13) (when `loss` is given), and
// dnum = dloss / (den + 1e-13) (when `dnum` is given).
__global__ void lm_rows(const float* __restrict__ ce, const int* __restrict__ label,
                        const float* __restrict__ dloss, float* loss, float* dnum, int B, int T,
                        int pad) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float num = 0.f, den = 0.f;
  for (int t = 0; t < T; ++t) {
    const int r = t * B + b;
    den += label[r] != pad ? 1.f : 0.f;
    if (ce != nullptr) num += ce[r];
  }
  if (loss != nullptr) loss[b] = num / (den + 1e-13f);
  if (dnum != nullptr) dnum[b] = dloss[b] / (den + 1e-13f);
}

// ------------------------------------------------------------------ reductions
// partial[s][c] = sum of x[r][c] over the rows of chunk s, in order.
__global__ void colsum_partial(const float* __restrict__ x, int rows, int cols, float* partial) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * kChunkRows, r1 = min(rows, r0 + kChunkRows);
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) acc += x[static_cast<ll>(r) * cols + c];
  partial[static_cast<ll>(blockIdx.y) * cols + c] = acc;
}

// The embedding's input-side gradient, per token id v = blockIdx.x and row
// chunk s = blockIdx.y: partial[s][v] = sum of dx0[r] over the chunk's rows
// whose input is v, in row order. Pad inputs are masked (m_in = 0), so the
// pad row gets nothing here.
__global__ void embed_grad_partial(const float* __restrict__ dx0, const int* __restrict__ lm_in,
                                   int rows, int D, int V, int pad, float* partial) {
  __shared__ int ids[kChunkRows];
  const int v = blockIdx.x, s = blockIdx.y;
  const int r0 = s * kChunkRows, n = min(rows - r0, kChunkRows);
  for (int i = threadIdx.x; i < n; i += blockDim.x) ids[i] = lm_in[r0 + i];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    if (v != pad)
      for (int i = 0; i < n; ++i)
        if (ids[i] == v) acc += dx0[static_cast<ll>(r0 + i) * D + d];
    partial[(static_cast<ll>(s) * V + v) * D + d] = acc;
  }
}

// ------------------------------------------------------------------ host side
struct Dims {
  int B, Lt, T, TB, D, H, L, V;
  ll G;  // 4H
};

struct Weights {
  const int* tokens;
  const float *emb, *proj, *w_ih, *w_hh, *bias;
  int pad, start, end;
  const float* wih(const Dims& d, int l) const {
    return w_ih + (l == 0 ? 0 : d.G * d.D + (l - 1) * d.G * d.H);
  }
  const float* whh(const Dims& d, int l) const { return w_hh + l * d.G * d.H; }
};

struct Workspace {
  int *lm_in, *label;
  float *m_in, *x0, *gates, *h, *c, *y, *proj_out, *logits, *ce, *dnum;
  float *dproj_out, *e0, *e1, *dh, *dc, *partial;
  ll layer_gates, layer_h;  // strides between layers; 0 when they share one buffer
};

ll partial_floats(const Dims& d) {
  const ll splits = (d.TB + kSplitRows - 1) / kSplitRows;
  const ll chunks = (d.TB + kChunkRows - 1) / kChunkRows;
  const ll widest = d.G * (d.D > d.H ? d.D : d.H);
  ll n = splits * widest;
  n = n > splits * d.V * d.D ? n : splits * d.V * d.D;
  n = n > splits * d.D * d.H ? n : splits * d.D * d.H;
  n = n > chunks * d.G ? n : chunks * d.G;
  n = n > chunks * d.V * d.D ? n : chunks * d.V * d.D;
  return n;
}

// Carves the workspace; returns its size in floats (ints take a float's 4 bytes).
// The forward alone keeps one layer's gates/h/c/y and reuses them; the
// backward keeps every layer's.
ll layout(const Dims& d, bool backward, float* base, Workspace* w) {
  const ll TB = d.TB, layers = backward ? d.L : 1;
  ll off = 0;
  auto take = [&](ll n) {
    float* p = base != nullptr ? base + off : nullptr;
    off += (n + 3) / 4 * 4;  // keep every array 16-byte aligned
    return p;
  };
  Workspace ws{};
  ws.lm_in = reinterpret_cast<int*>(take(TB));
  ws.label = reinterpret_cast<int*>(take(TB));
  ws.m_in = take(TB);
  ws.x0 = take(TB * d.D);
  ws.layer_gates = backward ? TB * d.G : 0;
  ws.layer_h = backward ? TB * d.H : 0;
  ws.gates = take(layers * TB * d.G);
  ws.h = take(layers * TB * d.H);
  ws.c = take(layers * TB * d.H);
  ws.y = take(layers * TB * d.H);
  ws.proj_out = take(TB * d.D);
  ws.logits = take(TB * d.V);
  ws.ce = take(TB);
  ws.dnum = take(d.B);
  if (backward) {
    const ll wide = TB * (d.D > d.H ? d.D : d.H);
    ws.dproj_out = take(TB * d.D);
    ws.e0 = take(wide);
    ws.e1 = take(wide);
    ws.dh = take(static_cast<ll>(d.B) * d.H);
    ws.dc = take(static_cast<ll>(d.B) * d.H);
    ws.partial = take(partial_floats(d));
  }
  if (w != nullptr) *w = ws;
  return off;
}

#define LM_TRY(expr)                          \
  do {                                        \
    const cudaError_t err_ = (expr);          \
    if (err_ != cudaSuccess) return err_;     \
  } while (0)

#define LM_LAUNCHED() LM_TRY(cudaGetLastError())

// The forward through the logits, into the workspace.
cudaError_t forward_pass(const Dims& d, const Weights& wt, const Workspace& ws, cudaStream_t s) {
  const ll TB = d.TB;
  lm_prep<<<ceil_div(TB, 256), 256, 0, s>>>(wt.tokens, d.B, d.Lt, d.V, wt.pad, wt.start, wt.end,
                                             ws.lm_in, ws.label, ws.m_in);
  LM_LAUNCHED();
  lm_embed<<<ceil_div(TB * d.D, 256), 256, 0, s>>>(wt.emb, ws.lm_in, ws.m_in, ws.x0, d.TB, d.D);
  LM_LAUNCHED();
  const dim3 step_grid(ceil_div(d.H, kFUnits), ceil_div(d.B, kFRows));
  for (int l = 0; l < d.L; ++l) {
    const int din = l == 0 ? d.D : d.H;
    const float* x = l == 0 ? ws.x0 : ws.y + (l - 1) * ws.layer_h;
    float* gates = ws.gates + l * ws.layer_gates;
    float* h = ws.h + l * ws.layer_h;
    float* c = ws.c + l * ws.layer_h;
    float* y = ws.y + l * ws.layer_h;
    LM_TRY(gemm(s, x, din, 1, wt.wih(d, l), 1, din, gates, d.G, d.TB, static_cast<int>(d.G), din,
                wt.bias + l * d.G, false, nullptr));
    const float* whh = wt.whh(d, l);
    const ll bh = static_cast<ll>(d.B) * d.H;
    for (int t = 0; t < d.T; ++t) {
      lstm_fwd_step<<<step_grid, 256, 0, s>>>(
          t > 0 ? h + (t - 1) * bh : nullptr, t > 0 ? c + (t - 1) * bh : nullptr, whh,
          gates + t * d.B * d.G, ws.m_in + t * d.B, h + t * bh, c + t * bh, y + t * bh, d.B, d.H);
      LM_LAUNCHED();
    }
  }
  const float* top = ws.y + (d.L - 1) * ws.layer_h;
  LM_TRY(gemm(s, top, d.H, 1, wt.proj, 1, d.H, ws.proj_out, d.D, d.TB, d.D, d.H, nullptr, false,
              nullptr));
  LM_TRY(gemm(s, ws.proj_out, d.D, 1, wt.emb, 1, d.D, ws.logits, d.V, d.TB, d.V, d.D, nullptr,
              false, nullptr));
  return cudaSuccess;
}

struct Grads {
  float *emb, *proj, *w_ih, *w_hh, *bias;
};

cudaError_t backward_pass(const Dims& d, const Weights& wt, const Workspace& ws,
                          const float* dloss, const Grads& gr, cudaStream_t s) {
  const ll TB = d.TB, bh = static_cast<ll>(d.B) * d.H;
  LM_TRY(forward_pass(d, wt, ws, s));
  lm_rows<<<ceil_div(d.B, 128), 128, 0, s>>>(nullptr, ws.label, dloss, nullptr, ws.dnum, d.B, d.T,
                                             wt.pad);
  LM_LAUNCHED();
  lm_head_bwd<<<ceil_div(TB * 32, 256), 256, 0, s>>>(ws.logits, ws.label, ws.dnum, d.TB, d.B, d.V,
                                                     wt.pad);
  LM_LAUNCHED();
  const float* dlogits = ws.logits;
  const float* top = ws.y + (d.L - 1) * ws.layer_h;
  // dproj_out = dlogits . emb;  d_emb = dlogits^T . proj_out (output side, pad row included)
  LM_TRY(gemm(s, dlogits, d.V, 1, wt.emb, d.D, 1, ws.dproj_out, d.D, d.TB, d.D, d.V, nullptr,
              false, nullptr));
  LM_TRY(gemm(s, dlogits, 1, d.V, ws.proj_out, d.D, 1, gr.emb, d.D, d.V, d.D, d.TB, nullptr,
              false, ws.partial));
  // d_proj (D, H) = dproj_out^T . top;  dtop = dproj_out . proj
  LM_TRY(gemm(s, ws.dproj_out, 1, d.D, top, d.H, 1, gr.proj, d.H, d.D, d.H, d.TB, nullptr, false,
              ws.partial));
  float* ext = ws.e0;
  float* next = ws.e1;
  LM_TRY(gemm(s, ws.dproj_out, d.D, 1, wt.proj, d.H, 1, ext, d.H, d.TB, d.H, d.D, nullptr, false,
              nullptr));
  const dim3 step_grid(ceil_div(d.H, kBUnits), ceil_div(d.B, kBRows));
  for (int l = d.L - 1; l >= 0; --l) {
    const int din = l == 0 ? d.D : d.H;
    float* gates = ws.gates + l * ws.layer_gates;
    const float* h = ws.h + l * ws.layer_h;
    const float* c = ws.c + l * ws.layer_h;
    const float* whh = wt.whh(d, l);
    LM_TRY(cudaMemsetAsync(ws.dh, 0, bh * sizeof(float), s));
    LM_TRY(cudaMemsetAsync(ws.dc, 0, bh * sizeof(float), s));
    for (int t = d.T - 1; t >= 0; --t) {
      lstm_bwd_step<<<step_grid, 256, 0, s>>>(
          t + 1 < d.T ? gates + (t + 1) * d.B * d.G : nullptr, whh, gates + t * d.B * d.G,
          c + t * bh, t > 0 ? c + (t - 1) * bh : nullptr, ws.m_in + t * d.B, ext + t * bh, ws.dh,
          ws.dc, d.B, d.H);
      LM_LAUNCHED();
    }
    // Weight gradients of layer l: dpre (T*B, 4H) against its inputs.
    const float* dpre = gates;
    const float* x = l == 0 ? ws.x0 : ws.y + (l - 1) * ws.layer_h;
    float* d_wih = gr.w_ih + (l == 0 ? 0 : d.G * d.D + (l - 1) * d.G * d.H);
    LM_TRY(gemm(s, dpre, 1, d.G, x, din, 1, d_wih, din, static_cast<int>(d.G), din, d.TB, nullptr,
                false, ws.partial));
    // d_whh: step t's dpre against h_{t-1} (h_{-1} = 0).
    LM_TRY(gemm(s, dpre + d.B * d.G, 1, d.G, h, d.H, 1, gr.w_hh + l * d.G * d.H, d.H,
                static_cast<int>(d.G), d.H, (d.T - 1) * d.B, nullptr, false, ws.partial));
    const int chunks = ceil_div(TB, kChunkRows);
    colsum_partial<<<dim3(ceil_div(d.G, 256), chunks), 256, 0, s>>>(dpre, d.TB,
                                                                     static_cast<int>(d.G),
                                                                     ws.partial);
    LM_LAUNCHED();
    splitk_reduce<<<ceil_div(d.G, 256), 256, 0, s>>>(ws.partial, chunks, 1, static_cast<int>(d.G),
                                                     gr.bias + l * d.G, d.G, false);
    LM_LAUNCHED();
    // The gradient reaching layer l's input at every step: dpre . W_ih.
    LM_TRY(gemm(s, dpre, d.G, 1, wt.wih(d, l), din, 1, next, din, d.TB, din, static_cast<int>(d.G),
                nullptr, false, nullptr));
    float* swap = ext;
    ext = next;
    next = swap;
  }
  // ext now holds dx0: the embedding's input side, reduced per token id.
  const int chunks = ceil_div(TB, kChunkRows);
  embed_grad_partial<<<dim3(d.V, chunks), 256, 0, s>>>(ext, ws.lm_in, d.TB, d.D, d.V, wt.pad,
                                                       ws.partial);
  LM_LAUNCHED();
  splitk_reduce<<<ceil_div(static_cast<ll>(d.V) * d.D, 256), 256, 0, s>>>(
      ws.partial, chunks, d.V, d.D, gr.emb, d.D, true);
  LM_LAUNCHED();
  return cudaSuccess;
}

Dims make_dims(int B, int Lt, int D, int H, int L, int V) {
  Dims d;
  d.B = B;
  d.Lt = Lt;
  d.T = Lt + 1;
  d.TB = d.T * B;
  d.D = D;
  d.H = H;
  d.L = L;
  d.V = V;
  d.G = 4ll * H;
  return d;
}

bool valid_dims(const Dims& d) {
  return d.B > 0 && d.Lt > 0 && d.D > 0 && d.H > 0 && d.L > 0 && d.V > 0;
}

}  // namespace
}  // namespace probnmn

using namespace probnmn;

// Floats of workspace the forward (backward = 0) or the backward needs.
extern "C" long long probnmn_lm_workspace_floats(int batch, int lt, int input_size, int hidden,
                                                 int layers, int vocab, int backward) {
  const Dims d = make_dims(batch, lt, input_size, hidden, layers, vocab);
  return layout(d, backward != 0, nullptr, nullptr);
}

// K3f. tokens (B, Lt) int32; emb (V, D); proj (D, H); w_ih: the layers'
// (4H, D_l) matrices one after another; w_hh (L, 4H, H); bias (L, 4H) =
// b_ih + b_hh. Writes loss (B,).
extern "C" int probnmn_lm_forward(const void* tokens, int batch, int lt, const void* emb,
                                  const void* proj, const void* w_ih, const void* w_hh,
                                  const void* bias, void* workspace, void* loss, int vocab,
                                  int input_size, int hidden, int layers, int pad, int start,
                                  int end, void* stream) {
  const Dims d = make_dims(batch, lt, input_size, hidden, layers, vocab);
  if (!valid_dims(d)) return static_cast<int>(cudaErrorInvalidValue);
  Workspace ws;
  layout(d, false, static_cast<float*>(workspace), &ws);
  const Weights wt{static_cast<const int*>(tokens), static_cast<const float*>(emb),
                   static_cast<const float*>(proj), static_cast<const float*>(w_ih),
                   static_cast<const float*>(w_hh), static_cast<const float*>(bias),
                   pad, start, end};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = forward_pass(d, wt, ws, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  lm_head_fwd<<<ceil_div(static_cast<ll>(d.TB) * 32, 256), 256, 0, s>>>(ws.logits, ws.label,
                                                                        ws.ce, d.TB, d.V, pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lm_rows<<<ceil_div(d.B, 128), 128, 0, s>>>(ws.ce, ws.label, nullptr, static_cast<float*>(loss),
                                             nullptr, d.B, d.T, pad);
  return static_cast<int>(cudaGetLastError());
}

// K3b. The forward's inputs plus dloss (B,); writes the gradients in the
// same layouts: d_emb (V, D), d_proj (D, H), d_wih (flat), d_whh (L, 4H, H),
// d_bias (L, 4H) (the gradient of b_ih and of b_hh alike).
extern "C" int probnmn_lm_backward(const void* tokens, int batch, int lt, const void* emb,
                                   const void* proj, const void* w_ih, const void* w_hh,
                                   const void* bias, const void* dloss, void* workspace,
                                   void* d_emb, void* d_proj, void* d_wih, void* d_whh,
                                   void* d_bias, int vocab, int input_size, int hidden,
                                   int layers, int pad, int start, int end, void* stream) {
  const Dims d = make_dims(batch, lt, input_size, hidden, layers, vocab);
  if (!valid_dims(d)) return static_cast<int>(cudaErrorInvalidValue);
  Workspace ws;
  layout(d, true, static_cast<float*>(workspace), &ws);
  const Weights wt{static_cast<const int*>(tokens), static_cast<const float*>(emb),
                   static_cast<const float*>(proj), static_cast<const float*>(w_ih),
                   static_cast<const float*>(w_hh), static_cast<const float*>(bias),
                   pad, start, end};
  const Grads gr{static_cast<float*>(d_emb), static_cast<float*>(d_proj),
                 static_cast<float*>(d_wih), static_cast<float*>(d_whh),
                 static_cast<float*>(d_bias)};
  const cudaError_t err = backward_pass(d, wt, ws, static_cast<const float*>(dloss), gr,
                                        static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
