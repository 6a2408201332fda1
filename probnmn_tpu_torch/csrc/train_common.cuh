// Building blocks of the training kernels (K3f/K3b in lm_train.cu, K4f/K4b
// in tf_train.cu), float32 on the SIMT cores: a tiled GEMM with split-K and a
// fixed-order reduction of its partials, the token streams of a
// teacher-forced pass, embedding lookups, the serial LSTM step kernels and a
// whole layer's forward and reverse sweep, the cross-entropy head, and the
// deterministic column-sum and per-token-id reductions the weight gradients
// use. Every host helper launches on the given stream and returns
// cudaGetLastError().
#pragma once

#include "lstm.cuh"

namespace probnmn {
namespace {

typedef long long ll;

#define TRAIN_TRY(expr)                       \
  do {                                        \
    const cudaError_t err_ = (expr);          \
    if (err_ != cudaSuccess) return err_;     \
  } while (0)

#define TRAIN_LAUNCHED() TRAIN_TRY(cudaGetLastError())

int ceil_div(ll a, ll b) { return static_cast<int>((a + b - 1) / b); }

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

// Floats of split-K partials a weight-gradient GEMM of an (M, N) result over
// `rows` rows needs.
ll splitk_floats(ll rows, ll M, ll N) { return (rows + kSplitRows - 1) / kSplitRows * M * N; }

// ------------------------------------------------------------------ token streams
// Row r = t * B + b of (T, B) streams from tokens (B, Lt). With append_end
// (T = Lt + 1) the labels are the row with @end@ after its last real token
// and pad after that; without it (T = Lt) they are the row as it is. Inputs
// are [start, labels[:-1]]. m_in and m_label are 1 where the input or label
// is not pad. Ids outside [0, V) are clamped so that no read leaves an
// embedding; the trainers reject such ids on the host first. Any output may
// be null.
__global__ void token_streams(const int* __restrict__ tok, int B, int Lt, int T, int V, int pad,
                              int start, int end, bool append_end, int* in, int* label,
                              float* m_in, float* m_label) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= T * B) return;
  const int t = idx / B, b = idx % B;
  const int* row = tok + static_cast<ll>(b) * Lt;
  int lens = 0;
  for (int i = 0; i < Lt; ++i) lens += row[i] != pad;
  auto at = [&](int s) {
    if (!append_end) return row[s];
    return s < lens ? row[s] : (s == lens ? end : pad);
  };
  const int lab = min(max(at(t), 0), V - 1);
  const int inp = min(max(t == 0 ? start : at(t - 1), 0), V - 1);
  if (in != nullptr) in[idx] = inp;
  if (label != nullptr) label[idx] = lab;
  if (m_in != nullptr) m_in[idx] = inp != pad ? 1.f : 0.f;
  if (m_label != nullptr) m_label[idx] = lab != pad ? 1.f : 0.f;
}

// out[r] = embedding[ids[r]], zero where m[r] == 0 (m null: no mask).
__global__ void embed_rows(const float* __restrict__ emb, const int* __restrict__ ids,
                           const float* __restrict__ m, float* out, int rows, int D) {
  const ll idx = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<ll>(rows) * D) return;
  const int r = static_cast<int>(idx / D), d = static_cast<int>(idx % D);
  out[idx] = (m == nullptr || m[r] != 0.f) ? emb[static_cast<ll>(ids[r]) * D + d] : 0.f;
}

// ------------------------------------------------------------------ recurrent steps
// One forward step of one layer. `gates` holds this step's input part
// (x . W_ih^T + bias, (B, 4H)) and receives the activated gates. The
// recurrent product is a (B, K) . w^T with w (4H, K) at leading dimension
// ldw: a = h_prev and K = H in a plain layer; the attentive decoder's
// a = [attended, h_prev] and K = 2H. `a` null: no product (the first step).
// m null means every row is real (no freeze); h_prev/c_prev null mean zero
// states; y_out may be null. Block: 32 rows x 16 units; thread (unit u, rows
// rl and rl + 16) keeps all four gates of its unit.
constexpr int kFRows = 32, kFUnits = 16, kFK = 32;

__global__ void __launch_bounds__(256)
lstm_fwd_step(const float* __restrict__ a, int K, const float* __restrict__ w, int ldw,
              const float* __restrict__ h_prev, const float* __restrict__ c_prev, float* gates,
              const float* __restrict__ m, float* h_out, float* c_out, float* y_out, int B,
              int H) {
  __shared__ float hs[kFRows][kFK + 1];
  __shared__ float ws[4 * kFUnits][kFK + 1];
  const int tid = threadIdx.x;
  const int u = tid % kFUnits, rl = tid / kFUnits;
  const int j0 = blockIdx.x * kFUnits, b0 = blockIdx.y * kFRows;
  float acc[2][4] = {};
  if (a != nullptr) {
    for (int k0 = 0; k0 < K; k0 += kFK) {
      for (int e = tid; e < kFRows * kFK; e += 256) {
        const int rr = e / kFK, kk = e % kFK;
        const int b = b0 + rr, k = k0 + kk;
        hs[rr][kk] = (b < B && k < K) ? a[static_cast<ll>(b) * K + k] : 0.f;
      }
      for (int e = tid; e < 4 * kFUnits * kFK; e += 256) {
        const int gr = e / kFK, kk = e % kFK;
        const int j = j0 + gr % kFUnits, k = k0 + kk;
        const int grow = (gr / kFUnits) * H + j;
        ws[gr][kk] = (j < H && k < K) ? w[static_cast<ll>(grow) * ldw + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kFK; ++kk) {
        const float a0 = hs[rl][kk], a1 = hs[rl + 16][kk];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float wv = ws[q * kFUnits + u][kk];
          acc[0][q] = fmaf(a0, wv, acc[0][q]);
          acc[1][q] = fmaf(a1, wv, acc[1][q]);
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
    const LstmGates g = lstm_activate(gp[j] + acc[rr][0], gp[H + j] + acc[rr][1],
                                      gp[2 * H + j] + acc[rr][2], gp[3 * H + j] + acc[rr][3]);
    gp[j] = g.i;
    gp[H + j] = g.f;
    gp[2 * H + j] = g.g;
    gp[3 * H + j] = g.o;
    const ll idx = static_cast<ll>(b) * H + j;
    const float hp = h_prev != nullptr ? h_prev[idx] : 0.f;
    const float cp = c_prev != nullptr ? c_prev[idx] : 0.f;
    float h, c, y;
    lstm_cell_forward(g, hp, cp, m != nullptr ? m[b] : 1.f, h, c, y);
    h_out[idx] = h;
    c_out[idx] = c;
    if (y_out != nullptr) y_out[idx] = y;
  }
}

// One backward step of one layer. dh = dh_state + dpre_{t+1} . W_hh + ext * m,
// dc = dc_state; the cell backward writes this step's dpre over its gates and
// leaves the carries in dh_state / dc_state. dpre_next null: no product; m
// null: every row real; ext null: no output gradient. Block: 32 rows x 32
// units; thread (unit u, rows rl + 8 i).
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
        const float wv = ws[kk][u];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(ds[rl + 8 * i][kk], wv, acc[i]);
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
    const float mm = m != nullptr ? m[b] : 1.f;
    const float dh = dh_state[idx] + acc[i] + (ext != nullptr ? ext[idx] * mm : 0.f);
    float* gp = gates + static_cast<ll>(b) * G;
    const LstmGates g{gp[j], gp[H + j], gp[2 * H + j], gp[3 * H + j]};
    float dpre[4], dh_carry, dc_carry;
    lstm_cell_backward(g, c_post[idx], c_prev != nullptr ? c_prev[idx] : 0.f, mm, dh,
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
__global__ void ce_head_fwd(const float* __restrict__ logits, const int* __restrict__ label,
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
__global__ void ce_head_bwd(float* logits, const int* __restrict__ label,
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
// loss = sum ce / (den + eps) (when `loss` is given), and
// dnum = dloss / (den + eps) (when `dnum` is given).
__global__ void loss_rows(const float* __restrict__ ce, const int* __restrict__ label,
                          const float* __restrict__ dloss, float* loss, float* dnum, int B, int T,
                          int pad, float eps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float num = 0.f, den = 0.f;
  for (int t = 0; t < T; ++t) {
    const int r = t * B + b;
    den += label[r] != pad ? 1.f : 0.f;
    if (ce != nullptr) num += ce[r];
  }
  if (loss != nullptr) loss[b] = num / (den + eps);
  if (dnum != nullptr) dnum[b] = dloss[b] / (den + eps);
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

// The gradient of an embedding read by row lookups, per token id
// v = blockIdx.x and row chunk s = blockIdx.y: partial[s][v] = sum of dx[r]
// over the chunk's rows whose id is v, in row order. The row of id `skip`
// (the pad row of a masked lookup; -1 for none) gets nothing.
__global__ void embed_grad_partial(const float* __restrict__ dx, const int* __restrict__ ids,
                                   int rows, int D, int V, int skip, float* partial) {
  __shared__ int sid[kChunkRows];
  const int v = blockIdx.x, s = blockIdx.y;
  const int r0 = s * kChunkRows, n = min(rows - r0, kChunkRows);
  for (int i = threadIdx.x; i < n; i += blockDim.x) sid[i] = ids[r0 + i];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    if (v != skip)
      for (int i = 0; i < n; ++i)
        if (sid[i] == v) acc += dx[static_cast<ll>(r0 + i) * D + d];
    partial[(static_cast<ll>(s) * V + v) * D + d] = acc;
  }
}

ll chunk_count(ll rows) { return (rows + kChunkRows - 1) / kChunkRows; }

// out[c] (+)= sum over the rows of x (rows, cols), in a fixed order.
cudaError_t column_sum(cudaStream_t s, const float* x, int rows, int cols, float* out,
                       bool accumulate, float* partial) {
  const int chunks = static_cast<int>(chunk_count(rows));
  colsum_partial<<<dim3(ceil_div(cols, 256), chunks), 256, 0, s>>>(x, rows, cols, partial);
  TRAIN_LAUNCHED();
  splitk_reduce<<<ceil_div(cols, 256), 256, 0, s>>>(partial, chunks, 1, cols, out, cols,
                                                     accumulate);
  return cudaGetLastError();
}

// d_emb (V, D) (+)= the gradient dx (rows, D) of a lookup by ids, per id.
cudaError_t embedding_grad(cudaStream_t s, const float* dx, const int* ids, int rows, int D, int V,
                           int skip, float* d_emb, bool accumulate, float* partial) {
  const int chunks = static_cast<int>(chunk_count(rows));
  embed_grad_partial<<<dim3(V, chunks), 256, 0, s>>>(dx, ids, rows, D, V, skip, partial);
  TRAIN_LAUNCHED();
  splitk_reduce<<<ceil_div(static_cast<ll>(V) * D, 256), 256, 0, s>>>(partial, chunks, V, D, d_emb,
                                                                       D, accumulate);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ layers
// Rows t * B + b of (T, B, .) arrays.
struct LayerArgs {
  int T, B, H, din;
  const float *x, *w_ih, *w_hh, *bias;  // x (T*B, din); w_ih (4H, din); w_hh (4H, H); bias (4H)
  const float* m;                       // (T*B) step mask
  float *gates, *h, *c, *y;             // (T*B, 4H), (T*B, H) x 3
};

// A masked layer's forward: one GEMM for x . W_ih^T + bias over all steps,
// then one step launch per step. y = h * m is what the layer above reads.
cudaError_t lstm_layer_forward(cudaStream_t s, const LayerArgs& a) {
  const ll G = 4ll * a.H, bh = static_cast<ll>(a.B) * a.H;
  TRAIN_TRY(gemm(s, a.x, a.din, 1, a.w_ih, 1, a.din, a.gates, G, a.T * a.B, static_cast<int>(G),
                 a.din, a.bias, false, nullptr));
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

// Its reverse sweep from the stored activated gates (overwritten with dpre),
// h and c: `ext` (T*B, H) is the gradient reaching y at every step, `dh_last`
// (B, H, or null) the gradient reaching the final h after the last step.
// Then the weight gradients, each a contraction over T*B rows added in a
// fixed order (d_bias serves b_ih and b_hh alike), and dx = dpre . W_ih
// (T*B, din) when dx is given. dh, dc: (B, H) carries.
cudaError_t lstm_layer_backward(cudaStream_t s, const LayerArgs& a, const float* ext,
                                const float* dh_last, float* dh, float* dc, float* d_wih,
                                float* d_whh, float* d_bias, float* dx, float* partial) {
  const ll G = 4ll * a.H, bh = static_cast<ll>(a.B) * a.H;
  const int TB = a.T * a.B;
  if (dh_last != nullptr) {
    TRAIN_TRY(cudaMemcpyAsync(dh, dh_last, bh * sizeof(float), cudaMemcpyDeviceToDevice, s));
  } else {
    TRAIN_TRY(cudaMemsetAsync(dh, 0, bh * sizeof(float), s));
  }
  TRAIN_TRY(cudaMemsetAsync(dc, 0, bh * sizeof(float), s));
  const dim3 grid(ceil_div(a.H, kBUnits), ceil_div(a.B, kBRows));
  for (int t = a.T - 1; t >= 0; --t) {
    lstm_bwd_step<<<grid, 256, 0, s>>>(
        t + 1 < a.T ? a.gates + (t + 1) * a.B * G : nullptr, a.w_hh, a.gates + t * a.B * G,
        a.c + t * bh, t > 0 ? a.c + (t - 1) * bh : nullptr, a.m + t * a.B, ext + t * bh, dh, dc,
        a.B, a.H);
    TRAIN_LAUNCHED();
  }
  const float* dpre = a.gates;
  TRAIN_TRY(gemm(s, dpre, 1, G, a.x, a.din, 1, d_wih, a.din, static_cast<int>(G), a.din, TB,
                 nullptr, false, partial));
  // d_whh: step t's dpre against h_{t-1} (h_{-1} = 0).
  TRAIN_TRY(gemm(s, dpre + a.B * G, 1, G, a.h, a.H, 1, d_whh, a.H, static_cast<int>(G), a.H,
                 (a.T - 1) * a.B, nullptr, false, partial));
  TRAIN_TRY(column_sum(s, dpre, TB, static_cast<int>(G), d_bias, false, partial));
  if (dx != nullptr)
    TRAIN_TRY(gemm(s, dpre, G, 1, a.w_ih, a.din, 1, dx, a.din, TB, a.din, static_cast<int>(G),
                   nullptr, false, nullptr));
  return cudaSuccess;
}

// Floats of split-K and chunk partials lstm_layer_backward needs.
ll layer_partial_floats(ll rows, ll H, ll din) {
  const ll G = 4 * H, widest = din > H ? din : H;
  const ll a = splitk_floats(rows, G, widest), b = chunk_count(rows) * G;
  return a > b ? a : b;
}

}  // namespace
}  // namespace probnmn
