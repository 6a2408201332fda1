// Kernel K1: the ProgramGenerator sampling forward in one launch.
//
// Replaces probnmn_tpu/ops/pallas/seq2seq_decode.py::_sampling_kernel. Per row:
// boundary add (@end@ after the last valid token), zeroed-pad source
// embedding, a masked multi-layer LSTM encoder over L+1 steps (state frozen at
// pad steps, pad outputs zero), the decoder initialized from the top layer's
// final hidden state with context zero, then T decode steps of dot-product
// attention with the previous hidden state, an LSTMCell over
// concat(attended, embedded), the output projection and a Gumbel-max draw
// with pad/unk/start blocked (logprob from the unblocked log-softmax), the
// @end@ trim quirk and the length-normalized loss.
//
// Bound on an H100: latency, not FLOPs or bytes. The 46 + 26 steps depend on
// each other; a batch of 256 is 35.6 GFLOP (36 us at the bf16 tensor peak).
// Design: rows are independent across the recurrence, so a block owns kRows
// rows and runs every step with no inter-block sync. blockDim == H and
// thread u owns hidden unit u of all four gates for every row, so gate
// updates need no exchange and weight reads ((in, 4H) layout) are coalesced.
// The weights (~3.6 MB bf16) are read from L2 at every step; the encoder
// outputs live in a global scratch (B, L+1, H) that stays in L2. Matmul
// operands are rounded to the compute type T and summed in float32; the
// recurrent state stays float32.
//
// Noise: an explicit (T, B, stride) float32 tensor, or Philox4x32-10 with
// counter (v / 4, step, row, 0) and key seed, word v % 4, mapped to Gumbel as
// u = (bits >> 8) * 2^-24 + 1e-12, g = -log(-log(u)).

#include "common.cuh"

using namespace probnmn;

namespace {

constexpr int kRows = 2;  // rows (examples) per block
constexpr int kMaxThreads = 512;
constexpr float kNegInf = -1e9f;

struct SampleParams {
  const int* src;
  int batch, raw_len;
  const float* noise;
  int noise_stride;
  unsigned long long seed;
  const void* src_emb;
  const void* tgt_emb;
  const void* enc_wih;
  const void* enc_whh;
  const float* enc_bias;
  const void* dec_wih;
  const void* dec_whh;
  const float* dec_bias;
  const void* proj_w;
  const float* proj_b;
  void* enc_out;
  int* preds;
  float* loss;
  float* logprobs;
  int D, H, L, V, T;
  int pad, unk, start, end;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float philox_gumbel(unsigned long long seed, int row, int step, int v) {
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(v >> 2), static_cast<uint32_t>(step),
                 static_cast<uint32_t>(row), 0u),
      make_uint2(static_cast<uint32_t>(seed & 0xffffffffull), static_cast<uint32_t>(seed >> 32)));
  const int w = v & 3;
  const uint32_t bits = w == 0 ? r.x : (w == 1 ? r.y : (w == 2 ? r.z : r.w));
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f) + 1e-12f;
  return -logf(-logf(u));
}

// Gate pre-activations of hidden unit u for every row:
// acc[g][r] = bias[g*H + u] + sum_k x[r][k] * wih[k][g*H + u] + sum_k hr[r][k] * whh[k][g*H + u].
// x and hr hold values already rounded to T.
template <typename T>
__device__ __forceinline__ void lstm_gates(const float* x, int x_stride, int in_dim, const float* hr,
                                           const T* __restrict__ wih, const T* __restrict__ whh,
                                           const float* __restrict__ bias, int H, int u,
                                           float acc[4][kRows]) {
  const size_t G = 4 * static_cast<size_t>(H);
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float bg = bias[g * H + u];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[g][r] = bg;
  }
  for (int k = 0; k < in_dim; ++k) {
    const T* w = wih + k * G + u;
    const float w0 = to_f(w[0]), w1 = to_f(w[H]), w2 = to_f(w[2 * H]), w3 = to_f(w[3 * H]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float xv = x[r * x_stride + k];
      acc[0][r] = fmaf(xv, w0, acc[0][r]);
      acc[1][r] = fmaf(xv, w1, acc[1][r]);
      acc[2][r] = fmaf(xv, w2, acc[2][r]);
      acc[3][r] = fmaf(xv, w3, acc[3][r]);
    }
  }
  for (int k = 0; k < H; ++k) {
    const T* w = whh + k * G + u;
    const float w0 = to_f(w[0]), w1 = to_f(w[H]), w2 = to_f(w[2 * H]), w3 = to_f(w[3 * H]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float hv = hr[r * H + k];
      acc[0][r] = fmaf(hv, w0, acc[0][r]);
      acc[1][r] = fmaf(hv, w1, acc[1][r]);
      acc[2][r] = fmaf(hv, w2, acc[2][r]);
      acc[3][r] = fmaf(hv, w3, acc[3][r]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) seq2seq_sample_kernel(const SampleParams p) {
  extern __shared__ float sm[];
  const int H = p.H, D = p.D, L = p.L, V = p.V, S = p.raw_len + 1, XS = H + D;
  float* xin = sm;                       // [kRows][H + D] layer / cell input (rounded)
  float* hs = xin + kRows * XS;          // [L][kRows][H] encoder hidden state
  float* cs = hs + L * kRows * H;        // [L][kRows][H] encoder cell state
  float* hr = cs + L * kRows * H;        // [L][kRows][H] hidden state rounded to T
  float* hd = hr + L * kRows * H;        // [kRows][H] decoder hidden
  float* cd = hd + kRows * H;            // [kRows][H] decoder cell
  float* hdr = cd + kRows * H;           // [kRows][H] decoder hidden rounded to T
  float* att = hdr + kRows * H;          // [kRows][S] attention scores / weights
  float* logit = att + kRows * S;        // [kRows][V]
  float* rowf = logit + kRows * V;       // [kRows][4]: alive, kill, logprob sum, count
  int* lens = reinterpret_cast<int*>(rowf + 4 * kRows);  // [kRows]
  int* tok = lens + kRows;                                // [kRows]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int u = tid;  // blockDim.x == H
  const int row0 = blockIdx.x * kRows;
  const size_t G = 4 * static_cast<size_t>(H);
  const T* src_emb = static_cast<const T*>(p.src_emb);
  const T* tgt_emb = static_cast<const T*>(p.tgt_emb);
  const T* enc_wih = static_cast<const T*>(p.enc_wih);
  const T* enc_whh = static_cast<const T*>(p.enc_whh);
  const T* dec_wih = static_cast<const T*>(p.dec_wih);
  const T* dec_whh = static_cast<const T*>(p.dec_whh);
  const T* proj_w = static_cast<const T*>(p.proj_w);
  T* enc = static_cast<T*>(p.enc_out);

  if (tid < kRows) {
    const int b = row0 + tid;
    int n = 0;
    if (b < p.batch)
      for (int l = 0; l < p.raw_len; ++l) n += p.src[static_cast<size_t>(b) * p.raw_len + l] != p.pad;
    lens[tid] = n;
  }
  for (int i = tid; i < L * kRows * H; i += nthreads) {
    hs[i] = 0.f;
    cs[i] = 0.f;
    hr[i] = 0.f;
  }
  __syncthreads();

  // ------------------------------------------------------------- encoder
  for (int t = 0; t < S; ++t) {
    int tk[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = row0 + r;
      int v = p.pad;
      if (b < p.batch) {
        const int n = lens[r];
        v = t < n ? p.src[static_cast<size_t>(b) * p.raw_len + t] : (t == n ? p.end : p.pad);
      }
      tk[r] = v;
      for (int k = tid; k < D; k += nthreads)
        xin[r * XS + k] = v != p.pad ? to_f(src_emb[static_cast<size_t>(v) * D + k]) : 0.f;
    }
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const T* wih = enc_wih + (l == 0 ? 0 : static_cast<size_t>(D) * G + static_cast<size_t>(l - 1) * H * G);
      const T* whh = enc_whh + static_cast<size_t>(l) * H * G;
      float acc[4][kRows];
      lstm_gates<T>(xin, XS, l == 0 ? D : H, hr + l * kRows * H, wih, whh, p.enc_bias + l * G, H, u, acc);
      __syncthreads();  // every thread has read xin and hr[l]
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = (l * kRows + r) * H + u;
        const float c_new = sigmoid(acc[1][r]) * cs[i] + sigmoid(acc[0][r]) * tanhf(acc[2][r]);
        const float h_new = sigmoid(acc[3][r]) * tanhf(c_new);
        const bool m = tk[r] != p.pad;
        if (m) {  // packed-sequence semantics: the state freezes at pad steps
          cs[i] = c_new;
          hs[i] = h_new;
          hr[i] = rnd<T>(h_new);
        }
        xin[r * XS + u] = m ? rnd<T>(h_new) : 0.f;  // next layer's input; zero at pads
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (row0 + r < p.batch)
        enc[(static_cast<size_t>(row0 + r) * S + t) * H + u] = from_f<T>(xin[r * XS + u]);
  }

  // ------------------------------------------------------------- decoder
  for (int i = tid; i < kRows * H; i += nthreads) {
    hd[i] = hs[(L - 1) * kRows * H + i];
    cd[i] = 0.f;
    hdr[i] = rnd<T>(hd[i]);
  }
  if (tid < kRows) {
    tok[tid] = p.start;
    rowf[4 * tid + 0] = 1.f;  // alive: no @end@ yet
    rowf[4 * tid + 1] = 0.f;  // kill: the first token was @end@
    rowf[4 * tid + 2] = 0.f;
    rowf[4 * tid + 3] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    // Attention scores of the previous hidden state, one warp per (row, step).
    for (int idx = warp; idx < kRows * S; idx += nwarps) {
      const int r = idx / S, s = idx % S;
      const int b = min(row0 + r, p.batch - 1);
      const T* e = enc + (static_cast<size_t>(b) * S + s) * H;
      float part = 0.f;
      for (int k = lane; k < H; k += 32) part = fmaf(to_f(e[k]), hdr[r * H + k], part);
      part = warp_sum(part);
      if (lane == 0) att[idx] = s <= lens[r] ? part : kNegInf;
    }
    __syncthreads();
    if (warp < kRows) {  // masked softmax, one warp per row
      float* a = att + warp * S;
      float mx = -INFINITY;
      for (int s = lane; s < S; s += 32) mx = fmaxf(mx, a[s]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int s = lane; s < S; s += 32) sum += expf(a[s] - mx);
      sum = warp_sum(sum);
      for (int s = lane; s < S; s += 32) a[s] = rnd<T>(expf(a[s] - mx) / sum);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = min(row0 + r, p.batch - 1);
      const T* e = enc + static_cast<size_t>(b) * S * H + u;
      float a = 0.f;
      for (int s = 0; s < S; ++s) a = fmaf(att[r * S + s], to_f(e[static_cast<size_t>(s) * H]), a);
      xin[r * XS + u] = rnd<T>(a);
      for (int k = tid; k < D; k += nthreads)
        xin[r * XS + H + k] = to_f(tgt_emb[static_cast<size_t>(tok[r]) * D + k]);
    }
    __syncthreads();
    float acc[4][kRows];
    lstm_gates<T>(xin, XS, H + D, hdr, dec_wih, dec_whh, p.dec_bias, H, u, acc);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = r * H + u;
      const float c_new = sigmoid(acc[1][r]) * cd[i] + sigmoid(acc[0][r]) * tanhf(acc[2][r]);
      const float h_new = sigmoid(acc[3][r]) * tanhf(c_new);
      cd[i] = c_new;
      hd[i] = h_new;
      hdr[i] = rnd<T>(h_new);
    }
    __syncthreads();
    for (int idx = tid; idx < kRows * V; idx += nthreads) {
      const int r = idx / V, v = idx % V;
      float a = p.proj_b[v];
      for (int k = 0; k < H; ++k) a = fmaf(hdr[r * H + k], to_f(proj_w[static_cast<size_t>(k) * V + v]), a);
      logit[idx] = a;
    }
    __syncthreads();
    if (warp < kRows) {  // log-softmax normalizer, Gumbel-max draw, trim and loss
      const int r = warp, b = row0 + r;
      const float* lg = logit + r * V;
      float mx = -INFINITY;
      for (int v = lane; v < V; v += 32) mx = fmaxf(mx, lg[v]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int v = lane; v < V; v += 32) sum += expf(lg[v] - mx);
      sum = warp_sum(sum);
      const float lse = logf(sum) + mx;
      float best = -INFINITY;
      int best_v = V;
      for (int v = lane; v < V; v += 32) {
        float g = 0.f;
        if (b < p.batch)
          g = p.noise != nullptr
                  ? p.noise[(static_cast<size_t>(t) * p.batch + b) * p.noise_stride + v]
                  : philox_gumbel(p.seed, b, t, v);
        const bool blocked = v == p.pad || v == p.unk || v == p.start;
        const float comb = (blocked ? kNegInf : lg[v]) + g;
        if (comb > best) {
          best = comb;
          best_v = v;
        }
      }
      warp_argmax(best, best_v);
      if (lane == 0) {
        float* rf = rowf + 4 * r;
        const float chosen = lg[best_v] - lse;
        const bool is_end = best_v == p.end;
        if (t == 0 && is_end) rf[1] = 1.f;  // a row whose FIRST token is @end@ is zeroed
        const bool keep = rf[0] > 0.f && rf[1] == 0.f;
        if (is_end) rf[0] = 0.f;
        if (b < p.batch) {
          p.preds[static_cast<size_t>(b) * p.T + t] = keep ? best_v : 0;
          p.logprobs[static_cast<size_t>(b) * p.T + t] = chosen;
        }
        if (keep) {
          rf[2] += chosen;
          rf[3] += 1.f;
        }
        tok[r] = best_v;
      }
    }
    __syncthreads();
  }
  if (tid < kRows && row0 + tid < p.batch)
    p.loss[row0 + tid] = -(rowf[4 * tid + 2] / (rowf[4 * tid + 3] + 1e-12f));
}

template <typename T>
cudaError_t launch_sample(const SampleParams& p, cudaStream_t stream) {
  const int S = p.raw_len + 1;
  const size_t floats = static_cast<size_t>(kRows) * (p.H + p.D) + 3ull * p.L * kRows * p.H +
                        3ull * kRows * p.H + static_cast<size_t>(kRows) * S +
                        static_cast<size_t>(kRows) * p.V + 4 * kRows;
  const size_t bytes = floats * sizeof(float) + 2 * kRows * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(seq2seq_sample_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.batch + kRows - 1) / kRows);
  seq2seq_sample_kernel<T><<<grid, p.H, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Launches on `stream`; returns cudaGetLastError().
extern "C" int probnmn_seq2seq_sample(
    int dtype, const void* src, int batch, int raw_len, const void* noise, int noise_stride,
    unsigned long long seed, const void* src_emb, const void* tgt_emb, const void* enc_wih,
    const void* enc_whh, const void* enc_bias, const void* dec_wih, const void* dec_whh,
    const void* dec_bias, const void* proj_w, const void* proj_b, void* enc_out, void* preds,
    void* loss, void* logprobs, int input_size, int hidden, int num_layers, int vocab,
    int num_steps, int pad, int unk, int start, int end, void* stream) {
  if (batch <= 0) return 0;
  if (hidden % 32 != 0 || hidden < 32 * kRows || hidden > kMaxThreads || vocab <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SampleParams p;
  p.src = static_cast<const int*>(src);
  p.batch = batch;
  p.raw_len = raw_len;
  p.noise = static_cast<const float*>(noise);
  p.noise_stride = noise_stride;
  p.seed = seed;
  p.src_emb = src_emb;
  p.tgt_emb = tgt_emb;
  p.enc_wih = enc_wih;
  p.enc_whh = enc_whh;
  p.enc_bias = static_cast<const float*>(enc_bias);
  p.dec_wih = dec_wih;
  p.dec_whh = dec_whh;
  p.dec_bias = static_cast<const float*>(dec_bias);
  p.proj_w = proj_w;
  p.proj_b = static_cast<const float*>(proj_b);
  p.enc_out = enc_out;
  p.preds = static_cast<int*>(preds);
  p.loss = static_cast<float*>(loss);
  p.logprobs = static_cast<float*>(logprobs);
  p.D = input_size;
  p.H = hidden;
  p.L = num_layers;
  p.V = vocab;
  p.T = num_steps;
  p.pad = pad;
  p.unk = unk;
  p.start = start;
  p.end = end;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? launch_sample<bf16>(p, s) : launch_sample<float>(p, s);
  return static_cast<int>(err);
}
