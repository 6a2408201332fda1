// Kernel K1: the ProgramGenerator sampling forward in L + 1 launches: one
// encoder sweep a layer (k1_encoder_sweep), then the decoder
// (seq2seq_sample_kernel).
//
// Replaces probnmn_tpu/ops/pallas/seq2seq_decode.py::_sampling_kernel: its
// encoder (enc_step, with boundary_token) is the sweep, the rest the
// decoder. Per row: boundary add (@end@ after the last valid token),
// zeroed-pad source embedding, a masked multi-layer LSTM encoder over L+1
// steps (state frozen at pad steps, pad outputs zero), the decoder
// initialized from the top layer's final hidden state with context zero,
// then T decode steps of dot-product attention with the previous hidden
// state, an LSTMCell over concat(attended, embedded), the output projection
// and a Gumbel-max draw with pad/unk/start blocked (logprob from the
// unblocked log-softmax), the @end@ trim quirk and the length-normalized
// loss. Matmul operands are rounded to the compute type T and summed in
// float32; the recurrent state stays float32.
//
// Bound on an H100: latency, not FLOPs or bytes. The 46 + 26 steps depend on
// each other; a batch of 256 is 35.6 GFLOP (36 us at the bf16 tensor peak).
//
// The encoder sweep. Each layer's recurrence is one launch of clusters of n
// CTAs (cluster_sweep.cuh): a cluster owns R rows for all S = L+1 steps with
// no grid-wide synchronisation, each CTA U = H / n hidden units (n the
// smallest power of two with U <= 32: 4 at H = 128, 8 at 256, 16 at 512, a
// cluster above the portable size), all four gates of each. A CTA keeps its
// units' columns of the layer's W_hh (H x 4U) and W_ih (in x 4U) in shared
// memory in T, loaded once by cp.async from the (in, 4H) k-major layout the
// wrapper packs, as they lie: row k holds the four gates' U columns. What
// fits stays resident: W_hh first, then W_ih, each only if the buffers of
// 16 rows still fit beside it; the rest is read from L2 at every step. With
// D = H that keeps both at H = 128, both in bf16 and W_hh alone in float32
// at H = 256, W_hh alone in bf16 and neither in float32 at H = 512. A
// thread owns two adjacent units (a 4-byte bf16 pair or an 8-byte float
// pair of every weight row) and up to 4 rows; a warp's lanes are 8 unit
// pairs x 4 row groups, and a CTA has at most 4 warps (8 row groups at
// U = 32: 3 rows a thread at 18 rows a cluster, 2 at 9). What bounds a
// step is each thread's reading and converting every weight word from
// shared memory for its rows. Each step a thread sums a gate as acc =
// bias, fmaf over k of x . W_ih, then fmaf over k of h_{t-1} . W_hh, in the
// order of the per-row kernel this sweep replaced, so every gate keeps its
// bits (with k1_cell's contraction, equal to that kernel's); the
// x . W_ih half of step t+1 runs between the cluster barrier's arrival and
// its wait. Layer 0's x is the embedding row of the boundary token, a layer
// above reads the one below's outputs from a (B, S, H) scratch in T; both
// are staged a step ahead into shared memory by cp.async. h_{t-1}, rounded
// to T, is pushed into every CTA of the cluster through distributed shared
// memory, double-buffered by step parity. The top layer writes the encoder
// outputs (B, S, H) in T and its final hidden state (B, H) in float32, not
// rounded. A cluster stops at its rows' last @end@ and writes zeros for the
// pad steps after it. R is the fewest rows that let every cluster run at
// once (cudaOccupancyMaxActiveClusters), up to 32; a larger batch runs in
// waves. Every sum runs in an order that depends on neither R, n nor the
// card, with no atomics.
//
// The decoder: rows are independent across the recurrence, so a block owns
// kRows rows and runs every decode step with no inter-block sync.
// blockDim == H and thread u owns hidden unit u of all four gates for every
// row, so gate updates need no exchange and weight reads ((in, 4H) layout)
// are coalesced. Its weights (~1.5 MB bf16) are read from L2 at every step;
// the encoder outputs stay in L2.
//
// Both write the cell's contraction out (k1_cell), so their bits do not
// depend on what the compiler fuses.
//
// Noise: an explicit (T, B, stride) float32 tensor, or Philox4x32-10 with
// counter (v / 4, step, row, 0) and key seed, word v % 4, mapped to Gumbel as
// u = (bits >> 8) * 2^-24 + 1e-12, g = -log(-log(u)).

#include "cluster_sweep.cuh"
#include "common.cuh"

namespace probnmn {
namespace {

typedef long long ll;

constexpr int kRows = 2;  // rows (examples) per decoder block
constexpr int kMaxThreads = 512;
constexpr float kNegInf = -1e9f;

// ------------------------------------------------------------------ encoder sweep
constexpr int kEncMaxRows = 32;   // rows a cluster owns at most (one a lane: their tokens)
constexpr int kEncMaxUnits = 32;  // units a CTA owns at most
constexpr int kEncMaxRpt = 4;     // rows a thread owns at most
// Threads a CTA at most: 4 warps. With more, each reloading every weight
// word from shared memory at every step, a step took longer on the H100
// (6 warps of 2 rows a thread against 4 of 3: +21% at 18 rows a cluster).
constexpr int kEncMaxThreads = 128;
constexpr int kEncResidentRows = 16;  // the rows whose buffers a resident matrix leaves room for

struct EncoderArgs {
  const int* src;      // (B, raw_len) right-padded raw tokens
  int batch, raw_len;
  const void* x;       // layer 0: the source embedding (V, in); above: the layer below's outputs (B, S, H)
  const void* w_ih;    // (in, 4H)
  const void* w_hh;    // (H, 4H)
  const float* bias;   // (4H,) b_ih + b_hh
  void* out;           // (B, S, H)
  float* h_final;      // (B, H), or null below the top layer
  int in, H, layer, pad, end;
  int units, rows, groups, whh_res, wih_res;  // the plan
};

__host__ __device__ __forceinline__ int enc_xs(int in) { return (in + 3) / 4 * 4 + 4; }
__host__ __device__ __forceinline__ int enc_hs(int H) { return H + 4; }
__host__ __device__ __forceinline__ size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// Shared memory, byte offsets: the resident W_hh (H x 4U) and W_ih (in x 4U)
// in T; two x buffers xb[p][r][k] in T and two h buffers hb[p][r][k] in
// float32, their rows padded by 4 so that the 4 rows a warp reads at one k
// fall on distinct banks; the rows' lengths.
struct EncSmem {
  size_t whh, wih, xb, hb, lens, total;
};

__host__ __device__ __forceinline__ EncSmem enc_smem(int sz, int in, int H, int U, int R, bool whh,
                                                     bool wih) {
  EncSmem m;
  m.whh = 0;
  m.wih = m.whh + align16(whh ? 4ull * U * H * sz : 0);
  m.xb = m.wih + align16(wih ? 4ull * U * in * sz : 0);
  m.hb = m.xb + align16(2ull * R * enc_xs(in) * sz);
  m.lens = m.hb + align16(2ull * R * enc_hs(H) * sizeof(float));
  m.total = m.lens + align16(static_cast<size_t>(R) * sizeof(int));
  return m;
}

// The new cell state f * c_prev + i * g with its contraction written out:
// the compiler fuses either product into the add, and chooses per kernel.
// This is the form the per-row kernel this sweep replaced was compiled to
// (its outputs and tokens are equal to this kernel's bit for bit, and not
// to lstm.cuh's fma(i, g, f * c_prev)), so the sweep and the decoder keep
// its bits.
__device__ __forceinline__ float k1_cell(float i, float f, float g, float c_prev) {
  return __fmaf_rn(f, c_prev, __fmul_rn(i, g));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// acc[i][v][q] += sum over k < depth of x[r[i]][k] * w[k][q][v], k in order.
// x: rows xs elements apart in shared memory; w: the thread's unit pair of
// the CTA's columns, k rows kstride elements apart and gates qstride apart
// (shared memory when resident, else global).
template <int RPT, typename X, typename W>
__device__ __forceinline__ void gate_dot(float (&acc)[RPT][2][4], const X* x, int xs,
                                         const int (&r)[RPT], const W* w, int kstride,
                                         int qstride, int depth) {
  int k = 0;
#pragma unroll 2
  for (; k + 4 <= depth; k += 4) {
    float xv[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i) load4(x + r[i] * xs + k, xv[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const W* wk = w + static_cast<ll>(k + kk) * kstride;
      float wv[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) load2(wk + q * qstride, wv[q]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0][q] = fmaf(xv[i][kk], wv[q][0], acc[i][0][q]);
          acc[i][1][q] = fmaf(xv[i][kk], wv[q][1], acc[i][1][q]);
        }
    }
  }
  for (; k < depth; ++k) {  // an input size that is not a multiple of 4
    float wv[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q) load2(w + static_cast<ll>(k) * kstride + q * qstride, wv[q]);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float xv = to_f(x[r[i] * xs + k]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][0][q] = fmaf(xv, wv[q][0], acc[i][0][q]);
        acc[i][1][q] = fmaf(xv, wv[q][1], acc[i][1][q]);
      }
    }
  }
}

// Grid: ceil(B / R) clusters of n CTAs of (U / 2) * G threads (rounded up to
// a warp), G = encoder_groups(R, U), RPT = ceil(R / G).
template <typename T, int RPT>
__global__ void __launch_bounds__(kEncMaxThreads, 1) k1_encoder_sweep(const EncoderArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int H = a.H, in = a.in, U = a.units, R = a.rows, G = a.groups, B = a.batch;
  const int S = a.raw_len + 1;
  const int row0 = static_cast<int>(blockIdx.x) / n * R;
  const int j0 = rank * U;
  const ll G4 = 4ll * H;
  const int xs = enc_xs(in), hs = enc_hs(H);
  const EncSmem lay = enc_smem(sizeof(T), in, H, U, R, a.whh_res, a.wih_res);
  T* whh_s = reinterpret_cast<T*>(smem + lay.whh);
  T* wih_s = reinterpret_cast<T*>(smem + lay.wih);
  T* xb = reinterpret_cast<T*>(smem + lay.xb);
  float* hb = reinterpret_cast<float*>(smem + lay.hb);
  int* lens = reinterpret_cast<int*>(smem + lay.lens);
  const T* w_ih = static_cast<const T*>(a.w_ih);
  const T* w_hh = static_cast<const T*>(a.w_hh);
  const T* x_src = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  // The resident weights: row k of each gate's U columns, 4 bytes a copy.
  auto fill = [&](T* dst, const T* src, int depth) {
    const int words = U * static_cast<int>(sizeof(T)) / 4;
    for (int e = tid; e < depth * 4 * words; e += blockDim.x) {
      const int w = e % words, kq = e / words;
      cp_async4(reinterpret_cast<char*>(dst + static_cast<ll>(kq) * U) + 4 * w,
                reinterpret_cast<const char*>(src + (kq >> 2) * G4 + (kq & 3) * H + j0) + 4 * w,
                true);
    }
  };
  if (a.whh_res) fill(whh_s, w_hh, H);
  if (a.wih_res) fill(wih_s, w_ih, in);
  cp_async_commit();

  // Each row's length: its non-pad tokens, as the per-row kernel counted them.
  for (int r = warp; r < R; r += nwarps) {
    const int b = row0 + r;
    int cnt = 0;
    if (b < B)
      for (int l = lane; l < a.raw_len; l += 32)
        cnt += a.src[static_cast<ll>(b) * a.raw_len + l] != a.pad;
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) lens[r] = cnt;
  }
  for (int e = tid; e < 2 * R * hs; e += blockDim.x) hb[e] = 0.f;  // h_{-1} = 0, and the padding
  __syncthreads();

  // The steps the cluster runs: up to its rows' last @end@.
  int steps = 0;
  for (int r = 0; r < R; ++r)
    if (row0 + r < B) steps = max(steps, lens[r] + 1);

  // Row r's boundary token at step t: the raw token while t < len, @end@ at
  // t == len, pad after.
  auto token = [&](int r, int t) {
    const int len = lens[r];
    return t < len ? a.src[static_cast<ll>(row0 + r) * a.raw_len + t] : (t == len ? a.end : a.pad);
  };

  // x_t of the cluster's rows into xb[t & 1]: warp w copies rows w, w +
  // nwarps, ..., lane i of it having read the token of its i-th row.
  const bool by_words = (static_cast<ll>(in) * sizeof(T)) % 4 == 0;
  auto stage = [&](int t) {
    T* dst = xb + (t & 1) * R * xs;
    const int rl = warp + nwarps * lane;
    const int my_tok = a.layer == 0 && rl < R && row0 + rl < B ? token(rl, t) : a.pad;
    for (int i = 0; warp + nwarps * i < R; ++i) {
      const int r = warp + nwarps * i, b = row0 + r;
      const int tok = __shfl_sync(0xffffffffu, my_tok, i);
      const bool valid = a.layer == 0 ? tok != a.pad : b < B;
      const T* sp = a.layer == 0 ? x_src + static_cast<ll>(valid ? tok : 0) * in
                                 : x_src + (static_cast<ll>(valid ? b : 0) * S + t) * H;
      T* dp = dst + r * xs;
      if (by_words) {
        constexpr int per = 4 / sizeof(T);
        for (int w = lane; w < in / per; w += 32) cp_async4(dp + w * per, sp + w * per, valid);
      } else {  // bf16 rows of odd length are not 4-byte aligned
        for (int k = lane; k < in; k += 32) dp[k] = valid ? sp[k] : from_f<T>(0.f);
      }
    }
    cp_async_commit();
  };

  // This thread's unit pair and rows: lanes run over 4 row groups, then pairs.
  const int P = U / 2;
  const bool owner = tid < P * G;
  const int pair = owner ? tid / 4 % P : 0, g = owner ? tid / 4 / P * 4 + tid % 4 : 0;
  const int j = j0 + 2 * pair;
  int r[RPT];
  bool live[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int rr = g + G * i;
    live[i] = owner && rr < R && row0 + rr < B;
    r[i] = rr < R ? rr : 0;  // a slot past R reads row 0 and writes nothing
  }
  float bias[4][2];
#pragma unroll
  for (int q = 0; q < 4; ++q) load2(a.bias + q * H + j, bias[q]);

  // acc = bias + x_t . W_ih: the first half of step t's gates.
  float acc[RPT][2][4];
  auto x_part = [&](int t) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][0][q] = bias[q][0];
        acc[i][1][q] = bias[q][1];
      }
    const T* x = xb + (t & 1) * R * xs;
    if (a.wih_res)
      gate_dot<RPT>(acc, x, xs, r, wih_s + 2 * pair, 4 * U, U, in);
    else
      gate_dot<RPT>(acc, x, xs, r, w_ih + j, 4 * H, H, in);
  };

  float h_state[RPT][2], c_state[RPT][2];
#pragma unroll
  for (int i = 0; i < RPT; ++i) h_state[i][0] = h_state[i][1] = c_state[i][0] = c_state[i][1] = 0.f;
  stage(0);
  cp_async_wait_all();
  __syncthreads();
  x_part(0);
  cluster.sync();  // every CTA of the cluster runs, its h buffers zeroed, before any push into them

  for (int t = 0; t < steps; ++t) {
    const bool more = t + 1 < steps;
    if (more) stage(t + 1);  // in flight through this step
    int tk[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) tk[i] = live[i] ? token(r[i], t) : a.pad;
    if (t > 0) {  // + h_{t-1} . W_hh
      const float* h = hb + ((t - 1) & 1) * R * hs;
      if (a.whh_res)
        gate_dot<RPT>(acc, h, hs, r, whh_s + 2 * pair, 4 * U, U, H);
      else
        gate_dot<RPT>(acc, h, hs, r, w_hh + j, 4 * H, H, H);
    }
    float y[RPT][2];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const bool m = tk[i] != a.pad;  // packed-sequence semantics: the state freezes at pad steps
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float c_new = k1_cell(sigmoid(acc[i][v][0]), sigmoid(acc[i][v][1]),
                                    tanhf(acc[i][v][2]), c_state[i][v]);
        const float h_new = sigmoid(acc[i][v][3]) * tanhf(c_new);
        if (m) {
          c_state[i][v] = c_new;
          h_state[i][v] = h_new;
        }
        y[i][v] = m ? h_new : 0.f;
      }
    }
    if (more) {
      // h_t, rounded to T, into every CTA's buffer (its own included), then
      // the barrier's arrival; the outputs, the staged x and the next step's
      // x . W_ih overlap the wait for the other CTAs.
      float* slot = hb + (t & 1) * R * hs + j;
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (live[i])
          push_to_cluster(cluster, reinterpret_cast<float2*>(slot + r[i] * hs),
                          make_float2(rnd<T>(h_state[i][0]), rnd<T>(h_state[i][1])), n);
      cluster_arrive();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (live[i]) store2(out + (static_cast<ll>(row0 + r[i]) * S + t) * H + j, y[i][0], y[i][1]);
    if (more) {
      cp_async_wait_all();
      __syncthreads();  // every thread's copies of x_{t+1} have landed
      x_part(t + 1);
      cluster_wait();
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!live[i]) continue;
    const ll b = row0 + r[i];
    for (int t = steps; t < S; ++t) store2(out + (b * S + t) * H + j, 0.f, 0.f);
    if (a.h_final != nullptr) store2(a.h_final + b * H + j, h_state[i][0], h_state[i][1]);
  }
}

typedef void (*EncoderSweep)(const EncoderArgs);

template <typename T>
EncoderSweep encoder_kernel(int rpt) {
  switch (rpt) {
    case 1: return k1_encoder_sweep<T, 1>;
    case 2: return k1_encoder_sweep<T, 2>;
    case 3: return k1_encoder_sweep<T, 3>;
    default: return k1_encoder_sweep<T, 4>;
  }
}

int encoder_cluster(int H) {
  int n = 1;
  while (H / n > kEncMaxUnits) n *= 2;
  return n;
}

// The row groups of a CTA: a row a group, up to as many as kEncMaxThreads
// threads hold (a multiple of 4). With 32 units a CTA that is 8, so a
// cluster's 32 rows at most take 4 rows a thread.
int encoder_groups(int R, int U) {
  const int cap = kEncMaxThreads / (U / 2) / 4 * 4, want = 4 * sweep_ceil(R, 4);
  return want < cap ? want : cap;
}

int encoder_rpt(int R, int U) { return sweep_ceil(R, encoder_groups(R, U)); }

int encoder_threads(int R, int U) { return (U / 2 * encoder_groups(R, U) + 31) / 32 * 32; }

struct EncoderPlan {
  SweepPlan p;
  bool whh, wih;  // resident in shared memory
};

// The plan of a layer with `in` inputs and H units (a multiple of 32 up to
// 512) for B rows; the occupancy is read at the widest instance.
template <typename T>
cudaError_t encoder_plan(int B, int in, int H, cudaStream_t s, EncoderPlan* plan) {
  if (H % 32 != 0 || H < 32 || H > 16 * kEncMaxUnits || in < 1 || B < 1)
    return cudaErrorInvalidValue;
  const int n = encoder_cluster(H), U = H / n, sz = sizeof(T);
  auto bytes = [=](int R, bool whh, bool wih) { return enc_smem(sz, in, H, U, R, whh, wih).total; };
  const bool whh = bytes(kEncResidentRows, true, false) <= kSweepMaxSmem;
  const bool wih = bytes(kEncResidentRows, whh, true) <= kSweepMaxSmem;
  plan->whh = whh;
  plan->wih = wih;
  return plan_for(
      encoder_kernel<T>(kEncMaxRpt), [=](int R) { return bytes(R, whh, wih); },
      [=](int R) { return encoder_threads(R, U); }, kEncMaxRows, n, U, B, s, &plan->p);
}

template <typename T>
cudaError_t launch_encoder_layer(EncoderArgs a, cudaStream_t s) {
  EncoderPlan ep;
  SWEEP_TRY(encoder_plan<T>(a.batch, a.in, a.H, s, &ep));
  a.units = ep.p.units;
  a.rows = ep.p.rows;
  a.groups = encoder_groups(ep.p.rows, ep.p.units);
  a.whh_res = ep.whh;
  a.wih_res = ep.wih;
  const EncoderSweep kernel = encoder_kernel<T>(encoder_rpt(ep.p.rows, ep.p.units));
  SWEEP_TRY(sweep_attributes(kernel, ep.p.smem, ep.p.cluster));
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  sweep_config(ep.p.cluster, ep.p.threads, ep.p.smem, ep.p.clusters, s, &cfg, &attr);
  SWEEP_TRY(cudaLaunchKernelEx(&cfg, kernel, a));
  return cudaGetLastError();
}

// ------------------------------------------------------------------ decoder
struct SampleParams {
  const int* src;
  int batch, raw_len;
  const float* noise;
  int noise_stride;
  unsigned long long seed;
  const void* tgt_emb;
  const void* dec_wih;
  const void* dec_whh;
  const float* dec_bias;
  const void* proj_w;
  const float* proj_b;
  const void* enc_out;
  const float* h0;
  int* preds;
  float* loss;
  float* logprobs;
  int D, H, V, T;
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
  const int H = p.H, D = p.D, V = p.V, S = p.raw_len + 1, XS = H + D;
  float* xin = sm;                       // [kRows][H + D] cell input (rounded)
  float* hd = xin + kRows * XS;          // [kRows][H] decoder hidden
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
  const T* tgt_emb = static_cast<const T*>(p.tgt_emb);
  const T* dec_wih = static_cast<const T*>(p.dec_wih);
  const T* dec_whh = static_cast<const T*>(p.dec_whh);
  const T* proj_w = static_cast<const T*>(p.proj_w);
  const T* enc = static_cast<const T*>(p.enc_out);

  if (tid < kRows) {
    const int b = row0 + tid;
    int n = 0;
    if (b < p.batch)
      for (int l = 0; l < p.raw_len; ++l) n += p.src[static_cast<size_t>(b) * p.raw_len + l] != p.pad;
    lens[tid] = n;
    tok[tid] = p.start;
    rowf[4 * tid + 0] = 1.f;  // alive: no @end@ yet
    rowf[4 * tid + 1] = 0.f;  // kill: the first token was @end@
    rowf[4 * tid + 2] = 0.f;
    rowf[4 * tid + 3] = 0.f;
  }
  // The encoder's final top-layer hidden state; context zero.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = row0 + r;
    const int i = r * H + u;
    hd[i] = b < p.batch ? p.h0[static_cast<size_t>(b) * H + u] : 0.f;
    cd[i] = 0.f;
    hdr[i] = rnd<T>(hd[i]);
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
      const float c_new = k1_cell(sigmoid(acc[0][r]), sigmoid(acc[1][r]), tanhf(acc[2][r]), cd[i]);
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
  const size_t floats = static_cast<size_t>(kRows) * (p.H + p.D) + 3ull * kRows * p.H +
                        static_cast<size_t>(kRows) * S + static_cast<size_t>(kRows) * p.V +
                        4 * kRows;
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
}  // namespace probnmn

using namespace probnmn;

// The encoder: one k1_encoder_sweep launch a layer. dtype: 0 float32, 1
// bfloat16. src (B, raw_len) int32; src_emb (V, D), enc_wih (the layers'
// (in, 4H) one after another), enc_whh (L, H, 4H) in the dtype; enc_bias
// (L, 4H) float32. Writes enc_out (B, raw_len + 1, H) in the dtype and
// h_final (B, H) float32; enc_tmp, another (B, raw_len + 1, H), holds the
// layers below the top (null for one layer). Launches on `stream`.
extern "C" int probnmn_k1_encode(int dtype, const void* src, int batch, int raw_len,
                                 const void* src_emb, const void* enc_wih, const void* enc_whh,
                                 const void* enc_bias, void* enc_out, void* enc_tmp,
                                 void* h_final, int input_size, int hidden, int num_layers,
                                 int pad, int end, void* stream) {
  if (batch <= 0) return 0;
  if (num_layers < 1 || (num_layers > 1 && enc_tmp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t sz = dtype == 1 ? sizeof(bf16) : sizeof(float);
  const size_t G = 4ull * hidden;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  EncoderArgs a{};
  a.src = static_cast<const int*>(src);
  a.batch = batch;
  a.raw_len = raw_len;
  a.H = hidden;
  a.pad = pad;
  a.end = end;
  for (int l = 0; l < num_layers; ++l) {
    void* mine = (num_layers - 1 - l) % 2 == 0 ? enc_out : enc_tmp;  // the top layer's is enc_out
    a.layer = l;
    a.in = l == 0 ? input_size : hidden;
    a.x = l == 0 ? src_emb : a.out;
    a.out = mine;
    a.w_ih = static_cast<const char*>(enc_wih) +
             sz * (l == 0 ? 0 : static_cast<size_t>(input_size) * G + (l - 1ull) * hidden * G);
    a.w_hh = static_cast<const char*>(enc_whh) + sz * l * hidden * G;
    a.bias = static_cast<const float*>(enc_bias) + l * G;
    a.h_final = l == num_layers - 1 ? static_cast<float*>(h_final) : nullptr;
    const cudaError_t err =
        dtype == 1 ? launch_encoder_layer<bf16>(a, s) : launch_encoder_layer<float>(a, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The plan of an encoder layer with `input_size` inputs: out = {the cluster
// size, units a CTA, rows a cluster, threads a CTA, clusters, clusters the
// card runs at once, shared memory bytes a CTA, W_hh resident, W_ih
// resident, row groups, rows a thread, registers a thread}.
extern "C" int probnmn_k1_encoder_plan(int dtype, int batch, int input_size, int hidden, int* out) {
  EncoderPlan ep;
  cudaError_t err = dtype == 1 ? encoder_plan<bf16>(batch, input_size, hidden, nullptr, &ep)
                               : encoder_plan<float>(batch, input_size, hidden, nullptr, &ep);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) {
    const int rpt = encoder_rpt(ep.p.rows, ep.p.units);
    err = cudaFuncGetAttributes(&attr, dtype == 1 ? encoder_kernel<bf16>(rpt)
                                                  : encoder_kernel<float>(rpt));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[] = {ep.p.cluster, ep.p.units, ep.p.rows, ep.p.threads,
                   ep.p.clusters, ep.p.fit, static_cast<int>(ep.p.smem), ep.whh,
                   ep.wih, encoder_groups(ep.p.rows, ep.p.units), encoder_rpt(ep.p.rows, ep.p.units),
                   attr.numRegs};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

// The decoder, from the encoder's outputs enc_out (B, raw_len + 1, H) in the
// dtype and its final hidden state h0 (B, H) float32. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int probnmn_k1_decode(
    int dtype, const void* src, int batch, int raw_len, const void* noise, int noise_stride,
    unsigned long long seed, const void* tgt_emb, const void* dec_wih, const void* dec_whh,
    const void* dec_bias, const void* proj_w, const void* proj_b, const void* enc_out,
    const void* h0, void* preds, void* loss, void* logprobs, int input_size, int hidden,
    int vocab, int num_steps, int pad, int unk, int start, int end, void* stream) {
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
  p.tgt_emb = tgt_emb;
  p.dec_wih = dec_wih;
  p.dec_whh = dec_whh;
  p.dec_bias = static_cast<const float*>(dec_bias);
  p.proj_w = proj_w;
  p.proj_b = static_cast<const float*>(proj_b);
  p.enc_out = enc_out;
  p.h0 = static_cast<const float*>(h0);
  p.preds = static_cast<int*>(preds);
  p.loss = static_cast<float*>(loss);
  p.logprobs = static_cast<float*>(logprobs);
  p.D = input_size;
  p.H = hidden;
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
