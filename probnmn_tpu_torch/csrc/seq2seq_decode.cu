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
// each other; a batch of 256 is 24.5 GFLOP (25 us at the bf16 tensor peak).
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
// The decoder (seq2seq_sample_kernel) is one persistent launch of the same
// kind: a cluster of n CTAs owns R rows for all T steps, each CTA U hidden
// units (16 up to H = 256, else 32; n = H / U: 8 at H = 128, 16 at 256 and
// 512, above the portable size) and all four gates of each, 256 threads.
// Two cluster barriers a step. Before the first, each CTA does the
// row-wise work of the rows it owns (rows rank, rank + n, ...): step t-1's
// projection over V, log-softmax, Gumbel-max draw, trim and loss terms, then
// step t's attention scores, masked softmax and context; it writes their
// cell input (the context rounded to T; float32 also the previous token's
// embedding, bf16 the token) into its own buffers and copies it into the
// other CTAs through distributed shared memory in 16-byte pieces (copying
// word by word into 15 CTAs cost several times more). Between the two,
// each CTA computes its units' gates for all R rows and copies its units'
// new h, rounded to T, the same way. h has one buffer: bf16 computes
// h_{t-1} . W_hh before the first barrier, so nothing reads h_{t-1} after
// it; float32 meets a third barrier before overwriting it. A CTA keeps in
// shared memory what fits, decided by decoder_plan at the rows the clusters
// would take: its columns of W_hh, then of W_ih, then its rows' encoder
// outputs, then the projection; the rest is read from L2 (float32's
// weights streamed through a cp.async ring) once a step per CTA. bf16:
// the gate products run on mma.sync m16n8k16 (bf16 in, float32 sums, R
// padded to 16-row m-tiles, W's columns of a unit pair's four gates making
// one 8-column n-tile, so a quad of lanes swaps the gates of its cells by
// shuffles), over the context and h only: the embedding's part, bias +
// tgt_emb[v] . W_ih[H:], is a (V, 4U) table each CTA computes on the tensor
// cores once a launch; the scores, the context and the projection run on
// mma.sync too. float32 sums in a fixed order on the SIMT cores (each gate
// bias, then x . W_ih over k, then h . W_hh over k, as the encoder sweep
// sums them, one unit a thread; the scores a warp each, the context and
// the projection serial chains), the order of the 2-rows-a-block kernel
// this one replaced, whose bits it keeps. What bounds a step is its serial
// chain of nine phases on the up to 4 rows a CTA owns, each a few thousand
// cycles of latency (tools/k1_phases.py splits it), not FLOPs or bytes.
//
// Both write the cell's contraction out (k1_cell), so their bits do not
// depend on what the compiler fuses.
//
// Noise: an explicit (T, B, stride) float32 tensor, or Philox4x32-10 with
// counter (v / 4, step, row, 0) and key seed, word v % 4, mapped to Gumbel as
// u = (bits >> 8) * 2^-24 + 1e-12, g = -log(-log(u)). The row word is
// row_base + b: a launch over rows [r, r + B) of a larger batch draws those
// rows of the larger batch's stream.

#include "cluster_sweep.cuh"
#include "common.cuh"

namespace probnmn {
namespace {

typedef long long ll;

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

// acc[i][q] += sum over k < depth of x[r[i]][k] * w[k][q], k in order:
// gate_dot for one unit, its four weights a k read as scalars (a warp's
// lanes on adjacent units, one pass of shared memory each).
template <int RPT, typename X, typename W>
__device__ __forceinline__ void gate_dot1(float (&acc)[RPT][4], const X* x, int xs,
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
      float wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[q] = to_f(wk[q * qstride]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(xv[i][kk], wv[q], acc[i][q]);
    }
  }
  for (; k < depth; ++k) {  // an input size that is not a multiple of 4
    float wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wv[q] = to_f(w[static_cast<ll>(k) * kstride + q * qstride]);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float xv = to_f(x[r[i] * xs + k]);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(xv, wv[q], acc[i][q]);
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

// Inter-layer dropout on the encoder's way up (torch nn.LSTM(dropout=p), as
// the JAX package's lstm_encode applies it): the layer below's outputs
// (B, S, H) in T, in place, v = keep ? round_T(v * scale) : 0 with keep the
// layer's (B, S, H) byte mask. One elementwise pass a layer above the first,
// beside the sweeps: masking inside the sweep's staged x loads (cp.async a
// step ahead) would put a byte load and a select on every step of the
// serial chain. The plain version rounds (y * keep) * scale to T as the
// layer above's matmul operand: the same value.
template <typename T>
__global__ void k1_dropout(T* v, const unsigned char* __restrict__ keep, ll n, float scale) {
  const ll idx = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  v[idx] = keep[idx] ? from_f<T>(to_f(v[idx]) * scale) : from_f<T>(0.f);
}

// ------------------------------------------------------------------ decoder
constexpr int kDecThreads = 256;  // 8 warps a CTA
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecMaxRows = 48;  // rows a cluster owns at most: three 16-row m-tiles
constexpr int kDecMaxOwn = 4;    // rows a CTA owns for the row-wise work at most
constexpr int kRingStages = 6;   // float32: stages of the ring a matrix not resident streams through
constexpr int kRingRows = 16;    // its rows a stage
constexpr float kNegInf = -1e9f;

struct DecoderArgs {
  const int* src;  // (B, raw_len)
  int batch, raw_len;
  const float* noise;  // (T, B, noise_stride), or null: Philox
  int noise_stride;
  unsigned long long seed;
  int row_base;  // the Philox counter's row word is row_base + b
  const void* tgt_emb;  // (V, D)
  const void* w_ih;     // (H + D, 4H)
  const void* w_hh;     // (H, 4H)
  const float* bias;    // (4H,) b_ih + b_hh
  const void* proj;     // (H, V)
  const float* proj_b;  // (V,)
  const void* enc;      // (B, S, H) the encoder's outputs
  const float* h0;      // (B, H) its final hidden state
  int* preds;
  float* loss;
  float* logprobs;
  int D, H, V, T;
  int pad, unk, start, end;
  int units, rows, wh_res, wx_res, enc_res, proj_res;  // the plan
};

// Units a CTA: 16 up to H = 256 (n = H / 16 CTAs, 16 at H = 256), else 32.
__host__ __device__ __forceinline__ int dec_units(int H) { return H <= 256 ? 16 : 32; }
// Row pitches in elements. bf16: cell inputs and h padded by 8 and the
// resident weights' [k][4U] rows by 8, so that the eight rows an ldmatrix
// reads fall on distinct banks; float32: the encoder sweep's paddings.
__host__ __device__ __forceinline__ int dec_xs(bool bf, int H, int D) {
  return bf ? H + 8 : enc_xs(H + D);
}
__host__ __device__ __forceinline__ int dec_hs(bool bf, int H) { return bf ? H + 8 : enc_hs(H); }
__host__ __device__ __forceinline__ int dec_ws(bool bf, int U) { return bf ? 4 * U + 8 : 4 * U; }
// The owned rows' resident encoder outputs: bf16 rows of H + 8 elements and
// S rounded up to 16 positions (zeros past S), for ldmatrix; the projection
// in bf16 as [k][round8(V) + 8], for ldmatrix.
__host__ __device__ __forceinline__ int dec_es(bool bf, int H) { return bf ? H + 8 : H; }
__host__ __device__ __forceinline__ int dec_sp(bool bf, int S) { return bf ? (S + 15) / 16 * 16 : S; }
__host__ __device__ __forceinline__ int dec_vp(bool bf, int V) { return bf ? (V + 7) / 8 * 8 + 8 : V; }

// Shared memory, byte offsets: the resident weights (W_hh, then W_ih: in
// bf16 its H context rows, in float32 all H + D), the token table (bf16:
// (V, 4U) float32), the cell inputs xb[r] (bf16: the context; float32:
// context and embedding), h, the
// owned rows' encoder outputs, the projection, the ring (float32, where a
// matrix is not resident), and the owned rows' attention, logits, Gumbel
// noise, state (alive, kill, logprob sum, count), the cluster's rows'
// tokens, the owned rows' lengths.
struct DecSmem {
  size_t wh, wx, table, xb, hb, enc, proj, ring, att, logit, gum, rowf, toks, lens, total;
};

__host__ __device__ __forceinline__ DecSmem dec_smem(bool bf, int D, int H, int V, int S, int U,
                                                     int n, int R, bool wh, bool wx, bool enc,
                                                     bool proj) {
  const size_t sz = bf ? 2 : 4;
  const size_t own = (R + n - 1) / n;
  DecSmem m;
  m.wh = 0;
  m.wx = m.wh + align16(wh ? sz * H * dec_ws(bf, U) : 0);
  m.table = m.wx + align16(wx ? sz * (bf ? H : H + D) * dec_ws(bf, U) : 0);
  m.xb = m.table + align16(bf ? 16ull * V * U : 0);
  m.hb = m.xb + align16(sz * R * dec_xs(bf, H, D));
  m.enc = m.hb + align16(sz * R * dec_hs(bf, H));
  m.proj = m.enc + align16(enc ? sz * own * dec_sp(bf, S) * dec_es(bf, H) : 0);
  m.ring = m.proj + align16(proj ? sz * H * dec_vp(bf, V) : 0);
  m.att = m.ring + align16(!bf && !(wh && wx) ? 4ull * kRingStages * kRingRows * 4 * U : 0);
  m.logit = m.att + align16(4 * own * S);
  m.gum = m.logit + align16(4 * own * V);
  m.rowf = m.gum + align16(4 * own * V);
  m.toks = m.rowf + align16(16 * own);
  m.lens = m.toks + align16(4ull * R);
  m.total = m.lens + align16(4 * own);
  return m;
}

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// Four 8 x 8 bf16 matrices from shared memory, lane 8 i + j giving row j of
// matrix i; .trans gives each matrix transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (16 x 8, float32) += a (16 x 16, bf16) . b (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// Element i of four registers, i known only at run time (no local memory).
__device__ __forceinline__ float pick4(const float (&v)[4], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : (i == 2 ? v[2] : v[3]));
}

// The global column of a CTA's bf16 gate column c = 8 p + 2 q + e: gate q of
// unit j0 + 2 p + e. An 8-column n-tile is one unit pair's four gates.
__device__ __forceinline__ int dec_column(int c, int H, int j0) {
  return (c >> 1 & 3) * H + j0 + 2 * (c >> 3) + (c & 1);
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lane sub's share of a logit in an 8-lane group (bf16): h[k] w[k V] over
// k = sub, sub + 8, ...
template <typename T>
__device__ __forceinline__ float logit_part(const T* h, const T* w, int V, int H, int sub) {
  float acc = 0.f;
#pragma unroll 8
  for (int k = sub; k < H; k += 8) acc = fmaf(to_f(h[k]), to_f(w[k * V]), acc);
  return acc;
}

// A logit summed in float32's fixed order: the bias, then h[k] w[k V] over
// k in order.
template <typename T>
__device__ __forceinline__ float logit_chain(float acc, const T* h, const T* w, int V, int H) {
#pragma unroll 16
  for (int k = 0; k < H; ++k) acc = fmaf(to_f(h[k]), to_f(w[k * V]), acc);
  return acc;
}

// Lane sub's share of a score in an 8-lane group (bf16): e[k] h[k] over
// its 8-unit pieces k = 8 sub, 8 sub + 64, ...
__device__ __forceinline__ float score_part(const bf16* e, const bf16* h, int H, int sub) {
  float part = 0.f;
  for (int k = 8 * sub; k < H; k += 64) {
    const uint4 ev = *reinterpret_cast<const uint4*>(e + k);
    const uint4 hv = *reinterpret_cast<const uint4*>(h + k);
    const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&ev);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(e2[i]), y = __bfloat1622float2(h2[i]);
      part = fmaf(x.x, y.x, part);
      part = fmaf(x.y, y.y, part);
    }
  }
  return part;
}

// c += the context of four units in float32's fixed order: w[s]
// e[s stride + (0 .. 3)] over s in order.
template <typename T>
__device__ __forceinline__ void context_quad(const float* w, const T* e, int S, int stride,
                                             float (&c)[4]) {
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    float ev[4];
    load4(e + static_cast<ll>(s) * stride, ev);
#pragma unroll
    for (int u = 0; u < 4; ++u) c[u] = fmaf(w[s], ev[u], c[u]);
  }
}

// The 16 bytes at `slot` in this CTA's shared memory into the same place in
// the cluster's other CTAs.
__device__ __forceinline__ void copy_to_peers(cg::cluster_group& cluster, uint4* slot, int rank,
                                              int n) {
  const uint4 v = *slot;
  for (int q = 1; q < n; ++q) {
    const int peer = rank + q < n ? rank + q : rank + q - n;
    *cluster.map_shared_rank(slot, peer) = v;
  }
}

// acc[mt][nt] += A . B over k < depth (a multiple of 32) for the warp's
// n-tiles nt0 .. nt0 + NT - 1: A's rows (clamped to R - 1) `as` elements
// apart in shared memory; B either resident ([k][c], `bs` apart, read by
// ldmatrix.trans) or the global (depth, 4H) k-major matrix gathered through
// dec_column.
template <int MT, int NT>
__device__ __forceinline__ void gate_mma(float (&acc)[MT][NT][4], const bf16* A, int as, int R,
                                         const bf16* B, int bs, bool resident, int H, int j0,
                                         int nt0, int depth, int lane) {
  uint32_t a_row[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = min(mt * 16 + (lane >> 3 & 1) * 8 + (lane & 7), R - 1);
    a_row[mt] = smem_addr(A + row * as + (lane >> 4) * 8);
  }
  const int g = lane >> 2, tq = lane & 3;
  int col[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) col[nt] = dec_column((nt0 + nt) * 8 + g, H, j0);
  const long long G4 = 4ll * H;
  for (int k = 0; k < depth; k += 32) {
    uint32_t b[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (resident) {
        ldsm_x4_trans(b[nt], smem_addr(B + (k + lane) * bs + (nt0 + nt) * 8));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bf16* w = B + (k + 8 * i + 2 * tq) * G4 + col[nt];
          b[nt][i] = pack_bf16(w[0], w[G4]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, a_row[mt] + (k + 16 * kk) * 2);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt][2 * kk], b[nt][2 * kk + 1]);
      }
    }
  }
}

// Grid: clusters of n CTAs of kDecThreads threads. bf16: MT 16-row m-tiles
// and NT = U / 16 n-tiles a warp; float32: RPT rows a thread.
template <typename T, int MT, int NT, int RPT>
__global__ void __launch_bounds__(kDecThreads, 1) seq2seq_sample_kernel(const DecoderArgs a) {
  constexpr bool kBf = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int H = a.H, D = a.D, V = a.V, U = a.units, R = a.rows, B = a.batch;
  const int S = a.raw_len + 1;
  const int own = (R + n - 1) / n;
  const int row0 = static_cast<int>(blockIdx.x) / n * R;
  const int j0 = rank * U;
  const long long G4 = 4ll * H;
  const int xs = dec_xs(kBf, H, D), hs = dec_hs(kBf, H), ws = dec_ws(kBf, U);
  const int es = dec_es(kBf, H), sp = dec_sp(kBf, S), vp = dec_vp(kBf, V);
  const DecSmem lay = dec_smem(kBf, D, H, V, S, U, n, R, a.wh_res, a.wx_res, a.enc_res, a.proj_res);
  T* wh_s = reinterpret_cast<T*>(smem + lay.wh);
  T* wx_s = reinterpret_cast<T*>(smem + lay.wx);
  float* table = reinterpret_cast<float*>(smem + lay.table);
  T* xb = reinterpret_cast<T*>(smem + lay.xb);
  T* hb = reinterpret_cast<T*>(smem + lay.hb);
  T* enc_s = reinterpret_cast<T*>(smem + lay.enc);
  T* proj_s = reinterpret_cast<T*>(smem + lay.proj);
  T* ring = reinterpret_cast<T*>(smem + lay.ring);
  float* att = reinterpret_cast<float*>(smem + lay.att);
  float* logit = reinterpret_cast<float*>(smem + lay.logit);
  float* gum = reinterpret_cast<float*>(smem + lay.gum);
  float* rowf = reinterpret_cast<float*>(smem + lay.rowf);
  int* toks = reinterpret_cast<int*>(smem + lay.toks);
  int* lens = reinterpret_cast<int*>(smem + lay.lens);
  const T* w_ih = static_cast<const T*>(a.w_ih);
  const T* w_hh = static_cast<const T*>(a.w_hh);
  const T* tgt_emb = static_cast<const T*>(a.tgt_emb);
  const T* enc = static_cast<const T*>(a.enc);
  const T* proj_g = static_cast<const T*>(a.proj);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;

  // Owned row o is the cluster's row rank + n o. Its encoder outputs: in
  // shared memory sp rows es elements apart, or in global memory.
  auto live = [&](int o) { return rank + n * o < R && row0 + rank + n * o < B; };
  auto enc_global = [&](int o) { return enc + static_cast<ll>(row0 + rank + n * o) * S * H; };

  // Resident weights, encoder outputs and projection, by cp.async. bf16
  // weights land as the products read them: row k of a matrix holds the
  // CTA's gate columns in dec_column's order. float32 ones as the encoder
  // sweep keeps them: row k holds each gate's U columns.
  auto fill = [&](T* dst, const T* src, int depth) {
    if constexpr (kBf) {
      for (int e = tid; e < depth * 2 * U; e += kDecThreads) {
        const int k = e / (2 * U), w = e % (2 * U);
        cp_async4(dst + k * ws + 2 * w, src + k * G4 + dec_column(2 * w, H, j0), true);
      }
    } else {
      for (int e = tid; e < depth * 4 * U; e += kDecThreads) {
        const int k = e / (4 * U), c = e % (4 * U);
        cp_async4(dst + k * ws + c, src + k * G4 + c / U * H + j0 + c % U, true);
      }
    }
  };
  if (a.wh_res) fill(wh_s, w_hh, H);
  if (a.wx_res) fill(wx_s, w_ih, kBf ? H : H + D);
  if (a.enc_res) {
    const int pieces = H * static_cast<int>(sizeof(T)) / 16;  // of a source position's outputs
    for (int o = 0; o < own; ++o) {
      if (!live(o)) continue;
      const T* src = enc_global(o);
      T* dst = enc_s + o * sp * es;
      for (int e = tid; e < sp * pieces; e += kDecThreads) {
        const int s = e / pieces, c = e % pieces * 16 / static_cast<int>(sizeof(T));
        if (s < S)
          cp_async16(dst + s * es + c, src + s * H + c);
        else  // bf16's rows up to a multiple of 16, zero
          *reinterpret_cast<uint4*>(dst + s * es + c) = make_uint4(0, 0, 0, 0);
      }
    }
  }
  if (a.proj_res) {
    if constexpr (kBf) {  // [k][vp]: V columns, then zeros, for ldmatrix
      for (int e = tid; e < H * (vp - V); e += kDecThreads)
        proj_s[e / (vp - V) * vp + V + e % (vp - V)] = from_f<T>(0.f);
      if (V % 2 == 0) {  // rows of 4-byte words
        for (int e = tid; e < H * (V / 2); e += kDecThreads) {
          const int k = e / (V / 2), w = 2 * (e % (V / 2));
          cp_async4(proj_s + k * vp + w, proj_g + k * V + w, true);
        }
      } else {
        for (int e = tid; e < H * V; e += kDecThreads) proj_s[e / V * vp + e % V] = proj_g[e];
      }
    } else {
      for (int e = tid; e < H * V; e += kDecThreads) cp_async4(proj_s + e, proj_g + e, true);
    }
  }
  cp_async_commit();

  // The owned rows' lengths (their non-pad tokens) and state; every row's
  // first input token; the cell inputs zeroed; h_{-1} = the encoder's final
  // state rounded to T, zero for rows past the batch.
  for (int o = warp; o < own; o += kDecWarps) {
    int cnt = 0;
    if (live(o))
      for (int l = lane; l < a.raw_len; l += 32)
        cnt += a.src[static_cast<ll>(row0 + rank + n * o) * a.raw_len + l] != a.pad;
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) {
      lens[o] = cnt;
      rowf[4 * o + 0] = 1.f;  // alive: no @end@ yet
      rowf[4 * o + 1] = 0.f;  // kill: the first token was @end@
      rowf[4 * o + 2] = 0.f;
      rowf[4 * o + 3] = 0.f;
    }
  }
  for (int r = tid; r < R; r += kDecThreads) toks[r] = a.start;
  for (int e = tid; e < R * xs; e += kDecThreads) xb[e] = from_f<T>(0.f);
  for (int e = tid; e < R * hs; e += kDecThreads) hb[e] = from_f<T>(0.f);
  __syncthreads();
#pragma unroll 4
  for (int e = tid; e < min(R, B - row0) * (H / 4); e += kDecThreads) {
    const int r = e / (H / 4), k = 4 * (e % (H / 4));
    const float4 h = *reinterpret_cast<const float4*>(a.h0 + static_cast<ll>(row0 + r) * H + k);
    store2(hb + r * hs + k, h.x, h.y);
    store2(hb + r * hs + k + 2, h.z, h.w);
  }

  // bf16: the embedding's part of the gates, a (V, 4U) table of
  // bias + tgt_emb[v] . W_ih[H:, c], one product a launch on the tensor
  // cores instead of one a step.
  if constexpr (kBf) {
    const T* we = w_ih + H * G4;
    auto emb = [&](int v, int k) {
      return v < V && k < D ? tgt_emb[static_cast<ll>(v) * D + k] : from_f<T>(0.f);
    };
    auto wgt = [&](int k, int c) { return k < D ? we[k * G4 + c] : from_f<T>(0.f); };
    for (int v0 = 0; v0 < V; v0 += 16) {
      float acc[NT][4] = {};
#pragma unroll 4
      for (int k = 0; k < D; k += 16) {
        uint32_t af[4];
        af[0] = pack_bf16(emb(v0 + g, k + 2 * tq), emb(v0 + g, k + 2 * tq + 1));
        af[1] = pack_bf16(emb(v0 + g + 8, k + 2 * tq), emb(v0 + g + 8, k + 2 * tq + 1));
        af[2] = pack_bf16(emb(v0 + g, k + 2 * tq + 8), emb(v0 + g, k + 2 * tq + 9));
        af[3] = pack_bf16(emb(v0 + g + 8, k + 2 * tq + 8), emb(v0 + g + 8, k + 2 * tq + 9));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = dec_column((warp * NT + nt) * 8 + g, H, j0);
          mma_bf16(acc[nt], af, pack_bf16(wgt(k + 2 * tq, c), wgt(k + 2 * tq + 1, c)),
                   pack_bf16(wgt(k + 2 * tq + 8, c), wgt(k + 2 * tq + 9, c)));
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = (warp * NT + nt) * 8 + 2 * tq;
        const float b0 = a.bias[dec_column(c, H, j0)], b1 = a.bias[dec_column(c + 1, H, j0)];
        if (v0 + g < V) store2(table + (v0 + g) * 4 * U + c, acc[nt][0] + b0, acc[nt][1] + b1);
        if (v0 + g + 8 < V)
          store2(table + (v0 + g + 8) * 4 * U + c, acc[nt][2] + b0, acc[nt][3] + b1);
      }
    }
  }

  // float32: this thread's unit j0 + unit and its rows.
  const int G = kDecThreads / U;
  const int unit = tid % U, grp = tid / U;
  int r32[RPT];
  bool live32[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int rr = grp + G * i;
    live32[i] = rr < R && row0 + rr < B;
    r32[i] = rr < R ? rr : 0;
  }
  float c32[RPT] = {};
  float c16[MT][NT] = {};

  // float32: acc += x . W over k < depth, W (depth, 4H) k-major in global
  // memory, its CTA columns staged through the ring kRingRows rows a stage.
  auto stream = [&](float (&acc)[RPT][4], const T* x, int xstride, const T* w, int depth) {
    const int stages = (depth + kRingRows - 1) / kRingRows;
    auto load = [&](int st) {
      if (st < stages) {
        T* dst = ring + (st % kRingStages) * kRingRows * 4 * U;
        for (int c = tid; c < kRingRows * U; c += kDecThreads) {
          const int k = st * kRingRows + c / U, q = c % U / (U / 4), u = c % (U / 4) * 4;
          if (k < depth) cp_async16(dst + (c / U) * 4 * U + q * U + u, w + k * G4 + q * H + j0 + u);
        }
      }
      cp_async_commit();
    };
    for (int st = 0; st < kRingStages - 1; ++st) load(st);
    for (int st = 0; st < stages; ++st) {
      cp_async_wait_group<kRingStages - 2>();
      __syncthreads();  // stage st has landed; every thread is done with stage st - 1's slot
      load(st + kRingStages - 1);
      const int k0 = st * kRingRows;
      gate_dot1<RPT>(acc, x + k0, xstride, r32, ring + (st % kRingStages) * kRingRows * 4 * U + unit,
                     4 * U, U, min(kRingRows, depth - k0));
    }
    __syncthreads();  // the ring is free for the next matrix
  };

  cp_async_wait_all();
  __syncthreads();
  cluster.sync();  // every CTA of the cluster runs, its buffers set, before any push into them

  float acc16[MT][NT][4];
  for (int t = 0; t <= a.T; ++t) {
    // hb holds h_{t-1}, rounded to T, of every row of the cluster.
    if constexpr (kBf) {
      // h_{t-1} . W_hh first: nothing reads h_{t-1} after barrier A, so h_t
      // can overwrite it in place.
      if (t < a.T) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc16[mt][nt][i] = 0.f;
        gate_mma<MT, NT>(acc16, reinterpret_cast<const bf16*>(hb), hs, R,
                         reinterpret_cast<const bf16*>(a.wh_res ? wh_s : w_hh), ws, a.wh_res, H,
                         j0, warp * NT, H, lane);
      }
    }
    // 1. The projection of h_{t-1} (step t-1's logits) and its Gumbel
    // noise, and the attention scores of h_{t-1}, for the owned rows.
    if (t > 0) {
      for (int e = tid; e < own * V; e += kDecThreads) {
        const int o = e / V, v = e % V, b = row0 + rank + n * o;
        if (live(o))
          gum[e] = a.noise != nullptr
                       ? a.noise[(static_cast<ll>(t - 1) * B + b) * a.noise_stride + v]
                       : philox_gumbel(a.seed, a.row_base + b, t - 1, v);
      }
      if constexpr (kBf) {
        if (a.proj_res) {  // one 16-row m-tile of the owned rows, a warp an 8-column n-tile
          const int o_a = (lane >> 3 & 1) * 8 + (lane & 7);
          const int r_a = o_a < own && rank + n * o_a < R ? rank + n * o_a : 0;
          const uint32_t a_row = smem_addr(hb + r_a * hs + (lane >> 4) * 8);
          for (int nt = warp; nt < vp / 8 - 1; nt += kDecWarps) {
            float c[4] = {};
            for (int k = 0; k < H; k += 32) {
              uint32_t b[4];
              ldsm_x4_trans(b, smem_addr(proj_s + (k + lane) * vp + nt * 8));
#pragma unroll
              for (int kk = 0; kk < 2; ++kk) {
                uint32_t af[4];
                ldsm_x4(af, a_row + (k + 16 * kk) * 2);
                mma_bf16(c, af, b[2 * kk], b[2 * kk + 1]);
              }
            }
            const int v = nt * 8 + 2 * tq;
            if (g < own && live(g)) {
              if (v < V) logit[g * V + v] = c[0] + a.proj_b[v];
              if (v + 1 < V) logit[g * V + v + 1] = c[1] + a.proj_b[v + 1];
            }
          }
        } else {  // 8 lanes a logit, the units split between them
          const int sub = lane & 7;
          const unsigned gmask = 0xffu << (lane & 24);
          for (int e = tid >> 3; e < own * V; e += kDecThreads / 8) {
            const int o = e / V, v = e % V;
            if (!live(o)) continue;
            float acc = logit_part(hb + (rank + n * o) * hs, proj_g + v, V, H, sub);
            for (int off = 4; off > 0; off >>= 1) acc += __shfl_xor_sync(gmask, acc, off);
            if (sub == 0) logit[o * V + v] = acc + a.proj_b[v];
          }
        }
      } else {  // a serial chain a logit, in the fixed order
        for (int e = tid; e < own * V; e += kDecThreads) {
          const int o = e / V, v = e % V;
          if (!live(o)) continue;
          const T* h = hb + (rank + n * o) * hs;
          logit[o * V + v] = a.proj_res ? logit_chain(a.proj_b[v], h, proj_s + v, V, H)
                                        : logit_chain(a.proj_b[v], h, proj_g + v, V, H);
        }
      }
    }
    if (t < a.T) {
      if (kBf && a.enc_res) {
        // E (16 source positions an m-tile) . h (as every column of B), a
        // warp an (owned row, m-tile).
        for (int e = warp; e < own * (sp / 16); e += kDecWarps) {
          const int o = e / (sp / 16), s0 = e % (sp / 16) * 16;
          if (!live(o)) continue;
          const bf16* h = reinterpret_cast<const bf16*>(hb) + (rank + n * o) * hs + 2 * tq;
          const uint32_t a_row = smem_addr(reinterpret_cast<const bf16*>(enc_s) +
                                           (o * sp + s0 + (lane >> 3 & 1) * 8 + (lane & 7)) * es +
                                           (lane >> 4) * 8);
          float c[4] = {};
          for (int k = 0; k < H; k += 16) {
            uint32_t af[4];
            ldsm_x4(af, a_row + 2 * k);
            mma_bf16(c, af, *reinterpret_cast<const uint32_t*>(h + k),
                     *reinterpret_cast<const uint32_t*>(h + k + 8));
          }
          if (tq == 0) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int s = s0 + g + 8 * half;
              if (s < S) att[o * S + s] = s <= lens[o] ? c[2 * half] : kNegInf;
            }
          }
        }
      } else if (kBf) {  // 8 lanes a source position, 8 consecutive units a lane at a time
        const int sub = lane & 7;
        const unsigned gmask = 0xffu << (lane & 24);
        for (int e = tid >> 3; e < own * S; e += kDecThreads / 8) {
          const int o = e / S, s = e % S;
          if (!live(o)) continue;
          float part = score_part(reinterpret_cast<const bf16*>(enc_global(o)) + static_cast<ll>(s) * H,
                                  reinterpret_cast<const bf16*>(hb) + (rank + n * o) * hs, H, sub);
          for (int off = 4; off > 0; off >>= 1) part += __shfl_xor_sync(gmask, part, off);
          if (sub == 0) att[o * S + s] = s <= lens[o] ? part : kNegInf;
        }
      } else {  // a warp a source position, in the fixed order; 8 at a time
        constexpr int kAt = 8;
        for (int e0 = kAt * warp; e0 < own * S; e0 += kAt * kDecWarps) {
          const T* ep[kAt];
          const T* hp[kAt];
          bool ok[kAt];
#pragma unroll
          for (int j = 0; j < kAt; ++j) {
            const int e = min(e0 + j, own * S - 1), o = e / S;
            ok[j] = e0 + j < own * S && live(o);
            ep[j] = !ok[j] ? hb  // a dead slot reads h
                    : a.enc_res ? enc_s + (o * sp + e % S) * es
                                : enc_global(o) + static_cast<ll>(e % S) * H;
            hp[j] = hb + (ok[j] ? rank + n * o : 0) * hs;
          }
          float part[kAt] = {};
          for (int k = lane; k < H; k += 32)
#pragma unroll
            for (int j = 0; j < kAt; ++j) part[j] = fmaf(to_f(ep[j][k]), to_f(hp[j][k]), part[j]);
#pragma unroll
          for (int j = 0; j < kAt; ++j) {
            part[j] = warp_sum(part[j]);
            const int e = e0 + j;
            if (lane == 0 && ok[j]) att[e] = e % S <= lens[e / S] ? part[j] : kNegInf;
          }
        }
      }
    }
    __syncthreads();
    // 2. Warp o: step t-1's log-softmax, Gumbel-max draw, trim and loss
    // terms of owned row o; warp own + o: the masked softmax of its scores.
    if (warp < own && t > 0 && live(warp)) {
      const int o = warp, r = rank + n * o, b = row0 + r, st = t - 1;
      const float* lg = logit + o * V;
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
        const bool blocked = v == a.pad || v == a.unk || v == a.start;
        const float comb = (blocked ? kNegInf : lg[v]) + gum[o * V + v];
        if (comb > best) {
          best = comb;
          best_v = v;
        }
      }
      warp_argmax(best, best_v);
      if (lane == 0) {
        float* rf = rowf + 4 * o;
        const float chosen = lg[best_v] - lse;
        const bool is_end = best_v == a.end;
        if (st == 0 && is_end) rf[1] = 1.f;  // a row whose FIRST token is @end@ is zeroed
        const bool keep = rf[0] > 0.f && rf[1] == 0.f;
        if (is_end) rf[0] = 0.f;
        a.preds[static_cast<ll>(b) * a.T + st] = keep ? best_v : 0;
        a.logprobs[static_cast<ll>(b) * a.T + st] = chosen;
        if (keep) {
          rf[2] += chosen;
          rf[3] += 1.f;
        }
        toks[r] = best_v;
      }
    } else if (warp >= own && warp < 2 * own && t < a.T && live(warp - own)) {
      float* sc = att + (warp - own) * S;
      float mx = -INFINITY;
      for (int s = lane; s < S; s += 32) mx = fmaxf(mx, sc[s]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int s = lane; s < S; s += 32) sum += expf(sc[s] - mx);
      sum = warp_sum(sum);
      for (int s = lane; s < S; s += 32) sc[s] = rnd<T>(expf(sc[s] - mx) / sum);
    }
    __syncthreads();
    if (t == a.T) break;

    // 3. The owned rows' cell inputs: the context rounded to T, and the
    // embedding of the previous token (float32) or the token itself (bf16,
    // for the table), first into this CTA's buffers, then copied into the
    // other CTAs of the cluster in 16-byte pieces.
    auto context_simt = [&]() {  // four units a thread, each summed over s in order
      for (int e = tid; e < own * (H / 4); e += kDecThreads) {
        const int o = e / (H / 4), k = 4 * (e % (H / 4));
        if (!live(o)) continue;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        if (a.enc_res)
          context_quad(att + o * S, enc_s + o * sp * es + k, S, es, c);
        else
          context_quad(att + o * S, enc_global(o) + k, S, H, c);
        T* dst = xb + (rank + n * o) * xs + k;
        store2(dst, c[0], c[1]);
        store2(dst + 2, c[2], c[3]);
      }
    };
    if constexpr (kBf) {
      if (a.enc_res) {
        // att (one row of a 16-row m-tile) . E (sp x H), a warp 4 n-tiles of
        // 8 units, for each owned row.
        for (int e = warp; e < own * (H / 32); e += kDecWarps) {
          const int o = e / (H / 32), n0 = e % (H / 32) * 4;
          if (!live(o)) continue;
          const float* w = att + o * S;
          float c[4][4] = {};
          for (int s = 0; s < sp; s += 16) {
            uint32_t af[4] = {0u, 0u, 0u, 0u};
            if (g == 0) {
              auto wv = [&](int i) { return from_f<bf16>(s + i < S ? w[s + i] : 0.f); };
              af[0] = pack_bf16(wv(2 * tq), wv(2 * tq + 1));
              af[2] = pack_bf16(wv(2 * tq + 8), wv(2 * tq + 9));
            }
            const bf16* rows = reinterpret_cast<const bf16*>(enc_s) + (o * sp + s + (lane & 15)) * es;
#pragma unroll
            for (int j = 0; j < 4; j += 2) {
              uint32_t b[4];  // n-tiles n0 + j and n0 + j + 1, rows s .. s + 15
              ldsm_x4_trans(b, smem_addr(rows + (n0 + j + (lane >> 4)) * 8));
              mma_bf16(c[j], af, b[0], b[1]);
              mma_bf16(c[j + 1], af, b[2], b[3]);
            }
          }
          if (g == 0) {
            T* dst = xb + (rank + n * o) * xs + n0 * 8 + 2 * tq;
#pragma unroll
            for (int j = 0; j < 4; ++j) store2(dst + 8 * j, c[j][0], c[j][1]);
          }
        }
      } else {
        context_simt();
      }
    } else {
      context_simt();
    }
    if constexpr (!kBf) {
      for (int e = tid; e < own * D; e += kDecThreads) {
        const int o = e / D, k = e % D, r = rank + n * o;
        if (live(o)) xb[r * xs + H + k] = tgt_emb[static_cast<ll>(toks[r]) * D + k];
      }
    }
    __syncthreads();
    const int xpieces = kBf ? H / 8 : (H + D + 3) / 4;  // 16-byte pieces of a row's cell input
    for (int e = tid; e < own * xpieces; e += kDecThreads) {
      if (live(e / xpieces))
        copy_to_peers(cluster, reinterpret_cast<uint4*>(xb + (rank + n * (e / xpieces)) * xs) +
                                   e % xpieces, rank, n);
    }
    if constexpr (kBf) {
      if (tid < own && live(tid)) {
        const int r = rank + n * tid;
        push_to_cluster(cluster, toks + r, toks[r], n);
      }
    }
    cluster_arrive();
    cluster_wait();

    // 4. The gates of the CTA's units for every row of the cluster, the
    // cell, and h_t rounded to T, first into this CTA's buffer, then copied
    // into the other CTAs in 16-byte pieces.
    if constexpr (kBf) {
      gate_mma<MT, NT>(acc16, reinterpret_cast<const bf16*>(xb), xs, R,
                       reinterpret_cast<const bf16*>(a.wx_res ? wx_s : w_ih), ws, a.wx_res, H, j0,
                       warp * NT, H, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // This lane holds gate tq of units (2 p, 2 p + 1) for rows r0 and
          // r0 + 8; after the exchange in its quad, all four gates of unit
          // 2 p + (tq & 1) for row r0 + 8 (tq >> 1).
          const int p = warp * NT + nt, r0 = mt * 16 + g, c = 8 * p + 2 * tq;
          const float* ta = table + toks[min(r0, R - 1)] * 4 * U + c;
          const float* tb = table + toks[min(r0 + 8, R - 1)] * 4 * U + c;
          const float v[4] = {acc16[mt][nt][0] + ta[0], acc16[mt][nt][1] + ta[1],
                              acc16[mt][nt][2] + tb[0], acc16[mt][nt][3] + tb[1]};
          float q4[4] = {};
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const int q = tq ^ d;
            const float send = pick4(v, q);
            const float got = d == 0 ? send : __shfl_xor_sync(0xffffffffu, send, d);
            q4[0] = q == 0 ? got : q4[0];
            q4[1] = q == 1 ? got : q4[1];
            q4[2] = q == 2 ? got : q4[2];
            q4[3] = q == 3 ? got : q4[3];
          }
          const float c_new = k1_cell(sigmoid(q4[0]), sigmoid(q4[1]), tanhf(q4[2]), c16[mt][nt]);
          c16[mt][nt] = c_new;
          const uint32_t mine = __bfloat16_as_ushort(__float2bfloat16(sigmoid(q4[3]) * tanhf(c_new)));
          const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
          const int row = r0 + 8 * (tq >> 1);
          if ((tq & 1) == 0 && row < R && row0 + row < B)
            *reinterpret_cast<uint32_t*>(hb + row * hs + j0 + 2 * p) = mine | other << 16;
        }
      }
    } else {
      // acc = bias, then x . W_ih over k, then h_{t-1} . W_hh over k: the
      // fixed order that keeps float32's bits. A thread sums one unit of its
      // rows; a matrix not resident streams through the ring.
      const int j = j0 + unit;
      float acc[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = a.bias[q * H + j];
      if (a.wx_res)
        gate_dot1<RPT>(acc, xb, xs, r32, wx_s + unit, 4 * U, U, H + D);
      else
        stream(acc, xb, xs, w_ih, H + D);
      if (a.wh_res)
        gate_dot1<RPT>(acc, hb, hs, r32, wh_s + unit, 4 * U, U, H);
      else
        stream(acc, hb, hs, w_hh, H);
      float h1[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float c_new =
            k1_cell(sigmoid(acc[i][0]), sigmoid(acc[i][1]), tanhf(acc[i][2]), c32[i]);
        c32[i] = c_new;
        h1[i] = sigmoid(acc[i][3]) * tanhf(c_new);
      }
      // Every CTA has read h_{t-1} before any overwrites it.
      cluster_arrive();
      cluster_wait();
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (live32[i]) hb[r32[i] * hs + j] = h1[i];
    }
    __syncthreads();
    const int hpieces = U * static_cast<int>(sizeof(T)) / 16;  // 16-byte pieces of a row's units
    for (int e = tid; e < min(R, B - row0) * hpieces; e += kDecThreads)
      copy_to_peers(cluster, reinterpret_cast<uint4*>(hb + e / hpieces * hs + j0) + e % hpieces,
                    rank, n);
    cluster_arrive();
    cluster_wait();
  }
  if (tid < own && live(tid))
    a.loss[row0 + rank + n * tid] = -(rowf[4 * tid + 2] / (rowf[4 * tid + 3] + 1e-12f));
}

typedef void (*DecoderKernel)(const DecoderArgs);

// Rows a cluster at most: three m-tiles (bf16), three rows a thread
// (float32), four rows a CTA.
int decoder_cap(bool bf, int n, int U) {
  const int cap = bf ? kDecMaxRows : 3 * (kDecThreads / U);
  return cap < kDecMaxOwn * n ? cap : kDecMaxOwn * n;
}

// The instance for R rows a cluster and U units a CTA: bf16 ceil(R / 16)
// m-tiles and U / 16 n-tiles a warp; float32 ceil(R / G) rows a thread,
// G = kDecThreads / U row groups.
int decoder_tiles(bool bf, int R, int U) {
  return bf ? sweep_ceil(R, 16) : sweep_ceil(R, kDecThreads / U);
}

template <typename T>
DecoderKernel decoder_kernel(int R, int U) {
  const int tiles = decoder_tiles(sizeof(T) == 2, R, U);
  if constexpr (sizeof(T) == 2) {
    if (U == 16)
      return tiles == 1 ? seq2seq_sample_kernel<T, 1, 1, 1>
             : tiles == 2 ? seq2seq_sample_kernel<T, 2, 1, 1>
                          : seq2seq_sample_kernel<T, 3, 1, 1>;
    return tiles == 1 ? seq2seq_sample_kernel<T, 1, 2, 1>
           : tiles == 2 ? seq2seq_sample_kernel<T, 2, 2, 1>
                        : seq2seq_sample_kernel<T, 3, 2, 1>;
  } else {
    return tiles == 1 ? seq2seq_sample_kernel<T, 1, 1, 1>
           : tiles == 2 ? seq2seq_sample_kernel<T, 1, 1, 2>
                        : seq2seq_sample_kernel<T, 1, 1, 3>;
  }
}

struct DecoderPlan {
  SweepPlan p;
  int fit_full;               // clusters the card runs at once at the full shared memory
  bool wh, wx, enc, proj;     // resident in shared memory
};

// The decoder's plan for B rows of S source positions: n = H / U CTAs a
// cluster; the rows the clusters would take at the full shared memory
// decide what stays resident, W_hh first, then W_ih, the owned rows'
// encoder outputs and the projection, each only if it still fits; then R
// is the fewest rows that let every cluster run at once (plan_for).
template <typename T>
cudaError_t decoder_plan(int B, int S, int D, int H, int V, cudaStream_t s, DecoderPlan* plan) {
  if (H % 32 != 0 || H < 128 || H > 512 || D < 1 || V < 1 || S < 1 || B < 1)
    return cudaErrorInvalidValue;
  const bool bf = sizeof(T) == 2;
  const int U = dec_units(H), n = H / U, cap = decoder_cap(bf, n, U);
  const DecoderKernel widest = decoder_kernel<T>(cap, U);
  SWEEP_TRY(sweep_attributes(widest, kSweepMaxSmem, n));
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  sweep_config(n, kDecThreads, kSweepMaxSmem, 1, s, &cfg, &attr);
  int fit_full = 0;
  SWEEP_TRY(cudaOccupancyMaxActiveClusters(&fit_full, widest, &cfg));
  if (fit_full < 1) return cudaErrorInvalidValue;
  const int rt = sweep_ceil(B, fit_full) < cap ? sweep_ceil(B, fit_full) : cap;
  auto bytes = [=](int R, bool wh, bool wx, bool enc, bool proj) {
    return dec_smem(bf, D, H, V, S, U, n, R, wh, wx, enc, proj).total;
  };
  const bool wh = bytes(rt, true, false, false, false) <= kSweepMaxSmem;
  const bool wx = bytes(rt, wh, true, false, false) <= kSweepMaxSmem;
  const bool enc = bytes(rt, wh, wx, true, false) <= kSweepMaxSmem;
  const bool proj = bytes(rt, wh, wx, enc, true) <= kSweepMaxSmem;
  plan->fit_full = fit_full;
  plan->wh = wh;
  plan->wx = wx;
  plan->enc = enc;
  plan->proj = proj;
  return plan_for(
      widest, [=](int R) { return bytes(R, wh, wx, enc, proj); },
      [](int) { return kDecThreads; }, cap, n, U, B, s, &plan->p);
}

template <typename T>
cudaError_t launch_decoder(DecoderArgs a, cudaStream_t s) {
  DecoderPlan dp;
  SWEEP_TRY(decoder_plan<T>(a.batch, a.raw_len + 1, a.D, a.H, a.V, s, &dp));
  a.units = dp.p.units;
  a.rows = dp.p.rows;
  a.wh_res = dp.wh;
  a.wx_res = dp.wx;
  a.enc_res = dp.enc;
  a.proj_res = dp.proj;
  const DecoderKernel kernel = decoder_kernel<T>(dp.p.rows, dp.p.units);
  SWEEP_TRY(sweep_attributes(kernel, dp.p.smem, dp.p.cluster));
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  sweep_config(dp.p.cluster, dp.p.threads, dp.p.smem, dp.p.clusters, s, &cfg, &attr);
  SWEEP_TRY(cudaLaunchKernelEx(&cfg, kernel, a));
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
// layers below the top (null for one layer). dropout_keep: null, or the
// inter-layer dropout's keep mask (L-1, B, raw_len + 1, H) bytes with its
// scale 1 / (1 - p): each layer below the top has its outputs dropped
// (k1_dropout) before the layer above reads them. Launches on `stream`.
extern "C" int probnmn_k1_encode(int dtype, const void* src, int batch, int raw_len,
                                 const void* src_emb, const void* enc_wih, const void* enc_whh,
                                 const void* enc_bias, void* enc_out, void* enc_tmp,
                                 void* h_final, const void* dropout_keep, float dropout_scale,
                                 int input_size, int hidden, int num_layers, int pad, int end,
                                 void* stream) {
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
  const ll layer_n = static_cast<ll>(batch) * (raw_len + 1) * hidden;
  for (int l = 0; l < num_layers; ++l) {
    void* mine = (num_layers - 1 - l) % 2 == 0 ? enc_out : enc_tmp;  // the top layer's is enc_out
    if (l > 0 && dropout_keep != nullptr) {
      const unsigned char* keep = static_cast<const unsigned char*>(dropout_keep) + (l - 1) * layer_n;
      const int blocks = static_cast<int>((layer_n + 255) / 256);
      if (dtype == 1)
        k1_dropout<bf16><<<blocks, 256, 0, s>>>(static_cast<bf16*>(a.out), keep, layer_n,
                                                dropout_scale);
      else
        k1_dropout<float><<<blocks, 256, 0, s>>>(static_cast<float*>(a.out), keep, layer_n,
                                                 dropout_scale);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
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
// dtype and its final hidden state h0 (B, H) float32: one launch of
// seq2seq_sample_kernel. Launches on `stream`; returns cudaGetLastError().
extern "C" int probnmn_k1_decode(
    int dtype, const void* src, int batch, int raw_len, const void* noise, int noise_stride,
    unsigned long long seed, int row_base, const void* tgt_emb, const void* dec_wih,
    const void* dec_whh, const void* dec_bias, const void* proj_w, const void* proj_b,
    const void* enc_out, const void* h0, void* preds, void* loss, void* logprobs,
    int input_size, int hidden, int vocab, int num_steps, int pad, int unk, int start, int end,
    void* stream) {
  if (batch <= 0) return 0;
  DecoderArgs a{};
  a.src = static_cast<const int*>(src);
  a.batch = batch;
  a.raw_len = raw_len;
  a.noise = static_cast<const float*>(noise);
  a.noise_stride = noise_stride;
  a.seed = seed;
  a.row_base = row_base;
  a.tgt_emb = tgt_emb;
  a.w_ih = dec_wih;
  a.w_hh = dec_whh;
  a.bias = static_cast<const float*>(dec_bias);
  a.proj = proj_w;
  a.proj_b = static_cast<const float*>(proj_b);
  a.enc = enc_out;
  a.h0 = static_cast<const float*>(h0);
  a.preds = static_cast<int*>(preds);
  a.loss = static_cast<float*>(loss);
  a.logprobs = static_cast<float*>(logprobs);
  a.D = input_size;
  a.H = hidden;
  a.V = vocab;
  a.T = num_steps;
  a.pad = pad;
  a.unk = unk;
  a.start = start;
  a.end = end;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? launch_decoder<bf16>(a, s) : launch_decoder<float>(a, s);
  return static_cast<int>(err);
}

// The decoder's plan: out = {the cluster size, units a CTA, rows a cluster,
// threads a CTA, clusters, clusters the card runs at once, shared memory
// bytes a CTA, W_hh resident, W_ih resident, the encoder outputs resident,
// the projection resident, rows a CTA owns, clusters the card runs at once at
// the full shared memory, tiles (bf16: 16-row m-tiles; float32: rows a
// thread), registers a thread}.
extern "C" int probnmn_k1_decoder_plan(int dtype, int batch, int raw_len, int input_size,
                                       int hidden, int vocab, int* out) {
  DecoderPlan dp;
  const int S = raw_len + 1;
  cudaError_t err =
      dtype == 1 ? decoder_plan<bf16>(batch, S, input_size, hidden, vocab, nullptr, &dp)
                 : decoder_plan<float>(batch, S, input_size, hidden, vocab, nullptr, &dp);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, dtype == 1 ? decoder_kernel<bf16>(dp.p.rows, dp.p.units)
                                                  : decoder_kernel<float>(dp.p.rows, dp.p.units));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[] = {dp.p.cluster, dp.p.units, dp.p.rows, dp.p.threads, dp.p.clusters, dp.p.fit,
                   static_cast<int>(dp.p.smem), dp.wh, dp.wx, dp.enc, dp.proj,
                   sweep_ceil(dp.p.rows, dp.p.cluster), dp.fit_full,
                   decoder_tiles(dtype == 1, dp.p.rows, dp.p.units), attr.numRegs};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
  return 0;
}
