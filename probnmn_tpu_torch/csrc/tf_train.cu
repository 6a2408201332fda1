// Kernels K4f and K4b: the teacher-forced attentive seq2seq loss (masked
// multi-layer LSTM encoder, decoder initialised from the top layer's final
// hidden state with a zero cell, dot-product attention of the previous
// decoder hidden state over the encoder outputs, an LSTM cell over
// [attended, embedded], the output projection and a per-example masked
// cross entropy) and its backward, in float32 on the SIMT cores.
//
// Replaces probnmn_tpu/ops/pallas/seq2seq_train.py::_tf_forward_kernel (K4f)
// and ::_tf_backward_kernel (K4b), the two halves of the custom VJP
// `fused_tf_loss`. Two modes, as there: cross entropy (labels are the target
// with @end@ appended, T = Lt + 1 steps, eps 1e-13) and REINFORCE (labels are
// a trimmed sampled z as it is, T = Lt steps, eps 1e-12: the
// length-normalized -log q(z|x)). The source always gets @end@ appended
// (S = Ls + 1) and attention sees the positions that are not pad.
//
// The work is ordered by what depends on what, as K3's (lm_train.cu), and
// built from the same pieces (train_common.cuh):
//
// - Forward. The encoder is K3's masked layer forward (one GEMM for
//   x . W_ih^T over all S*B rows, then the layer's whole recurrence in one
//   cluster-resident launch of lstm_fwd_sweep, lstm_sweep.cuh; one step
//   launch a step above H = 256). The decoder's token
//   inputs are known, so emb(dec_in) . W_ih[:, H:]^T + bias is one GEMM over
//   T*B rows. Each decoder step is two launches: the attention (one block
//   per example: scores of the previous h over the source, masked softmax,
//   the attended vector, written beside h_prev as [attended, h_prev]) and
//   the step kernel, whose recurrent product runs over that 2H-wide row
//   against [W_ih[:, :H], W_hh] with the cell in its epilogue. The head
//   (logits, log-sum-exp, CE) runs over all T*B rows at once.
// - Backward. The JAX kernel replays the forward first, since a TPU's VMEM
//   holds residuals for one grid step only; K4b does not: a K4f run with
//   keep writes the residual layout (every encoder layer's h, c, y and
//   gates, every decoder step's h, c, gates, attention weights and
//   [attended, h_prev] row, the logits and the token streams: ~110-125 MB
//   a pass of a question_coding step) and K4b starts from it, consuming it
//   in place (dpre over the gates, dlogits over the logits). dlogits for
//   every row, and the head's dh for every step (one GEMM), do not depend
//   on the recurrence. The decoder is swept back in three parts a step: the
//   cell backward (dpre over the gates), dpre . [W_ih[:, :H], W_hh] (one
//   GEMM, its 4H-deep sum split so that the grid covers the card, then its
//   fixed-order reduction), and the attention backward (one block per
//   example, so its rows of the encoder outputs' gradient need no atomics),
//   which hands the gradient reaching h_prev to the step before. What
//   reaches the initial decoder h enters the top encoder layer's carry
//   after its last step; then each encoder layer is swept back in one
//   cluster-resident launch (lstm_sweep.cuh) and its weight gradients
//   follow, as in K3b.
// - Every weight gradient is a contraction over rows, split-K with its
//   partials added in a fixed order; the bias gradients are column sums and
//   both embeddings' gradients are reduced per token id: no float atomics,
//   so K4b gives the same bits on every run.
// - Inter-layer dropout of the encoder (DROPOUT > 0, a training pass): K4f
//   drops each encoder layer's y below the top in place (dropout_rows,
//   train_common.cuh) before the layer above reads it, so the residuals hold
//   the dropped input that layer's W_ih gradient needs; K4b takes the same
//   mask and scales the gradient reaching that y alike. One elementwise
//   launch a layer each way; without a mask nothing more runs.
//
// What bounds it on an H100: a pass of a question_coding step has about 128
// rows (half a batch of 256). At CLEVR lengths the ProgramGenerator pass
// (S = 46, T = 27 or 26, V = 44) and the QuestionReconstructor pass (S = 27,
// T = 46, V = 92) each need 7-12 GFLOP forward over their valid row-steps,
// most of it the encoder, and twice that backward: 0.1-0.2 ms and 0.2-0.4
// ms at the 67 TFLOP/s float32 SIMT peak. Reading the residuals takes
// about 0.04 ms at 3.35 TB/s, so both are bound by operations, and in
// this version by their serial steps (L sweeps and 2*T launches forward;
// L sweeps and 4*T launches backward), each too small to fill the card.
// Later work: the decoder's forward and reverse sweeps persistent too, with
// the attention inside the cluster; the tensor cores; and skipping
// row-steps past each row's end.
//
// Every entry point launches on the caller's stream and allocates nothing:
// the caller passes K4f's workspace (probnmn_tf_workspace_floats() floats)
// and K4b's scratch (probnmn_tf_scratch_floats()). Each returns
// cudaGetLastError() or the launch's own error.

#include "lstm_sweep.cuh"

namespace probnmn {
namespace {

constexpr float kCeEps = 1e-13f;         // allennlp's sequence cross entropy
constexpr float kReinforceEps = 1e-12f;  // the length-normalized logprob loss
constexpr int kAttnThreads = 256;
constexpr int kMaxSource = 4096;  // source positions (S floats of shared memory)

// ------------------------------------------------------------------ attention
// Decoder step t's attention, one block per example b: scores of the previous
// hidden state h_prev[b] over the source positions with m = 1, their softmax
// w, the attended vector. Writes w_out[s * B + b] (0 where m = 0) and
// cat[b] = [attended, h_prev[b]] (B, 2H).
__global__ void __launch_bounds__(kAttnThreads)
tf_attend(const float* __restrict__ enc, const float* __restrict__ src_m,
          const float* __restrict__ h_prev, float* w_out, float* cat, int S, int B, int H) {
  extern __shared__ float sc[];  // S scores, then weights
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const float* hp = h_prev + static_cast<ll>(b) * H;
  for (int s = warp; s < S; s += warps) {
    const bool real = src_m[static_cast<ll>(s) * B + b] != 0.f;
    float acc = 0.f;
    if (real) {
      const float* e = enc + (static_cast<ll>(s) * B + b) * H;
      for (int k = lane; k < H; k += 32) acc = fmaf(e[k], hp[k], acc);
      acc = warp_sum(acc);
    }
    if (lane == 0) sc[s] = real ? acc : -INFINITY;
  }
  __syncthreads();
  if (warp == 0) {
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, sc[s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float e = sc[s] == -INFINITY ? 0.f : expf(sc[s] - mx);
      sc[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < S; s += 32) {
      sc[s] /= sum;
      w_out[static_cast<ll>(s) * B + b] = sc[s];
    }
  }
  __syncthreads();
  float* row = cat + static_cast<ll>(b) * 2 * H;
  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      if (sc[s] != 0.f) acc = fmaf(sc[s], enc[(static_cast<ll>(s) * B + b) * H + k], acc);
    row[k] = acc;
    row[H + k] = hp[k];
  }
}

// Its backward, one block per example b. dcat[b] (B, 2H) is the gradient
// reaching [attended, h_prev]: datt = dcat[b, :H]. With dw_s = enc_s . datt
// and ds_s = w_s (dw_s - sum_s' w_s' dw_s'), writes the gradient reaching
// h_prev, dh_out[b] = sum_s ds_s enc_s + dcat[b, H:] (+ dh_add[b], the
// head's gradient of the step before, when given), and adds
// ds_s h_prev + w_s datt to the encoder outputs' gradient denc[s, b]; the
// block owns example b's rows, so no atomics.
__global__ void __launch_bounds__(kAttnThreads)
tf_attend_bwd(const float* __restrict__ enc, const float* __restrict__ src_m,
              const float* __restrict__ w, const float* __restrict__ h_prev,
              const float* __restrict__ dcat, const float* __restrict__ dh_add, float* dh_out,
              float* denc, int S, int B, int H) {
  extern __shared__ float sh[];  // S values of w dw, then ds
  __shared__ float total;
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const float* datt = dcat + static_cast<ll>(b) * 2 * H;
  const float* hp = h_prev + static_cast<ll>(b) * H;
  for (int s = warp; s < S; s += warps) {
    const bool real = src_m[static_cast<ll>(s) * B + b] != 0.f;
    float acc = 0.f;
    if (real) {
      const float* e = enc + (static_cast<ll>(s) * B + b) * H;
      for (int k = lane; k < H; k += 32) acc = fmaf(e[k], datt[k], acc);
      acc = warp_sum(acc);
    }
    if (lane == 0) sh[s] = real ? w[static_cast<ll>(s) * B + b] * acc : 0.f;
  }
  __syncthreads();
  if (warp == 0) {
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) sum += sh[s];
    sum = warp_sum(sum);
    if (lane == 0) total = sum;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    sh[s] -= w[static_cast<ll>(s) * B + b] * total;
  __syncthreads();
  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    float acc = 0.f;
    const float hk = hp[k], ak = datt[k];
    for (int s = 0; s < S; ++s) {
      if (src_m[static_cast<ll>(s) * B + b] == 0.f) continue;
      const ll idx = (static_cast<ll>(s) * B + b) * H + k;
      acc = fmaf(sh[s], enc[idx], acc);
      denc[idx] += sh[s] * hk + w[static_cast<ll>(s) * B + b] * ak;
    }
    const ll o = static_cast<ll>(b) * H + k;
    dh_out[o] = acc + datt[H + k] + (dh_add != nullptr ? dh_add[o] : 0.f);
  }
}

// ------------------------------------------------------------------ host side
struct Dims {
  int B, Ls, S, Lt, T, D, H, L, Vs, Vt;
  bool reinforce;
  ll G;  // 4H
  ll SB, TB;
};

struct Weights {
  const int *src, *tgt;
  const float *src_emb, *tgt_emb;
  const float *enc_wih, *enc_whh, *enc_bias;  // layers' (4H, D_l) flat; (L, 4H, H); (L, 4H)
  const float *dec_w, *dec_wx, *dec_bias;     // (4H, 2H) = [W_ih[:, :H], W_hh]; W_ih[:, H:]; (4H)
  const float *proj_w, *proj_b;               // (Vt, H); (Vt)
  int pad, start, end;
  ll wih_offset(const Dims& d, int l) const {
    return l == 0 ? 0 : d.G * d.D + (l - 1) * d.G * d.H;
  }
};

// K4f's arrays. In the lean layout (the loss alone) one encoder layer's
// arrays and one step's [attended, h_prev] serve every layer and step; in
// the residual layout (keep) every layer and step has its own, and they are
// what K4b starts from.
struct Workspace {
  int *src_id, *dec_in, *label;
  float *src_m, *x0, *gates, *h, *c, *y;  // encoder, per layer
  float *ex, *dgates, *hdec, *cdec, *cat, *attn_w, *logits, *ce;
  ll layer_gates, layer_h;  // strides between encoder layers; 0 when they share one buffer
  ll cat_step;              // stride between the steps' [attended, h_prev] rows; 0 when lean
};

// K4b's own scratch, allocated for the backward alone.
struct Scratch {
  float *dnum, *dh_head, *dcat, *ext, *dzero, *dc, *denc, *e0, *e1, *partial;
};

ll partial_floats(const Dims& d) {
  const ll rows = d.SB > d.TB ? d.SB : d.TB;
  const ll dmax = d.D > d.H ? d.D : d.H;
  const ll vmax = d.Vs > d.Vt ? d.Vs : d.Vt;
  ll n = layer_partial_floats(d.SB, d.H, dmax);
  const ll more[] = {splitk_floats(d.G, d.B, 2 * d.H), splitk_floats(d.TB, d.G, 2 * d.H),
                     splitk_floats(d.TB, d.G, d.D),
                     splitk_floats(d.TB, d.Vt, d.H), chunk_count(d.TB) * d.G,
                     chunk_count(d.TB) * d.Vt, chunk_count(rows) * vmax * d.D};
  for (ll m : more) n = n > m ? n : m;
  return n;
}

// Hands out 16-byte aligned arrays from `base` (null: only counts floats;
// ints take a float's 4 bytes).
struct Carver {
  float* base;
  ll off = 0;
  float* take(ll n) {
    float* p = base != nullptr ? base + off : nullptr;
    off += (n + 3) / 4 * 4;
    return p;
  }
};

// Carves K4f's workspace, lean or residual (keep); returns its size in floats.
ll layout(const Dims& d, bool keep, float* base, Workspace* w) {
  const ll SB = d.SB, TB = d.TB, bh = static_cast<ll>(d.B) * d.H;
  const ll layers = keep ? d.L : 1;
  Carver cv{base};
  Workspace ws{};
  ws.src_id = reinterpret_cast<int*>(cv.take(SB));
  ws.dec_in = reinterpret_cast<int*>(cv.take(TB));
  ws.label = reinterpret_cast<int*>(cv.take(TB));
  ws.src_m = cv.take(SB);
  ws.x0 = cv.take(SB * d.D);
  ws.layer_gates = keep ? SB * d.G : 0;
  ws.layer_h = keep ? SB * d.H : 0;
  ws.gates = cv.take(layers * SB * d.G);
  ws.h = cv.take(layers * SB * d.H);
  ws.c = cv.take(layers * SB * d.H);
  ws.y = cv.take(layers * SB * d.H);
  ws.ex = cv.take(TB * d.D);
  ws.dgates = cv.take(TB * d.G);
  ws.hdec = cv.take(TB * d.H + bh);
  ws.cdec = cv.take(TB * d.H);
  ws.cat_step = keep ? 2 * bh : 0;
  ws.cat = cv.take(keep ? 2 * TB * d.H : 2 * bh);
  ws.attn_w = cv.take(static_cast<ll>(d.T) * SB);
  ws.logits = cv.take(TB * d.Vt);
  ws.ce = cv.take(TB);
  if (w != nullptr) *w = ws;
  return cv.off;
}

// Carves K4b's scratch; returns its size in floats.
ll scratch_layout(const Dims& d, float* base, Scratch* w) {
  const ll bh = static_cast<ll>(d.B) * d.H;
  const ll rows = d.SB > d.TB ? d.SB : d.TB;
  const ll wide = rows * (d.D > d.H ? d.D : d.H);
  Carver cv{base};
  Scratch sc{};
  sc.dnum = cv.take(d.B);
  sc.dh_head = cv.take(d.TB * d.H);
  sc.dcat = cv.take(2 * bh);
  sc.ext = cv.take(bh);
  sc.dzero = cv.take(bh);
  sc.dc = cv.take(bh);
  sc.denc = cv.take(d.SB * d.H);
  sc.e0 = cv.take(wide);
  sc.e1 = cv.take(wide);
  sc.partial = cv.take(partial_floats(d));
  if (w != nullptr) *w = sc;
  return cv.off;
}

LayerArgs encoder_layer(const Dims& d, const Weights& wt, const Workspace& ws, int l) {
  LayerArgs a;
  a.T = d.S;
  a.B = d.B;
  a.H = d.H;
  a.din = l == 0 ? d.D : d.H;
  a.x = l == 0 ? ws.x0 : ws.y + (l - 1) * ws.layer_h;
  a.w_ih = wt.enc_wih + wt.wih_offset(d, l);
  a.w_hh = wt.enc_whh + l * d.G * d.H;
  a.bias = wt.enc_bias + l * d.G;
  a.m = ws.src_m;
  a.gates = ws.gates + l * ws.layer_gates;
  a.h = ws.h + l * ws.layer_h;
  a.c = ws.c + l * ws.layer_h;
  a.y = ws.y + l * ws.layer_h;
  return a;
}

// The forward through the logits, into the workspace. With dropout, encoder
// layer l - 1's y is dropped in place before layer l reads it (the top
// layer's, the attention memory, is not): the residuals then hold the
// dropped input that layer l's W_ih gradient needs.
cudaError_t forward_pass(const Dims& d, const Weights& wt, const Workspace& ws, const Dropout& dr,
                         cudaStream_t s) {
  const ll bh = static_cast<ll>(d.B) * d.H;
  token_streams<<<ceil_div(d.SB, 256), 256, 0, s>>>(wt.src, d.B, d.Ls, d.S, d.Vs, wt.pad,
                                                     wt.start, wt.end, true, nullptr, ws.src_id,
                                                     nullptr, ws.src_m);
  TRAIN_LAUNCHED();
  token_streams<<<ceil_div(d.TB, 256), 256, 0, s>>>(wt.tgt, d.B, d.Lt, d.T, d.Vt, wt.pad,
                                                     wt.start, wt.end, !d.reinforce, ws.dec_in,
                                                     ws.label, nullptr, nullptr);
  TRAIN_LAUNCHED();
  embed_rows<<<ceil_div(d.SB * d.D, 256), 256, 0, s>>>(wt.src_emb, ws.src_id, ws.src_m, ws.x0,
                                                        static_cast<int>(d.SB), d.D);
  TRAIN_LAUNCHED();
  for (int l = 0; l < d.L; ++l) {
    if (l > 0 && dr.keep != nullptr)
      TRAIN_TRY(drop_layer(s, dr, l - 1, ws.y + (l - 1) * ws.layer_h, d.S, d.B, d.H));
    TRAIN_TRY(lstm_layer_forward(s, encoder_layer(d, wt, ws, l)));
  }
  // Decoder: h starts at the top layer's final (frozen) hidden state, c at 0.
  const float* enc = ws.y + (d.L - 1) * ws.layer_h;
  const float* h_top = ws.h + (d.L - 1) * ws.layer_h;
  TRAIN_TRY(cudaMemcpyAsync(ws.hdec, h_top + (d.S - 1) * bh, bh * sizeof(float),
                            cudaMemcpyDeviceToDevice, s));
  embed_rows<<<ceil_div(d.TB * d.D, 256), 256, 0, s>>>(wt.tgt_emb, ws.dec_in, nullptr, ws.ex,
                                                        static_cast<int>(d.TB), d.D);
  TRAIN_LAUNCHED();
  TRAIN_TRY(gemm(s, ws.ex, d.D, 1, wt.dec_wx, 1, d.D, ws.dgates, d.G, static_cast<int>(d.TB),
                 static_cast<int>(d.G), d.D, wt.dec_bias, false, nullptr));
  const dim3 step_grid(ceil_div(d.H, kFUnits), ceil_div(d.B, kFRows));
  const size_t attn_smem = static_cast<size_t>(d.S) * sizeof(float);
  for (int t = 0; t < d.T; ++t) {
    float* cat = ws.cat + t * ws.cat_step;
    tf_attend<<<d.B, kAttnThreads, attn_smem, s>>>(enc, ws.src_m, ws.hdec + t * bh,
                                                   ws.attn_w + t * d.SB, cat, d.S, d.B, d.H);
    TRAIN_LAUNCHED();
    lstm_fwd_step<<<step_grid, 256, 0, s>>>(cat, 2 * d.H, wt.dec_w, 2 * d.H, nullptr,
                                            t > 0 ? ws.cdec + (t - 1) * bh : nullptr,
                                            ws.dgates + t * d.B * d.G, nullptr,
                                            ws.hdec + (t + 1) * bh, ws.cdec + t * bh, nullptr,
                                            d.B, d.H);
    TRAIN_LAUNCHED();
  }
  // logits = h . proj_w^T + proj_b over all T*B rows.
  return gemm(s, ws.hdec + bh, d.H, 1, wt.proj_w, 1, d.H, ws.logits, d.Vt,
              static_cast<int>(d.TB), d.Vt, d.H, wt.proj_b, false, nullptr);
}

struct Grads {
  float *src_emb, *tgt_emb, *enc_wih, *enc_whh, *enc_bias;
  float *dec_w, *dec_wx, *dec_bias, *proj_w, *proj_b;
};

// K4b from K4f's residuals `ws`, which it consumes: dpre overwrites the
// gates and dlogits the logits. `dr` is the dropout mask K4f took.
cudaError_t backward_pass(const Dims& d, const Weights& wt, const Workspace& ws,
                          const Scratch& sc, const float* dloss, const Grads& gr,
                          const Dropout& dr, cudaStream_t s) {
  const ll bh = static_cast<ll>(d.B) * d.H;
  const int TB = static_cast<int>(d.TB), G = static_cast<int>(d.G), H2 = 2 * d.H;
  loss_rows<<<ceil_div(d.B, 128), 128, 0, s>>>(nullptr, ws.label, dloss, nullptr, sc.dnum, d.B,
                                               d.T, wt.pad,
                                               d.reinforce ? kReinforceEps : kCeEps);
  TRAIN_LAUNCHED();
  ce_head_bwd<<<ceil_div(d.TB * 32, 256), 256, 0, s>>>(ws.logits, ws.label, sc.dnum, TB, d.B,
                                                       d.Vt, wt.pad);
  TRAIN_LAUNCHED();
  const float* dlogits = ws.logits;
  const float* h_out = ws.hdec + bh;
  // The head: dh for every step, d proj_w = dlogits^T . h, d proj_b.
  TRAIN_TRY(gemm(s, dlogits, d.Vt, 1, wt.proj_w, d.H, 1, sc.dh_head, d.H, TB, d.H, d.Vt, nullptr,
                 false, nullptr));
  TRAIN_TRY(gemm(s, dlogits, 1, d.Vt, h_out, d.H, 1, gr.proj_w, d.H, d.Vt, d.H, TB, nullptr,
                 false, sc.partial));
  TRAIN_TRY(column_sum(s, dlogits, TB, d.Vt, gr.proj_b, false, sc.partial));

  // Decoder reverse sweep. sc.ext carries the gradient reaching the step's
  // output h from later steps and the head; at the end it holds the gradient
  // reaching the initial h, the top encoder layer's final hidden state.
  const float* enc = ws.y + (d.L - 1) * ws.layer_h;
  TRAIN_TRY(cudaMemsetAsync(sc.dzero, 0, bh * sizeof(float), s));
  TRAIN_TRY(cudaMemsetAsync(sc.dc, 0, bh * sizeof(float), s));
  TRAIN_TRY(cudaMemsetAsync(sc.denc, 0, d.SB * d.H * sizeof(float), s));
  const dim3 bwd_grid(ceil_div(d.H, kBUnits), ceil_div(d.B, kBRows));
  const size_t attn_smem = static_cast<size_t>(d.S) * sizeof(float);
  for (int t = d.T - 1; t >= 0; --t) {
    float* dpre = ws.dgates + t * d.B * d.G;
    lstm_bwd_step<<<bwd_grid, 256, 0, s>>>(nullptr, nullptr, dpre, ws.cdec + t * bh,
                                           t > 0 ? ws.cdec + (t - 1) * bh : nullptr, nullptr,
                                           t == d.T - 1 ? sc.dh_head + t * bh : sc.ext, sc.dzero,
                                           sc.dc, d.B, d.H);
    TRAIN_LAUNCHED();
    TRAIN_TRY(gemm(s, dpre, d.G, 1, wt.dec_w, H2, 1, sc.dcat, H2, d.B, H2, G, nullptr, false,
                   sc.partial));
    tf_attend_bwd<<<d.B, kAttnThreads, attn_smem, s>>>(
        enc, ws.src_m, ws.attn_w + t * d.SB, ws.hdec + t * bh, sc.dcat,
        t > 0 ? sc.dh_head + (t - 1) * bh : nullptr, sc.ext, sc.denc, d.S, d.B, d.H);
    TRAIN_LAUNCHED();
  }
  // Decoder weights: dpre against [attended, h_prev] and against emb(dec_in).
  const float* dpre_all = ws.dgates;
  TRAIN_TRY(gemm(s, dpre_all, 1, d.G, ws.cat, H2, 1, gr.dec_w, H2, G, H2, TB, nullptr, false,
                 sc.partial));
  TRAIN_TRY(gemm(s, dpre_all, 1, d.G, ws.ex, d.D, 1, gr.dec_wx, d.D, G, d.D, TB, nullptr, false,
                 sc.partial));
  TRAIN_TRY(column_sum(s, dpre_all, TB, G, gr.dec_bias, false, sc.partial));
  // The target embedding: dpre . W_ih[:, H:] per row, reduced per dec_in id
  // (the target embedding has no pad row: every id counts).
  TRAIN_TRY(gemm(s, dpre_all, d.G, 1, wt.dec_wx, d.D, 1, sc.e0, d.D, TB, d.D, G, nullptr, false,
                 nullptr));
  TRAIN_TRY(embedding_grad(s, sc.e0, ws.dec_in, TB, d.D, d.Vt, -1, gr.tgt_emb, false,
                           sc.partial));

  // Encoder, top layer first, each layer's reverse sweep in one launch
  // (lstm_sweep.cuh): ext = the encoder outputs' gradient, and the initial
  // decoder h's gradient enters the carry after the last step.
  const float* ext = sc.denc;
  const float* dh_last = sc.ext;
  for (int l = d.L - 1; l >= 0; --l) {
    float* dx = (d.L - 1 - l) % 2 == 0 ? sc.e0 : sc.e1;
    const LayerArgs layer = encoder_layer(d, wt, ws, l);
    TRAIN_TRY(lstm_layer_sweep(s, layer, ext, dh_last));
    TRAIN_TRY(lstm_layer_grads(s, layer, gr.enc_wih + wt.wih_offset(d, l),
                               gr.enc_whh + l * d.G * d.H, gr.enc_bias + l * d.G, dx,
                               sc.partial));
    // dx reaches layer l - 1's y through the dropout between them.
    if (l > 0 && dr.keep != nullptr) TRAIN_TRY(drop_layer(s, dr, l - 1, dx, d.S, d.B, d.H));
    ext = dx;
    dh_last = nullptr;
  }
  // ext now holds dx0: the source embedding's gradient, per token id (pad skipped).
  return embedding_grad(s, ext, ws.src_id, static_cast<int>(d.SB), d.D, d.Vs, wt.pad,
                        gr.src_emb, false, sc.partial);
}

Dims make_dims(int B, int Ls, int Lt, int D, int H, int L, int Vs, int Vt, int reinforce) {
  Dims d;
  d.B = B;
  d.Ls = Ls;
  d.S = Ls + 1;
  d.Lt = Lt;
  d.reinforce = reinforce != 0;
  d.T = d.reinforce ? Lt : Lt + 1;
  d.D = D;
  d.H = H;
  d.L = L;
  d.Vs = Vs;
  d.Vt = Vt;
  d.G = 4ll * H;
  d.SB = static_cast<ll>(d.S) * B;
  d.TB = static_cast<ll>(d.T) * B;
  return d;
}

bool valid_dims(const Dims& d) {
  // The attention kernels keep S floats in shared memory.
  return d.B > 0 && d.Ls > 0 && d.T > 0 && d.D > 0 && d.H > 0 && d.L > 0 && d.Vs > 0 &&
         d.Vt > 0 && d.S <= kMaxSource;
}

Weights make_weights(const void* src, const void* tgt, const void* const* w, int pad, int start,
                     int end) {
  auto f = [&](int i) { return static_cast<const float*>(w[i]); };
  return Weights{static_cast<const int*>(src), static_cast<const int*>(tgt), f(0), f(1), f(2),
                 f(3), f(4), f(5), f(6), f(7), f(8), f(9), pad, start, end};
}

}  // namespace
}  // namespace probnmn

using namespace probnmn;

// Floats of K4f's workspace: lean (keep = 0) or the residuals K4b starts
// from (keep = 1).
extern "C" long long probnmn_tf_workspace_floats(int batch, int ls, int lt, int input_size,
                                                 int hidden, int layers, int src_vocab,
                                                 int tgt_vocab, int reinforce, int keep) {
  const Dims d = make_dims(batch, ls, lt, input_size, hidden, layers, src_vocab, tgt_vocab,
                           reinforce);
  return layout(d, keep != 0, nullptr, nullptr);
}

// Floats of K4b's scratch.
extern "C" long long probnmn_tf_scratch_floats(int batch, int ls, int lt, int input_size,
                                               int hidden, int layers, int src_vocab,
                                               int tgt_vocab, int reinforce) {
  const Dims d = make_dims(batch, ls, lt, input_size, hidden, layers, src_vocab, tgt_vocab,
                           reinforce);
  return scratch_layout(d, nullptr, nullptr);
}

// The launch plan of an encoder layer's sweep for B rows of H units, the
// forward's (K4f, K3f; forward = 1) or the reverse's (K4b): out = {the
// cluster size, units a CTA, rows a cluster, threads a CTA, clusters,
// clusters the card runs at once, shared memory bytes a CTA, registers a
// thread}.
extern "C" int probnmn_tf_sweep_plan(int batch, int hidden, int forward, int* out) {
  SweepPlan p;
  cudaFuncAttributes attr;
  cudaError_t err = forward ? fwd_sweep_plan(hidden, batch, nullptr, &p)
                            : sweep_plan(hidden, batch, nullptr, &p);
  if (err == cudaSuccess) {
    err = forward ? cudaFuncGetAttributes(&attr, fwd_sweep_kernel(p.rows))
                  : cudaFuncGetAttributes(&attr, lstm_bwd_sweep);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[] = {p.cluster, p.units,   p.rows,
                   p.threads, p.clusters, p.fit,
                   static_cast<int>(p.smem), attr.numRegs};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// K4f. src (B, Ls) and tgt (B, Lt) int32; `weights` points to the ten packed
// arrays in the order of struct Weights: src_emb (Vs, D), tgt_emb (Vt, D),
// enc_wih (the layers' (4H, D_l) one after another), enc_whh (L, 4H, H),
// enc_bias (L, 4H), dec_w (4H, 2H), dec_wx (4H, D), dec_bias (4H),
// proj_w (Vt, H), proj_b (Vt). Writes loss (B,). With keep, the workspace
// is in the residual layout and holds, on return, what K4b starts from.
// dropout_keep: null, or the encoder's inter-layer dropout keep mask
// (L-1, B, dropout_steps, H) bytes (dropout_steps >= Ls + 1) with its scale
// 1 / (1 - p).
extern "C" int probnmn_tf_forward(const void* src, const void* tgt, int batch, int ls, int lt,
                                  const void* const* weights, void* workspace, void* loss,
                                  int keep, const void* dropout_keep, int dropout_steps,
                                  float dropout_scale, int input_size, int hidden, int layers,
                                  int src_vocab, int tgt_vocab, int reinforce, int pad,
                                  int start, int end, void* stream) {
  const Dims d = make_dims(batch, ls, lt, input_size, hidden, layers, src_vocab, tgt_vocab,
                           reinforce);
  if (!valid_dims(d)) return static_cast<int>(cudaErrorInvalidValue);
  Workspace ws;
  layout(d, keep != 0, static_cast<float*>(workspace), &ws);
  const Weights wt = make_weights(src, tgt, weights, pad, start, end);
  const Dropout dr{static_cast<const unsigned char*>(dropout_keep), dropout_steps, dropout_scale};
  if (dr.keep != nullptr && dropout_steps < d.S) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = forward_pass(d, wt, ws, dr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_head_fwd<<<ceil_div(d.TB * 32, 256), 256, 0, s>>>(ws.logits, ws.label, ws.ce,
                                                       static_cast<int>(d.TB), d.Vt, pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  loss_rows<<<ceil_div(d.B, 128), 128, 0, s>>>(ws.ce, ws.label, nullptr, static_cast<float*>(loss),
                                               nullptr, d.B, d.T, pad,
                                               d.reinforce ? kReinforceEps : kCeEps);
  return static_cast<int>(cudaGetLastError());
}

// K4b. The forward's sizes and weights, dloss (B,), the residuals a K4f with
// keep wrote (consumed: one backward per forward) and a scratch of
// probnmn_tf_scratch_floats() floats; `grads` points to ten arrays in the
// weights' order and layouts, which receive the gradient of
// sum(dloss * loss) (enc_bias and dec_bias: the gradient of b_ih and of
// b_hh alike). The dropout mask is the one K4f took.
extern "C" int probnmn_tf_backward(int batch, int ls, int lt, const void* const* weights,
                                   const void* dloss, void* residuals, void* scratch,
                                   void* const* grads, const void* dropout_keep,
                                   int dropout_steps, float dropout_scale, int input_size, int hidden, int layers,
                                   int src_vocab, int tgt_vocab, int reinforce, int pad,
                                   int start, int end, void* stream) {
  const Dims d = make_dims(batch, ls, lt, input_size, hidden, layers, src_vocab, tgt_vocab,
                           reinforce);
  if (!valid_dims(d)) return static_cast<int>(cudaErrorInvalidValue);
  Workspace ws;
  layout(d, true, static_cast<float*>(residuals), &ws);
  Scratch sc;
  scratch_layout(d, static_cast<float*>(scratch), &sc);
  const Weights wt = make_weights(nullptr, nullptr, weights, pad, start, end);
  auto g = [&](int i) { return static_cast<float*>(grads[i]); };
  const Grads gr{g(0), g(1), g(2), g(3), g(4), g(5), g(6), g(7), g(8), g(9)};
  const Dropout dr{static_cast<const unsigned char*>(dropout_keep), dropout_steps, dropout_scale};
  if (dr.keep != nullptr && dropout_steps < d.S) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = backward_pass(d, wt, ws, sc, static_cast<const float*>(dloss), gr, dr,
                                        static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
