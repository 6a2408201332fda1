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
// The GEMM, the step kernels, the layer sweeps, the head and the reductions
// live in train_common.cuh, shared with K4 (tf_train.cu). Every entry point
// launches on the caller's stream, allocates nothing (the caller passes a
// workspace of probnmn_lm_workspace_floats() floats) and returns
// cudaGetLastError().

#include "train_common.cuh"

namespace probnmn {
namespace {

constexpr float kCeEps = 1e-13f;  // allennlp's sequence cross entropy

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
  ll n = layer_partial_floats(d.TB, d.H, d.D > d.H ? d.D : d.H);
  const ll more[] = {splitk_floats(d.TB, d.V, d.D), splitk_floats(d.TB, d.D, d.H),
                     chunk_count(d.TB) * d.V * d.D};
  for (ll m : more) n = n > m ? n : m;
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

LayerArgs layer_args(const Dims& d, const Weights& wt, const Workspace& ws, int l) {
  LayerArgs a;
  a.T = d.T;
  a.B = d.B;
  a.H = d.H;
  a.din = l == 0 ? d.D : d.H;
  a.x = l == 0 ? ws.x0 : ws.y + (l - 1) * ws.layer_h;
  a.w_ih = wt.wih(d, l);
  a.w_hh = wt.whh(d, l);
  a.bias = wt.bias + l * d.G;
  a.m = ws.m_in;
  a.gates = ws.gates + l * ws.layer_gates;
  a.h = ws.h + l * ws.layer_h;
  a.c = ws.c + l * ws.layer_h;
  a.y = ws.y + l * ws.layer_h;
  return a;
}

// The forward through the logits, into the workspace.
cudaError_t forward_pass(const Dims& d, const Weights& wt, const Workspace& ws, cudaStream_t s) {
  const ll TB = d.TB;
  token_streams<<<ceil_div(TB, 256), 256, 0, s>>>(wt.tokens, d.B, d.Lt, d.T, d.V, wt.pad,
                                                   wt.start, wt.end, true, ws.lm_in, ws.label,
                                                   ws.m_in, nullptr);
  TRAIN_LAUNCHED();
  embed_rows<<<ceil_div(TB * d.D, 256), 256, 0, s>>>(wt.emb, ws.lm_in, ws.m_in, ws.x0, d.TB, d.D);
  TRAIN_LAUNCHED();
  for (int l = 0; l < d.L; ++l) TRAIN_TRY(lstm_layer_forward(s, layer_args(d, wt, ws, l)));
  const float* top = ws.y + (d.L - 1) * ws.layer_h;
  TRAIN_TRY(gemm(s, top, d.H, 1, wt.proj, 1, d.H, ws.proj_out, d.D, d.TB, d.D, d.H, nullptr, false,
                 nullptr));
  TRAIN_TRY(gemm(s, ws.proj_out, d.D, 1, wt.emb, 1, d.D, ws.logits, d.V, d.TB, d.V, d.D, nullptr,
                 false, nullptr));
  return cudaSuccess;
}

struct Grads {
  float *emb, *proj, *w_ih, *w_hh, *bias;
};

cudaError_t backward_pass(const Dims& d, const Weights& wt, const Workspace& ws,
                          const float* dloss, const Grads& gr, cudaStream_t s) {
  const ll TB = d.TB;
  TRAIN_TRY(forward_pass(d, wt, ws, s));
  loss_rows<<<ceil_div(d.B, 128), 128, 0, s>>>(nullptr, ws.label, dloss, nullptr, ws.dnum, d.B,
                                               d.T, wt.pad, kCeEps);
  TRAIN_LAUNCHED();
  ce_head_bwd<<<ceil_div(TB * 32, 256), 256, 0, s>>>(ws.logits, ws.label, ws.dnum, d.TB, d.B, d.V,
                                                     wt.pad);
  TRAIN_LAUNCHED();
  const float* dlogits = ws.logits;
  const float* top = ws.y + (d.L - 1) * ws.layer_h;
  // dproj_out = dlogits . emb;  d_emb = dlogits^T . proj_out (output side, pad row included)
  TRAIN_TRY(gemm(s, dlogits, d.V, 1, wt.emb, d.D, 1, ws.dproj_out, d.D, d.TB, d.D, d.V, nullptr,
                 false, nullptr));
  TRAIN_TRY(gemm(s, dlogits, 1, d.V, ws.proj_out, d.D, 1, gr.emb, d.D, d.V, d.D, d.TB, nullptr,
                 false, ws.partial));
  // d_proj (D, H) = dproj_out^T . top;  dtop = dproj_out . proj
  TRAIN_TRY(gemm(s, ws.dproj_out, 1, d.D, top, d.H, 1, gr.proj, d.H, d.D, d.H, d.TB, nullptr,
                 false, ws.partial));
  const float* ext = ws.e0;
  TRAIN_TRY(gemm(s, ws.dproj_out, d.D, 1, wt.proj, d.H, 1, ws.e0, d.H, d.TB, d.H, d.D, nullptr,
                 false, nullptr));
  // Layers top down; layer l's dx is the gradient reaching layer l - 1's y.
  for (int l = d.L - 1; l >= 0; --l) {
    float* dx = (d.L - 1 - l) % 2 == 0 ? ws.e1 : ws.e0;
    TRAIN_TRY(lstm_layer_backward(s, layer_args(d, wt, ws, l), ext, nullptr, ws.dh, ws.dc,
                                  gr.w_ih + (l == 0 ? 0 : d.G * d.D + (l - 1) * d.G * d.H),
                                  gr.w_hh + l * d.G * d.H, gr.bias + l * d.G, dx, ws.partial));
    ext = dx;
  }
  // ext now holds dx0: the embedding's input side, reduced per token id.
  return embedding_grad(s, ext, ws.lm_in, d.TB, d.D, d.V, wt.pad, gr.emb, true, ws.partial);
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
  ce_head_fwd<<<ceil_div(static_cast<ll>(d.TB) * 32, 256), 256, 0, s>>>(ws.logits, ws.label,
                                                                        ws.ce, d.TB, d.V, pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  loss_rows<<<ceil_div(d.B, 128), 128, 0, s>>>(ws.ce, ws.label, nullptr, static_cast<float*>(loss),
                                               nullptr, d.B, d.T, pad, kCeEps);
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
