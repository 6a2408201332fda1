// Shared LSTM device helpers (torch gate order i, f, g, o; masked steps
// freeze the state), for the training kernels (train_common.cuh).
#pragma once

#include "common.cuh"

namespace probnmn {

// Activated gates of one hidden unit.
struct LstmGates {
  float i, f, g, o;
};

__device__ __forceinline__ LstmGates lstm_activate(float pi, float pf, float pg, float po) {
  return {sigmoid(pi), sigmoid(pf), tanhf(pg), sigmoid(po)};
}

// One unit's masked cell update. `m` is 1 at a real step and 0 at a pad step,
// where h and c keep their previous values. `y` is the output the next layer
// (or the head) reads: the post-freeze h times m.
__device__ __forceinline__ void lstm_cell_forward(const LstmGates& a, float h_prev, float c_prev,
                                                  float m, float& h, float& c, float& y) {
  const float c_new = a.f * c_prev + a.i * a.g;
  const float h_new = a.o * tanhf(c_new);
  h = m * h_new + (1.f - m) * h_prev;
  c = m * c_new + (1.f - m) * c_prev;
  y = h * m;
}

// Its backward. `dh` and `dc` are the gradients reaching this step's
// post-freeze h and c (dh already holds the output's gradient times m);
// `c_post` is this step's post-freeze c and `c_prev` the previous step's.
// Writes d(pre-activation) of the four gates, and the parts of the previous
// step's dh and dc that do not go through the recurrent product
// (dpre . W_hh, which the caller adds).
__device__ __forceinline__ void lstm_cell_backward(const LstmGates& a, float c_post, float c_prev,
                                                   float m, float dh, float dc, float dpre[4],
                                                   float& dh_carry, float& dc_carry) {
  const float dh_new = dh * m;
  const float tc = tanhf(c_post);
  const float d_o = dh_new * tc;
  const float dc_new = dc * m + dh_new * a.o * (1.f - tc * tc);
  dpre[0] = dc_new * a.g * a.i * (1.f - a.i);
  dpre[1] = dc_new * c_prev * a.f * (1.f - a.f);
  dpre[2] = dc_new * a.i * (1.f - a.g * a.g);
  dpre[3] = d_o * a.o * (1.f - a.o);
  dh_carry = dh * (1.f - m);
  dc_carry = dc * (1.f - m) + dc_new * a.f;
}

}  // namespace probnmn
