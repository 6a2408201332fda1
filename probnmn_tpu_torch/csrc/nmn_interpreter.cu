// Kernel K2: the NMN program interpreter (inference), one launch per batch.
//
// Replaces probnmn_tpu/ops/pallas/nmn_interpreter.py::_interpreter_kernel.
// Each example runs its own program exactly: the tag machine walks the
// reversed tokens from the first non-pad step and stops at the first invalid
// op; only the chain of each step's module kind runs:
//   attention / query: two 3x3 convs (attention adds a sigmoid 1x1 head);
//   relate: five 3x3 convs at dilations 1, 2, 4, 8, 1, then a sigmoid 1x1 head;
//   same: argmax gather of the attention's location, then a 1x1 head;
//   compare: a 1x1 projection of concat(out, saved), then two 3x3 convs;
//   scene / and / or: register updates.
// The output is zeroed when the program is invalid or its final register is
// not a feature map.
//
// Bound on an H100: compute (3x3 convs, 57.8 MFLOP each, ~15 per valid CLEVR
// program). Design: one block per example, so the scalar tag machine is
// uniform within the block. The conv input and output tiles (H*W rows of C
// channels, unpadded, plus one zero row that out-of-range taps read instead
// of being predicated) live in shared memory, rows pitched at C + 8 elements
// so the eight rows a tensor-core fragment reads fall in distinct banks:
// 2 x 197 x 136 x 4 B = 214 KB in float32, half that in bf16. Weights stream
// tap by tap from the unified bank, which stays in L2.
//
// bf16 with C == 128 (the serving path) runs each conv as an implicit GEMM on
// the tensor cores (mma.sync m16n8k16, float32 accumulate): warp w owns output
// channels 32 * (w % 4) .. + 31 and every other 16-pixel tile, A fragments
// come from the shared tile at the tap's shifted rows, B fragments from the
// bank transposed to (tap, C_out, C_in); bf16 takes no other path. float32
// runs the SIMT path, the reference that holds the kernel's arithmetic to a
// tight tolerance: each thread keeps 4 output channels x kPix pixels of
// float32 sums. The out and saved registers live in a per-example global
// scratch, in the compute type, attentions broadcast over all C channels.

#include "common.cuh"

using namespace probnmn;

namespace {

enum Kind { NOP = 0, SCENE, AND, OR, ATTENTION, QUERY, RELATE, SAME, COMPARE };
enum Tag { TAG_NONE = 0, TAG_ATTN = 1, TAG_FEAT = 2 };

constexpr int kThreads = 256;
constexpr int kMaxChain = 5;
constexpr int kPix = 25;       // SIMT: pixels per thread per pass (8 groups x 25 >= 196)
constexpr int kRowPad = 8;     // shared-tile row pitch is C + kRowPad elements
constexpr int kMmaC = 128;     // channels of the tensor-core path
constexpr int kMmaTiles = 7;   // 16-pixel tiles per warp: HW <= 2 * 7 * 16
constexpr size_t kMaxSmem = 232448;

struct NmnParams {
  const int* programs;
  int batch, T;
  const int* kind;
  const int* slot3;
  const int* head_slot;
  const int* cmp_slot;
  const int* same_slot;
  const void* x;
  const void* w3;     // (S3, 9, C_in, C_out)
  const void* w3t;    // (S3, 9, C_out, C_in), tensor-core path only
  const float* b3;
  const void* w1;
  const float* b1;
  const void* same_wf;
  const float* same_wa;
  const float* same_b;
  const void* wcmp;   // (Sc, 2C, C)
  const void* wcmpt;  // (Sc, 2, C_out, C_in), tensor-core path only
  const float* bcmp;
  void* out;
  void* saved;
  int* invalid;
  int H, W, C;
};

// ---------------------------------------------------------------- SIMT path
// Thread layout: C/4 lanes of 4 output channels, blockDim / (C/4) pixel
// groups; a thread owns pixels pg, pg + ng, ...
struct Tile {
  int co, pg, ng;
  __device__ explicit Tile(int C) {
    const int lanes = C >> 2;
    co = (threadIdx.x % lanes) * 4;
    pg = threadIdx.x / lanes;
    ng = blockDim.x / lanes;
  }
};

template <typename T>
__device__ __forceinline__ void store_relu(T* dst, int pitch, const float acc[kPix][4],
                                           const float* bias, const Tile& tl, int p0, int HW) {
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int pix = p0 + i * tl.ng;
    if (pix < HW) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[pix * pitch + tl.co + j] = from_f<T>(fmaxf(acc[i][j] + bias[tl.co + j], 0.f));
    }
  }
}

// dst = relu(conv3x3_d(in) + bias). `in` is a shared tile of HW + 1 rows at
// pitch P whose row HW is zero; w is (9, C_in, C_out) for one bank slot.
template <typename T>
__device__ void conv3x3_simt(const T* __restrict__ in, T* __restrict__ dst, const T* __restrict__ w,
                             const float* __restrict__ bias, int d, int H, int W, int C, int P) {
  const int HW = H * W;
  const Tile tl(C);
  for (int p0 = tl.pg; p0 < HW; p0 += tl.ng * kPix) {
    float acc[kPix][4];
#pragma unroll
    for (int i = 0; i < kPix; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = (tap / 3 - 1) * d, dx = (tap % 3 - 1) * d;
      int off[kPix];
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const int pix = p0 + i * tl.ng;
        const int y = pix / W + dy, xx = pix % W + dx;
        off[i] = (pix < HW && y >= 0 && y < H && xx >= 0 && xx < W) ? (y * W + xx) * P : HW * P;
      }
      const T* wt = w + static_cast<size_t>(tap) * C * C + tl.co;
      for (int ci = 0; ci < C; ++ci) {
        float wv[4];
        load4(wt + static_cast<size_t>(ci) * C, wv);
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          const float xv = to_f(in[off[i] + ci]);
          acc[i][0] = fmaf(xv, wv[0], acc[i][0]);
          acc[i][1] = fmaf(xv, wv[1], acc[i][1]);
          acc[i][2] = fmaf(xv, wv[2], acc[i][2]);
          acc[i][3] = fmaf(xv, wv[3], acc[i][3]);
        }
      }
    }
    store_relu<T>(dst, P, acc, bias, tl, p0, HW);
  }
}

// dst (global, pitch C) = relu(concat(a, b) @ w + bias): compare's 1x1
// projection; a and b are shared tiles at pitch P; w is (2C, C).
template <typename T>
__device__ void proj1x1_simt(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ dst,
                             const T* __restrict__ w, const float* __restrict__ bias, int HW, int C,
                             int P) {
  const Tile tl(C);
  for (int p0 = tl.pg; p0 < HW; p0 += tl.ng * kPix) {
    float acc[kPix][4];
    int off[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int pix = p0 + i * tl.ng;
      off[i] = (pix < HW ? pix : HW) * P;
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
    for (int half = 0; half < 2; ++half) {
      const T* src = half == 0 ? a : b;
      const T* wh = w + static_cast<size_t>(half) * C * C + tl.co;
      for (int ci = 0; ci < C; ++ci) {
        float wv[4];
        load4(wh + static_cast<size_t>(ci) * C, wv);
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          const float xv = to_f(src[off[i] + ci]);
          acc[i][0] = fmaf(xv, wv[0], acc[i][0]);
          acc[i][1] = fmaf(xv, wv[1], acc[i][1]);
          acc[i][2] = fmaf(xv, wv[2], acc[i][2]);
          acc[i][3] = fmaf(xv, wv[3], acc[i][3]);
        }
      }
    }
    store_relu<T>(dst, C, acc, bias, tl, p0, HW);
  }
}

// ---------------------------------------------------------------- tensor-core path (bf16)
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// dst = relu(sum over taps of shift_tap(src_tap) @ wt[tap]^T + bias) as an
// implicit GEMM: M = pixels (16-row tiles), N = kMmaC output channels,
// K = taps x kMmaC. taps == 9: a 3x3 conv at dilation d over in0; taps == 2:
// a 1x1 over concat(in0, in1). Sources are shared tiles at pitch P with a zero
// row HW; wt is (taps, C_out, C_in); dst has pitch dst_pitch.
__device__ void conv_mma(const bf16* in0, const bf16* in1, bf16* dst, int dst_pitch,
                         const bf16* __restrict__ wt, const float* __restrict__ bias, int taps,
                         int d, int H, int W) {
  constexpr int C = kMmaC, P = kMmaC + kRowPad;
  const int HW = H * W, tiles = (HW + 15) / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_base = (warp & 3) * 32, m_first = warp >> 2;
  float acc[kMmaTiles][4][4];
#pragma unroll
  for (int i = 0; i < kMmaTiles; ++i)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[i][nt][0] = acc[i][nt][1] = acc[i][nt][2] = acc[i][nt][3] = 0.f;

  for (int tap = 0; tap < taps; ++tap) {
    const bf16* src = tap == 1 && taps == 2 ? in1 : in0;
    const int dy = taps == 9 ? (tap / 3 - 1) * d : 0, dx = taps == 9 ? (tap % 3 - 1) * d : 0;
    int off[kMmaTiles][2];  // element offsets of this lane's two A rows per tile
#pragma unroll
    for (int i = 0; i < kMmaTiles; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pix = (m_first + 2 * i) * 16 + g + 8 * h;
        const int y = pix / W + dy, x = pix % W + dx;
        const bool ok = pix < HW && y >= 0 && y < H && x >= 0 && x < W;
        off[i][h] = (ok ? y * W + x : HW) * P + 2 * t4;
      }
    const bf16* wtap = wt + static_cast<size_t>(tap) * C * C + 2 * t4;
    for (int kc = 0; kc < C; kc += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* wp = wtap + (n_base + nt * 8 + g) * C + kc;
        b[nt][0] = ld32(wp);
        b[nt][1] = ld32(wp + 8);
      }
#pragma unroll
      for (int i = 0; i < kMmaTiles; ++i) {
        if (m_first + 2 * i < tiles) {
          const uint32_t a0 = ld32(src + off[i][0] + kc), a1 = ld32(src + off[i][1] + kc);
          const uint32_t a2 = ld32(src + off[i][0] + kc + 8), a3 = ld32(src + off[i][1] + kc + 8);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[i][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMmaTiles; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pix = (m_first + 2 * i) * 16 + g + 8 * h;
      if (pix < HW) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int co = n_base + nt * 8 + 2 * t4;
          const float v0 = fmaxf(acc[i][nt][2 * h] + bias[co], 0.f);
          const float v1 = fmaxf(acc[i][nt][2 * h + 1] + bias[co + 1], 0.f);
          *reinterpret_cast<__nv_bfloat162*>(dst + pix * dst_pitch + co) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
}

// ---------------------------------------------------------------- shared pieces
// out[p, :] = sigmoid(act[p, :] . w1 + b1), broadcast over all channels; one
// warp per pixel; act is a shared tile at pitch P.
template <typename T>
__device__ void head_to_out(const T* act, int P, T* out, const T* w1, float b1, int HW, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int pix = warp; pix < HW; pix += nwarps) {
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s = fmaf(to_f(act[pix * P + c]), to_f(w1[c]), s);
    s = warp_sum(s);
    const T a = from_f<T>(sigmoid(s + b1));
    for (int c = lane; c < C; c += 32) out[pix * C + c] = a;
  }
}

template <typename T, bool kMma>
__device__ __forceinline__ void conv3x3(const T* in, T* dst, const NmnParams& p, int slot, int d,
                                        int P) {
  const size_t w_off = static_cast<size_t>(slot) * 9 * p.C * p.C;
  const float* bias = p.b3 + static_cast<size_t>(slot) * p.C;
  if constexpr (kMma) {
    conv_mma(in, nullptr, dst, P, static_cast<const bf16*>(p.w3t) + w_off, bias, 9, d, p.H, p.W);
  } else {
    conv3x3_simt<T>(in, dst, static_cast<const T*>(p.w3) + w_off, bias, d, p.H, p.W, p.C, P);
  }
}

template <typename T, bool kMma>
__global__ void __launch_bounds__(kThreads) nmn_interpreter_kernel(const NmnParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_argmax;
  const int H = p.H, W = p.W, C = p.C, HW = H * W, N = HW * C, T_len = p.T, P = C + kRowPad;
  T* buf_a = reinterpret_cast<T*>(smem_raw);
  T* buf_b = buf_a + static_cast<size_t>(HW + 1) * P;
  const int b = blockIdx.x, tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const T* x = static_cast<const T*>(p.x) + static_cast<size_t>(b) * N;
  T* out = static_cast<T*>(p.out) + static_cast<size_t>(b) * N;
  T* saved = static_cast<T*>(p.saved) + static_cast<size_t>(b) * N;
  const T* w1 = static_cast<const T*>(p.w1);
  const T* same_wf = static_cast<const T*>(p.same_wf);
  const int* prog = p.programs + static_cast<size_t>(b) * T_len;
  const T zero = from_f<T>(0.f), one = from_f<T>(1.f);

  for (int c = tid; c < C; c += nthreads) {
    buf_a[HW * P + c] = zero;
    buf_b[HW * P + c] = zero;
  }
  for (int e = tid; e < N; e += nthreads) {
    out[e] = x[e];
    saved[e] = zero;
  }
  // Reversed prefix order: the last token runs first; the reversed order's
  // leading pads are no-ops and are skipped.
  int start = T_len;
  for (int t = 0; t < T_len; ++t)
    if (prog[T_len - 1 - t] != 0) {
      start = t;
      break;
    }
  int out_tag = TAG_FEAT, saved_tag = TAG_NONE;
  bool invalid = false;
  __syncthreads();

  for (int t = start; t < T_len && !invalid; ++t) {
    const int tok = prog[T_len - 1 - t];
    const int kind = p.kind[tok];
    const int hs = p.head_slot[tok];
    const bool is_binop = kind == AND || kind == OR;
    const bool is_chain = kind == ATTENTION || kind == QUERY || kind == RELATE;
    const bool scene_ok = kind == SCENE;
    const bool binop_ok = is_binop && saved_tag != TAG_NONE;
    const bool do_chain = is_chain && out_tag == TAG_ATTN;
    const bool do_cmp = kind == COMPARE && out_tag == TAG_FEAT && saved_tag == TAG_FEAT;
    const bool do_same = kind == SAME && out_tag == TAG_ATTN;
    const bool has_head = hs >= 0;
    invalid = (is_binop && !binop_ok) || (is_chain && !do_chain) || (kind == COMPARE && !do_cmp) ||
              (kind == SAME && !do_same);
    const bool both_attn = out_tag == TAG_ATTN && saved_tag == TAG_ATTN;
    const int new_out_tag = scene_ok    ? TAG_ATTN
                            : binop_ok  ? (both_attn ? TAG_ATTN : TAG_FEAT)
                            : do_chain  ? (has_head ? TAG_ATTN : TAG_FEAT)
                            : do_cmp    ? TAG_FEAT
                            : do_same   ? TAG_ATTN
                                        : out_tag;
    if (scene_ok) saved_tag = out_tag;
    out_tag = new_out_tag;

    if (scene_ok) {  // save the output, reset it to an all-ones attention
      for (int e = tid; e < N; e += nthreads) {
        saved[e] = out[e];
        out[e] = one;
      }
    } else if (binop_ok) {  // intersect / union
      for (int e = tid; e < N; e += nthreads) {
        const float o = to_f(out[e]), s = to_f(saved[e]);
        out[e] = from_f<T>(kind == AND ? fminf(o, s) : fmaxf(o, s));
      }
    } else if (do_chain) {
      for (int e = tid; e < N; e += nthreads)
        buf_a[(e / C) * P + e % C] = from_f<T>(to_f(x[e]) * to_f(out[e]));
      __syncthreads();
      const bool relate = kind == RELATE;
      const int layers = relate ? 5 : 2;
      T* src = buf_a;
      T* dst = buf_b;
      for (int l = 0; l < layers; ++l) {
        const int d = relate ? (l == 4 ? 1 : 1 << l) : 1;
        conv3x3<T, kMma>(src, dst, p, p.slot3[tok * kMaxChain + l], d, P);
        __syncthreads();
        T* tmp = src;
        src = dst;
        dst = tmp;
      }
      if (has_head) {
        head_to_out<T>(src, P, out, w1 + static_cast<size_t>(hs) * C, p.b1[hs], HW, C);
      } else {
        for (int e = tid; e < N; e += nthreads) out[e] = src[(e / C) * P + e % C];
      }
    } else if (do_cmp) {
      for (int e = tid; e < N; e += nthreads) {
        buf_a[(e / C) * P + e % C] = out[e];
        buf_b[(e / C) * P + e % C] = saved[e];
      }
      __syncthreads();
      const int cs = p.cmp_slot[tok];
      const float* bias = p.bcmp + static_cast<size_t>(cs) * C;
      if constexpr (kMma) {
        conv_mma(buf_a, buf_b, out, C, static_cast<const bf16*>(p.wcmpt) + static_cast<size_t>(cs) * 2 * C * C,
                 bias, 2, 1, H, W);
      } else {
        proj1x1_simt<T>(buf_a, buf_b, out, static_cast<const T*>(p.wcmp) + static_cast<size_t>(cs) * 2 * C * C,
                        bias, HW, C, P);
      }
      __syncthreads();
      for (int e = tid; e < N; e += nthreads) buf_a[(e / C) * P + e % C] = out[e];
      __syncthreads();
      conv3x3<T, kMma>(buf_a, buf_b, p, p.slot3[tok * kMaxChain], 1, P);
      __syncthreads();
      conv3x3<T, kMma>(buf_b, buf_a, p, p.slot3[tok * kMaxChain + 1], 1, P);
      __syncthreads();
      for (int e = tid; e < N; e += nthreads) out[e] = buf_a[(e / C) * P + e % C];
    } else if (do_same) {
      // Argmax (first occurrence) of the attention held in channel 0.
      if (tid == 0) {
        float best = to_f(out[0]);
        int best_p = 0;
        for (int pix = 1; pix < HW; ++pix) {
          const float v = to_f(out[pix * C]);
          if (v > best) {
            best = v;
            best_p = pix;
          }
        }
        s_argmax = best_p;
      }
      __syncthreads();
      const int ss = p.same_slot[tok];
      const T* vec = x + static_cast<size_t>(s_argmax) * C;
      const T* wf = same_wf + static_cast<size_t>(ss) * C;
      const float wa = p.same_wa[ss], bias = p.same_b[ss];
      for (int pix = warp; pix < HW; pix += nwarps) {
        const float attn = to_f(out[pix * C]);
        float s = 0.f;
        for (int c = lane; c < C; c += 32)
          s = fmaf(rnd<T>(to_f(x[pix * C + c]) * to_f(vec[c])), to_f(wf[c]), s);
        s = warp_sum(s);
        const T a = from_f<T>(sigmoid(s + attn * wa + bias));
        for (int c = lane; c < C; c += 32) out[pix * C + c] = a;
      }
    }
    __syncthreads();
  }
  // The program must end in a feature map, not an attention.
  if (out_tag != TAG_FEAT) invalid = true;
  if (invalid)
    for (int e = tid; e < N; e += nthreads) out[e] = zero;
  if (tid == 0) p.invalid[b] = invalid ? 1 : 0;
}

template <typename T, bool kMma>
cudaError_t launch_nmn(const NmnParams& p, cudaStream_t stream) {
  const size_t bytes = 2ull * (static_cast<size_t>(p.H) * p.W + 1) * (p.C + kRowPad) * sizeof(T);
  if (bytes + sizeof(int) > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(nmn_interpreter_kernel<T, kMma>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  nmn_interpreter_kernel<T, kMma><<<p.batch, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (SIMT), 1 bfloat16 (tensor cores: needs w3t / wcmpt, the
// banks transposed to (.., C_out, C_in), C == 128 and H * W <= 224).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int probnmn_nmn_interpret(
    int dtype, const void* programs, int batch, int num_steps, const void* kind,
    const void* slot3, const void* head_slot, const void* cmp_slot, const void* same_slot,
    const void* x, const void* w3, const void* w3t, const void* b3, const void* w1,
    const void* b1, const void* same_wf, const void* same_wa, const void* same_b,
    const void* wcmp, const void* wcmpt, const void* bcmp, void* out, void* saved,
    void* invalid, int H, int W, int C, void* stream) {
  if (batch <= 0) return 0;
  if (C % 4 != 0 || kThreads % (C / 4) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool mma = dtype == 1;
  if (mma && (w3t == nullptr || wcmpt == nullptr || C != kMmaC || H * W > 2 * kMmaTiles * 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!mma && dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  NmnParams p;
  p.programs = static_cast<const int*>(programs);
  p.batch = batch;
  p.T = num_steps;
  p.kind = static_cast<const int*>(kind);
  p.slot3 = static_cast<const int*>(slot3);
  p.head_slot = static_cast<const int*>(head_slot);
  p.cmp_slot = static_cast<const int*>(cmp_slot);
  p.same_slot = static_cast<const int*>(same_slot);
  p.x = x;
  p.w3 = w3;
  p.w3t = w3t;
  p.b3 = static_cast<const float*>(b3);
  p.w1 = w1;
  p.b1 = static_cast<const float*>(b1);
  p.same_wf = same_wf;
  p.same_wa = static_cast<const float*>(same_wa);
  p.same_b = static_cast<const float*>(same_b);
  p.wcmp = wcmp;
  p.wcmpt = wcmpt;
  p.bcmp = static_cast<const float*>(bcmp);
  p.out = out;
  p.saved = saved;
  p.invalid = static_cast<int*>(invalid);
  p.H = H;
  p.W = W;
  p.C = C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mma)
    err = launch_nmn<bf16, true>(p, s);
  else
    err = launch_nmn<float, false>(p, s);
  return static_cast<int>(err);
}
