// Kernels K2, K5 and K6: the NMN program interpreter (inference), its
// training forward, and its backward.
//
// K2 replaces probnmn_tpu/ops/pallas/nmn_interpreter.py::_interpreter_kernel.
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
// K5 replaces _interpreter_train_kernel: the same kernel body with kTrain set,
// which also stores what K6 reads back: the out register at the entry of every
// executed step (otraj, (B, T, HW, C)) and the outputs of the two 3x3 convs of
// every attention, query and compare step (atraj, (B, T, 2, HW, C)), both in
// the compute type, the JAX package's layout, copied in 16-byte pieces (the
// conv outputs from the shared tile after the conv's barrier); final and
// flags are K2's bit for bit.
//
// K6 replaces _interpreter_bwd_kernel: a block sweeps an example's executed
// steps in reverse, reading K5's residuals (no-replay mode); relate's chain
// and compare's projection are recomputed from the step's entry registers on
// the forward's conv code. Invalid examples get zero gradients. In replay
// mode (kReplay, the JAX kernel's no_replay=False) K5 never stored the
// residuals: each block first re-runs its example's program on the forward's
// own device code (interpret_example, K5's stores) into the block's slice of
// a (G, T, 3, HW, C) scratch, which the unchanged sweep then reads. The
// replay is K5's instruction sequence, so both modes give the same bits; the
// scratch is sized by the grid G, not B. Each conv's backward runs its input
// gradient as a tap-flipped conv of g_z over the bank in its stored (tap,
// C_in, C_out) layout (mma.sync m16n8k16 in bf16). The weight gradients are
// deterministic without float atomics: the sweep writes each conv's (input,
// g_z) pair in the compute type to a workspace tagged with its bank slot,
// and the weight-gradient kernels sum each slot's entries in (example, step)
// order in two fixed-order passes: chunks of a slot's entries spread over the
// SMs (nmn_weight_grad_tma in bf16: TMA into a two-stage ring, wgmma; _simt in
// float32), then nmn_weight_grad_reduce adds each slot's chunks in order; the
// small banks (biases, heads, same) take per-example float32 partials that
// nmn_sum_rows_kernel adds in example order.
//
// Bound on an H100: compute (3x3 convs, 57.8 MFLOP each, ~15 per valid CLEVR
// program; K6 does about twice K5's conv work), and within a batch the
// longest program's chain of convs (35 in a CLEVR batch of 256), which one
// block runs in series. Design: a block runs an example, so the scalar tag
// machine is uniform within the block; the grid is persistent, at most one
// block an SM, and the blocks take the examples longest program first
// (nmn_plan_kernel counts each program's convs; the wrapper sorts them) from
// a shared counter, so the batch takes about its longest chain. The conv
// input and output tiles (H*W rows of C channels, unpadded, plus one zero row
// that out-of-range taps read instead of being predicated) live in shared
// memory, rows pitched at C + 8 elements so the eight rows an ldmatrix or
// tensor-core fragment reads fall in distinct banks: 2 x 197 x 136 x 4 B =
// 214 KB in float32, half that in bf16. The per-example scratch of K6
// (gradient registers, relate's activations) lives in global memory.
//
// bf16 with C == 128 (H * W <= 256) runs each forward conv on wgmma
// m64n128k16 (float32 accumulate; conv_wgmma): the weights of each tap (a
// (C_in, C_out) matrix of w3, or a half of wcmp) arrive by TMA in a ring of
// two or three 32 KB shared-memory stages, 128-byte swizzled, which thread 0
// fills in the order the example's program will read them, a tap or more
// ahead of the products and across conv boundaries; every warpgroup reads
// the one staged copy as B. A goes through registers, loaded by ldmatrix at
// each lane's shifted source row; M = H * W pads to four 64-pixel tiles, one
// a warpgroup in K2 and K5 (512 threads: while one warpgroup loads a tap's A
// the other three keep the tensor cores busy), two in K6. With the ring the
// bf16 kernels hold one block an SM. bf16 takes no other path. float32 runs
// the SIMT path, the reference that holds the kernels' arithmetic to a tight
// tolerance: each thread keeps 4 output channels x kPix pixels of float32
// sums. The out and saved registers live in a per-example global scratch, in
// the compute type, attentions broadcast over all C channels; the forward's
// updates of them, and its copies between them and the tiles, move 16-byte
// pieces (an example's steps run in series, so their latency is the
// chain's).

#include <cuda.h>  // CUtensorMap (TMA descriptors); libcuda's encoder is looked up at run time

#include "common.cuh"

using namespace probnmn;

namespace {

enum Kind { NOP = 0, SCENE, AND, OR, ATTENTION, QUERY, RELATE, SAME, COMPARE };
enum Tag { TAG_NONE = 0, TAG_ATTN = 1, TAG_FEAT = 2 };

constexpr int kThreads = 256;
constexpr int kFwdThreads = 512;  // K2 / K5 in bf16: four warpgroups, a 64-pixel tile each
constexpr int kFwdTiles = 4 * 128 / kFwdThreads;  // their 64-pixel tiles a warpgroup
constexpr int kMaxChain = 5;
constexpr int kPix = 25;       // SIMT: pixels per thread per pass (8 groups x 25 >= 196)
constexpr int kRowPad = 8;     // shared-tile row pitch is C + kRowPad elements
constexpr int kMmaC = 128;     // channels of the tensor-core path
constexpr int kMmaTiles = 7;   // K6's input gradients (mma.sync): 16-pixel tiles a warp, HW <= 224
constexpr int kFwdMaxHW = 256; // the forward's wgmma core: four 64-pixel tiles
constexpr int kMaxHW = 256;    // K6: pixels of the per-pixel head gradients
constexpr int kGradChunk = 32; // weight-gradient SIMT path: pixels staged per pass
constexpr uint32_t kTapBytes = kMmaC * kMmaC * 2;  // one staged (C_in, C_out) bf16 weight matrix
constexpr int kMaxStages = 3;  // the forward's weight ring
constexpr size_t kMaxSmem = 232448;
constexpr size_t kStaticSmem = 2048;  // a kernel's static shared memory, at most

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
  const float* b3;
  const void* w1;
  const float* b1;
  const void* same_wf;
  const float* same_wa;
  const float* same_b;
  const void* wcmp;   // (Sc, 2C, C)
  const float* bcmp;
  const int* order;   // (B,) the examples in the order the blocks take them
  int* next;          // the blocks' example counter, zeroed before the launch
  int stages;         // bf16: stages of the weight ring
  void* out;
  void* saved;
  int* invalid;
  void* otraj;        // K5: (B, T, HW, C) out register at step entry
  void* atraj;        // K5: (B, T, 2, HW, C) outputs of the two-conv chains
  int H, W, C;
};

// ---------------------------------------------------------------- Hopper pieces
// mbarriers, TMA loads and wgmma (sm_90a).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor: 128-byte swizzle, MN-major. LBO is the
// stride between 64-element column blocks along M / N, SBO between groups of
// eight K rows (1024 bytes); all in 16-byte units.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory, lanes 8 i .. 8 i + 7 giving
// matrix i's row addresses: the A fragment of a 16 x 16 tile (mma.sync's
// m16n8k16 layout, which wgmma takes for A in registers).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (64 x 128, float32) += A (64 x 16, bf16, in registers: warp q of the
// warpgroup holds rows 16 q .. 16 q + 15) . B (16 x 128, bf16, MN-major in
// shared memory).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------- epilogues
// A conv hands its float32 sums to an epilogue two output channels at a time.

// dst = relu(v + bias) in T (pitch `pitch`), and with kResid the same
// values to `resid` (pitch C).
template <typename T, bool kResid>
struct StoreRelu {
  T* dst;
  int pitch;
  T* resid;
  int C;
  const float* bias;
  __device__ __forceinline__ void operator()(int pix, int o, float v0, float v1) const {
    v0 = fmaxf(v0 + bias[o], 0.f);
    v1 = fmaxf(v1 + bias[o + 1], 0.f);
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(dst + pix * pitch + o) = pair;
      if constexpr (kResid) *reinterpret_cast<__nv_bfloat162*>(resid + pix * C + o) = pair;
    } else {
      dst[pix * pitch + o] = v0;
      dst[pix * pitch + o + 1] = v1;
      if constexpr (kResid) {
        resid[pix * C + o] = v0;
        resid[pix * C + o + 1] = v1;
      }
    }
  }
};

// dst (float32, pitch C) = v, or += v with kAdd.
template <bool kAdd>
struct StoreF32 {
  float* dst;
  int C;
  __device__ __forceinline__ void operator()(int pix, int o, float v0, float v1) const {
    float* d = dst + pix * C + o;
    if (kAdd) {
      d[0] += v0;
      d[1] += v1;
    } else {
      d[0] = v0;
      d[1] = v1;
    }
  }
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

// acc[p, o] = sum over taps of src_tap[p + off_tap, :] . W_tap[:, o], handed
// to `epi`. taps == 9: a 3x3 conv at dilation d over in0, whose weight for
// the tap at offset k is W[flip ? 8 - k : k]; taps == 2: a 1x1 over
// concat(in0, in1); taps == 1: a 1x1 over in0. Sources are shared tiles at
// pitch P whose row HW is zero. W_tap[i, o] is w[tap][i][o], or w[tap][o][i]
// with kTrans (the input gradient of a conv reads its bank transposed).
template <typename T, bool kTrans, class Epi>
__device__ void conv_simt(const T* __restrict__ in0, const T* __restrict__ in1,
                          const T* __restrict__ w, int taps, int d, bool flip, int H, int W,
                          int C, int P, const Epi epi) {
  const int HW = H * W;
  const Tile tl(C);
  for (int p0 = tl.pg; p0 < HW; p0 += tl.ng * kPix) {
    float acc[kPix][4];
#pragma unroll
    for (int i = 0; i < kPix; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int tap = 0; tap < taps; ++tap) {
      const T* src = tap == 1 && taps == 2 ? in1 : in0;
      const int dy = taps == 9 ? (tap / 3 - 1) * d : 0, dx = taps == 9 ? (tap % 3 - 1) * d : 0;
      const int tw = taps == 9 && flip ? 8 - tap : tap;
      int off[kPix];
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const int pix = p0 + i * tl.ng;
        const int y = pix / W + dy, xx = pix % W + dx;
        off[i] = (pix < HW && y >= 0 && y < H && xx >= 0 && xx < W) ? (y * W + xx) * P : HW * P;
      }
      const T* wt = w + static_cast<size_t>(tw) * C * C;
      for (int ci = 0; ci < C; ++ci) {
        float wv[4];
        if constexpr (kTrans) {
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = to_f(wt[static_cast<size_t>(tl.co + j) * C + ci]);
        } else {
          load4(wt + static_cast<size_t>(ci) * C + tl.co, wv);
        }
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
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int pix = p0 + i * tl.ng;
      if (pix < HW) {
        epi(pix, tl.co, acc[i][0], acc[i][1]);
        epi(pix, tl.co + 2, acc[i][2], acc[i][3]);
      }
    }
  }
}

// ---------------------------------------------------------------- K6's input gradients (bf16): mma.sync
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

// A conv's input gradient as an implicit GEMM on mma.sync: M = pixels
// (16-row tiles), N = kMmaC input channels, K = taps x kMmaC output
// channels, taps flipped. wt is the bank as stored, (tap, C_in, C_out):
// for the input gradient that is (tap, N, K), K contiguous. Warp w owns
// N columns 32 (w % 4) .. + 31 and every other 16-pixel tile.
template <class Epi>
__device__ void conv_mma(const bf16* in0, const bf16* __restrict__ wt, int taps, int d, int H,
                         int W, const Epi epi) {
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
    const int dy = taps == 9 ? (tap / 3 - 1) * d : 0, dx = taps == 9 ? (tap % 3 - 1) * d : 0;
    const int tw = taps == 9 ? 8 - tap : tap;
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
    const bf16* wtap = wt + static_cast<size_t>(tw) * C * C + 2 * t4;
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
          const uint32_t a0 = ld32(in0 + off[i][0] + kc), a1 = ld32(in0 + off[i][1] + kc);
          const uint32_t a2 = ld32(in0 + off[i][0] + kc + 8), a3 = ld32(in0 + off[i][1] + kc + 8);
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
        for (int nt = 0; nt < 4; ++nt)
          epi(pix, n_base + nt * 8 + 2 * t4, acc[i][nt][2 * h], acc[i][nt][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------- the tag machine
// What one token does to the registers' tags: which module runs, whether
// the program turns invalid here (the machine then stops), and the new tags.
struct Step {
  int kind;
  bool scene_ok, binop_ok, do_chain, do_cmp, do_same, invalid;
};

__device__ __forceinline__ Step tag_step(int kind, bool has_head, int& out_tag, int& saved_tag) {
  Step s;
  s.kind = kind;
  const bool is_binop = kind == AND || kind == OR;
  const bool is_chain = kind == ATTENTION || kind == QUERY || kind == RELATE;
  s.scene_ok = kind == SCENE;
  s.binop_ok = is_binop && saved_tag != TAG_NONE;
  s.do_chain = is_chain && out_tag == TAG_ATTN;
  s.do_cmp = kind == COMPARE && out_tag == TAG_FEAT && saved_tag == TAG_FEAT;
  s.do_same = kind == SAME && out_tag == TAG_ATTN;
  s.invalid = (is_binop && !s.binop_ok) || (is_chain && !s.do_chain) ||
              (kind == COMPARE && !s.do_cmp) || (kind == SAME && !s.do_same);
  const bool both_attn = out_tag == TAG_ATTN && saved_tag == TAG_ATTN;
  const int new_out_tag = s.scene_ok    ? TAG_ATTN
                          : s.binop_ok  ? (both_attn ? TAG_ATTN : TAG_FEAT)
                          : s.do_chain  ? (has_head ? TAG_ATTN : TAG_FEAT)
                          : s.do_cmp    ? TAG_FEAT
                          : s.do_same   ? TAG_ATTN
                                        : out_tag;
  if (s.scene_ok) saved_tag = out_tag;
  out_tag = new_out_tag;
  return s;
}

// First non-pad step of an example in reversed (execution) order.
__device__ __forceinline__ int first_step(const int* prog, int T_len) {
  for (int t = 0; t < T_len; ++t)
    if (prog[T_len - 1 - t] != 0) return t;
  return T_len;
}

// ---------------------------------------------------------------- the weight ring (bf16)
// The bf16 forward's convs read their weights from a ring of shared-memory
// stages, one (C_in, C_out) matrix a stage: a 3x3 conv's nine taps of w3,
// compare's two halves of wcmp. The program alone decides which matrices an
// example's convs read, and in what order, so thread 0 walks it ahead of
// them (TileStream: the tag machine's convs for the forward; relate's chains
// and compare's projections, steps in reverse, for K6's recomputes) and
// loads each by TMA into the next free stage. A stage holds two boxes of
// (128 C_in rows, 64 C_out columns) at 128 bytes a row, 128-byte swizzled:
// B's MN-major layout for wgmma, as the banks lie (C_out contiguous).
struct TileStream {
  const int* prog;
  int T_len, t, start, out_tag, saved_tag, tok, kind, unit, units;
  bool forward;
};

__device__ __forceinline__ void stream_begin(TileStream& s, const int* prog, int T_len,
                                             bool forward) {
  s.prog = prog;
  s.T_len = T_len;
  s.start = first_step(prog, T_len);
  s.t = forward ? s.start : T_len - 1;
  s.out_tag = TAG_FEAT;
  s.saved_tag = TAG_NONE;
  s.tok = 0;
  s.kind = NOP;
  s.unit = s.units = 0;
  s.forward = forward;
}

// The stream's next matrix: index into wcmp's halves (cmp) or w3's taps;
// false past the last.
__device__ __forceinline__ bool stream_next(TileStream& s, const NmnParams& p, bool& cmp,
                                            int& index) {
  while (s.unit == s.units) {
    if (s.forward ? s.t >= s.T_len : s.t < s.start) return false;
    const int tok = s.prog[s.T_len - 1 - s.t];
    s.tok = tok;
    s.unit = 0;
    if (s.forward) {
      ++s.t;
      const Step st = tag_step(p.kind[tok], p.head_slot[tok] >= 0, s.out_tag, s.saved_tag);
      if (st.invalid) {  // the machine stops at the first invalid op
        s.t = s.T_len;
        return false;
      }
      s.kind = st.do_chain || st.do_cmp ? st.kind : NOP;
      s.units = st.do_chain ? 9 * (st.kind == RELATE ? 5 : 2) : st.do_cmp ? 2 + 9 * 2 : 0;
    } else {
      --s.t;
      s.kind = p.kind[tok];
      s.units = s.kind == RELATE ? 9 * 5 : s.kind == COMPARE ? 2 : 0;
    }
  }
  const int u = s.unit++;
  cmp = s.kind == COMPARE && u < 2;
  if (cmp) {
    index = p.cmp_slot[s.tok] * 2 + u;
  } else {
    const int v = s.kind == COMPARE ? u - 2 : u;
    index = p.slot3[s.tok * kMaxChain + v / 9] * 9 + v % 9;
  }
  return true;
}

struct Ring {
  uint32_t base;         // stage 0, 1024-byte aligned
  uint32_t full, empty;  // barriers: full[s] counts the stage's TMA bytes, empty[s] one arrival a warp
  uint32_t stages;
  uint32_t next;         // matrices consumed so far, the same in every thread
  uint32_t issued;       // thread 0: matrices loaded so far
  TileStream stream;     // thread 0: what comes next
  const CUtensorMap* w3;
  const CUtensorMap* wc;
};

// Thread 0: load the stream's next matrices, up to `stages` ahead of the
// released ones. A stage is loaded again once all eight warps have
// released the matrix it held.
__device__ __forceinline__ void ring_fill(Ring& r, const NmnParams& p) {
  bool cmp;
  int index;
  while (r.issued < r.next + r.stages && stream_next(r.stream, p, cmp, index)) {
    const uint32_t n = r.issued, s = n % r.stages;
    if (n >= r.stages) mbar_wait(r.empty + 8 * s, (n / r.stages - 1) & 1);
    const uint32_t bar = r.full + 8 * s, dst = r.base + s * kTapBytes;
    const CUtensorMap* map = cmp ? r.wc : r.w3;
    mbar_expect_tx(bar, kTapBytes);
    tma_load_3d(dst, map, bar, 0, 0, index);
    tma_load_3d(dst + kTapBytes / 2, map, bar, kMmaC / 2, 0, index);
    ++r.issued;
  }
}

// The warp is done with matrix r.next - 1; thread 0 refills the ring.
__device__ __forceinline__ void ring_release(Ring& r, const NmnParams& p) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * ((r.next - 1) % r.stages));
  if (threadIdx.x == 0) ring_fill(r, p);
  __syncwarp();
}

// Thread 0 starts the ring on an example's stream (every earlier matrix was
// consumed).
__device__ __forceinline__ void ring_begin(Ring& r, const NmnParams& p, const int* prog,
                                           bool forward) {
  if (threadIdx.x == 0) {
    stream_begin(r.stream, prog, p.T, forward);
    ring_fill(r, p);
  }
  __syncwarp();
}

// The sums of conv_simt on wgmma, for the forward's 3x3 convs (taps == 9,
// dilation d, over in0) and compare's projection (taps == 2: in0 against
// wcmp's first half, in1 against its second), C == kMmaC: M = pixels in
// four 64-row tiles, kTiles a warpgroup (warpgroup w owns tiles kTiles w ..,
// 64 float32 accumulators a thread a tile: one tile in K2 / K5's four
// warpgroups, two in K6's two), N = kMmaC output channels, K = taps x
// kMmaC. B is the ring's next stage, one a tap, read by wgmma from shared
// memory; A goes through registers: ldmatrix reads each lane's source row
// of the shared tile (pitch kMmaC + kRowPad: the eight rows of a matrix
// fall in distinct banks), the tile's zero row HW for a pixel outside the
// image or past H * W. A tap's A fragments (its eight k-steps, 64
// registers a thread) are loaded before its 16 products issue, and the
// products are done before the next tap's fragments load: ptxas serialises
// every wgmma whose A registers another instruction writes while products
// are in flight. The two warpgroups alternate on the tensor cores, one
// loading while the other multiplies. A tap's stage is released once its
// products are done.

template <int kTiles, class Epi>
__device__ void conv_wgmma(const bf16* in0, const bf16* in1, int taps, int d, int H, int W,
                           Ring& r, const NmnParams& p, const Epi epi) {
  constexpr int P = kMmaC + kRowPad;
  const int HW = H * W, tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, q = (tid >> 5) & 3;
  // This lane's ldmatrix row in its warp's 16 rows of a tile, and its K half.
  const int row = 16 * q + ((lane >> 3) & 1) * 8 + (lane & 7), k8 = (lane >> 4) * 8;
  float acc[kTiles][64];
#pragma unroll
  for (int m = 0; m < kTiles; ++m)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;
  uint32_t a[kMmaC / 16][kTiles][4];
  for (int tap = 0; tap < taps; ++tap) {
    const bf16* src = taps == 2 && tap == 1 ? in1 : in0;
    const int dy = taps == 9 ? (tap / 3 - 1) * d : 0, dx = taps == 9 ? (tap % 3 - 1) * d : 0;
    uint32_t addr[kTiles];
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
      const int pix = 64 * (kTiles * wg + m) + row, y = pix / W + dy, x = pix % W + dx;
      const bool ok = pix < HW && y >= 0 && y < H && x >= 0 && x < W;
      addr[m] = smem_u32(src + (ok ? y * W + x : HW) * P + k8);
    }
    const uint32_t s = r.next % r.stages;
    mbar_wait(r.full + 8 * s, (r.next / r.stages) & 1);
    __syncwarp();  // wgmma is .aligned: the warp converges after the spin
    const uint64_t db = wgmma_desc(r.base + s * kTapBytes, kTapBytes / 2, 1024);
#pragma unroll
    for (int k = 0; k < kMmaC / 16; ++k)  // 16 channels of the tile row: 32 bytes
#pragma unroll
      for (int m = 0; m < kTiles; ++m) ldsm_x4(a[k][m], addr[m] + 32 * k);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kMmaC / 16; ++k)  // 16 K rows of B: 2048 bytes, 128 units
#pragma unroll
      for (int m = 0; m < kTiles; ++m) wgmma_rs(acc[m], a[k][m], db + 128 * k);
    wgmma_commit();
    wgmma_wait<0>();
    ++r.next;
    ring_release(r, p);
  }
  // The accumulator layout of m64nNk16: warp q holds rows 16 q + lane / 4
  // and + 8 of each tile, columns 8 j + 2 (lane % 4) and + 1.
  const int r0 = 16 * q + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < kTiles; ++m) {
    const int pix = 64 * (kTiles * wg + m) + r0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (pix < HW) epi(pix, 8 * j + c0, acc[m][4 * j], acc[m][4 * j + 1]);
      if (pix + 8 < HW) epi(pix + 8, 8 * j + c0, acc[m][4 * j + 2], acc[m][4 * j + 3]);
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

// dst (shared, pitch P) = relu(conv3x3_d(in) + b3[slot]), and with kResid
// the same to `resid` (global, pitch C). bf16 reads the weights from the
// ring, whose stream holds slot's nine taps next.
template <typename T, bool kMma, bool kResid, int kTiles>
__device__ __forceinline__ void conv3x3(const T* in, T* dst, T* resid, const NmnParams& p,
                                        int slot, int d, int P, Ring& ring) {
  const StoreRelu<T, kResid> epi{dst, P, resid, p.C, p.b3 + static_cast<size_t>(slot) * p.C};
  if constexpr (kMma) {
    conv_wgmma<kTiles>(in, nullptr, 9, d, p.H, p.W, ring, p, epi);
  } else {
    const size_t w_off = static_cast<size_t>(slot) * 9 * p.C * p.C;
    conv_simt<T, false>(in, nullptr, static_cast<const T*>(p.w3) + w_off, 9, d, false, p.H, p.W,
                        p.C, P, epi);
  }
}

// dst (global, pitch C) = relu(concat(a, b) @ wcmp[cs] + bcmp[cs]): compare's
// 1x1 projection; a and b are shared tiles at pitch P. bf16 reads the
// weights from the ring, whose stream holds wcmp[cs]'s two halves next.
template <typename T, bool kMma, int kTiles>
__device__ __forceinline__ void compare_projection(const T* a, const T* b, T* dst,
                                                   const NmnParams& p, int cs, int P, Ring& ring) {
  const StoreRelu<T, false> epi{dst, p.C, nullptr, p.C, p.bcmp + static_cast<size_t>(cs) * p.C};
  if constexpr (kMma) {
    conv_wgmma<kTiles>(a, b, 2, 1, p.H, p.W, ring, p, epi);
  } else {
    const size_t w_off = static_cast<size_t>(cs) * 2 * p.C * p.C;
    conv_simt<T, false>(a, b, static_cast<const T*>(p.wcmp) + w_off, 2, 1, false, p.H, p.W, p.C,
                        P, epi);
  }
}

// HW rows of C elements from src (row pitch sp) to dst (row pitch dp), in
// 16-byte pieces: C * sizeof(T), both pitches and both bases are multiples
// of 16 bytes.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dp, const T* src, int sp, int HW, int C) {
  const int per_row = C * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < HW * per_row; i += blockDim.x) {
    const int row = i / per_row, v = i % per_row;
    reinterpret_cast<uint4*>(dst + static_cast<size_t>(row) * dp)[v] =
        reinterpret_cast<const uint4*>(src + static_cast<size_t>(row) * sp)[v];
  }
}

// The first pixel whose channel 0 holds the largest value of a (HW, C)
// register (the attention `same` gathers at), the same in every thread:
// each thread scans its pixels in order, then the warps and the block keep
// the larger value, a tie going to the smaller pixel; pixel 0 when no value
// exceeds -inf (all NaN), as a scan from pixel 0 would give.
template <typename T>
__device__ __forceinline__ int first_argmax(const T* reg, int HW, int C) {
  __shared__ float s_val[32];
  __shared__ int s_pix[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float best = -INFINITY;
  int best_pix = HW;
  for (int pix = threadIdx.x; pix < HW; pix += blockDim.x) {
    const float v = to_f(reg[static_cast<size_t>(pix) * C]);
    if (v > best) {
      best = v;
      best_pix = pix;
    }
  }
  warp_argmax(best, best_pix);
  if (lane == 0) {
    s_val[warp] = best;
    s_pix[warp] = best_pix;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < nwarps ? s_val[lane] : -INFINITY;
    best_pix = lane < nwarps ? s_pix[lane] : HW;
    warp_argmax(best, best_pix);
    if (lane == 0) s_pix[0] = best_pix;
  }
  __syncthreads();
  const int am = s_pix[0];
  __syncthreads();  // every thread has read it before the next call writes
  return am < HW ? am : 0;
}

// tile (pitch P) = x * out rounded to T, over HW rows of C elements, in
// 16-byte pieces (the chain's input: the features under the attention).
template <typename T>
__device__ __forceinline__ void mul_rows(T* tile, int P, const T* x, const T* out, int HW, int C) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = C / V;
  for (int i = threadIdx.x; i < HW * per_row; i += blockDim.x) {
    const int row = i / per_row, v = i % per_row;
    const uint4 xa = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * C)[v];
    const uint4 oa = reinterpret_cast<const uint4*>(out + static_cast<size_t>(row) * C)[v];
    const T* xv = reinterpret_cast<const T*>(&xa);
    const T* ov = reinterpret_cast<const T*>(&oa);
    uint4 r;
    T* rv = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int j = 0; j < V; ++j) rv[j] = from_f<T>(to_f(xv[j]) * to_f(ov[j]));
    reinterpret_cast<uint4*>(tile + row * P)[v] = r;
  }
}

// ---------------------------------------------------------------- K2 / K5 / K6's replay
// One example's program (stem features x, tokens prog) on the forward's
// device code, which K2, K5 and K6's replay phase all run. The out and saved
// registers live at `out` and `saved` (N elements each); with kTrain the out
// register at the entry of every executed step goes to otraj (T, N) and the
// two-conv outputs to atraj (T, 2, N), each copied in 16-byte pieces (the
// conv outputs from the shared tile that holds them, after the conv's
// barrier). buf_a and buf_b are the block's shared tiles; kTiles is the
// conv core's 64-pixel tiles a warpgroup, which the block's threads set.
// Returns whether the program is invalid (an invalid op, or a final register
// that is not a feature map); `out` then holds what the machine stopped at,
// which the caller zeroes.
template <typename T, bool kMma, bool kTrain, int kTiles>
__device__ __forceinline__ bool interpret_example(const NmnParams& p, const int* prog,
                                                  const T* x, T* out, T* saved, T* otraj,
                                                  T* atraj, T* buf_a, T* buf_b,
                                                  Ring& ring) {
  const int H = p.H, W = p.W, C = p.C, HW = H * W, N = HW * C, T_len = p.T, P = C + kRowPad;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const T* w1 = static_cast<const T*>(p.w1);
  const T* same_wf = static_cast<const T*>(p.same_wf);
  const T zero = from_f<T>(0.f), one = from_f<T>(1.f);

  if constexpr (kMma) ring_begin(ring, p, prog, true);
  for (int c = tid; c < C; c += nthreads) {
    buf_a[HW * P + c] = zero;
    buf_b[HW * P + c] = zero;
  }
  copy_rows(out, C, x, C, HW, C);
  for (int i = tid; i < N * static_cast<int>(sizeof(T)) / 16; i += nthreads)
    reinterpret_cast<uint4*>(saved)[i] = make_uint4(0, 0, 0, 0);
  // Reversed prefix order: the last token runs first; the reversed order's
  // leading pads are no-ops and are skipped.
  const int start = first_step(prog, T_len);
  int out_tag = TAG_FEAT, saved_tag = TAG_NONE;
  bool invalid = false;
  __syncthreads();

  for (int t = start; t < T_len && !invalid; ++t) {
    const int tok = prog[T_len - 1 - t];
    const int hs = p.head_slot[tok];
    const Step st = tag_step(p.kind[tok], hs >= 0, out_tag, saved_tag);
    const int kind = st.kind;
    invalid = st.invalid;
    // K5: the out register at the step's entry. The copy's 16-byte pieces
    // are not the elements a thread updates below, so scene and and/or,
    // which write the register before any barrier, wait for it.
    T* resid = nullptr;
    if constexpr (kTrain) {
      copy_rows(otraj + static_cast<size_t>(t) * N, C, out, C, HW, C);
      if (st.scene_ok || st.binop_ok) __syncthreads();
      resid = atraj + static_cast<size_t>(t) * 2 * N;
    }

    // Registers in 16-byte pieces of V elements.
    constexpr int V = 16 / sizeof(T);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    uint4* saved4 = reinterpret_cast<uint4*>(saved);
    if (st.scene_ok) {  // save the output, reset it to an all-ones attention
      uint4 ones;
#pragma unroll
      for (int j = 0; j < V; ++j) reinterpret_cast<T*>(&ones)[j] = one;
      for (int i = tid; i < N / V; i += nthreads) {
        saved4[i] = out4[i];
        out4[i] = ones;
      }
    } else if (st.binop_ok) {  // intersect / union
      for (int i = tid; i < N / V; i += nthreads) {
        const uint4 oa = out4[i], sa = saved4[i];
        uint4 r;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float o = to_f(reinterpret_cast<const T*>(&oa)[j]);
          const float s = to_f(reinterpret_cast<const T*>(&sa)[j]);
          reinterpret_cast<T*>(&r)[j] = from_f<T>(kind == AND ? fminf(o, s) : fmaxf(o, s));
        }
        out4[i] = r;
      }
    } else if (st.do_chain) {
      mul_rows(buf_a, P, x, out, HW, C);
      __syncthreads();
      const bool relate = kind == RELATE;
      const int layers = relate ? 5 : 2;
      T* src = buf_a;
      T* dst = buf_b;
      for (int l = 0; l < layers; ++l) {
        const int d = relate ? (l == 4 ? 1 : 1 << l) : 1;
        conv3x3<T, kMma, false, kTiles>(src, dst, nullptr, p, p.slot3[tok * kMaxChain + l], d, P,
                                        ring);
        __syncthreads();
        if (kTrain && !relate) copy_rows(resid + static_cast<size_t>(l) * N, C, dst, P, HW, C);
        T* tmp = src;
        src = dst;
        dst = tmp;
      }
      if (hs >= 0) {
        head_to_out<T>(src, P, out, w1 + static_cast<size_t>(hs) * C, p.b1[hs], HW, C);
      } else {
        copy_rows(out, C, src, P, HW, C);
      }
    } else if (st.do_cmp) {
      copy_rows(buf_a, P, out, C, HW, C);
      copy_rows(buf_b, P, saved, C, HW, C);
      __syncthreads();
      compare_projection<T, kMma, kTiles>(buf_a, buf_b, out, p, p.cmp_slot[tok], P, ring);
      __syncthreads();
      copy_rows(buf_a, P, out, C, HW, C);
      __syncthreads();
      conv3x3<T, kMma, false, kTiles>(buf_a, buf_b, nullptr, p, p.slot3[tok * kMaxChain], 1, P,
                                      ring);
      __syncthreads();
      if (kTrain) copy_rows(resid, C, buf_b, P, HW, C);
      conv3x3<T, kMma, false, kTiles>(buf_b, buf_a, nullptr, p, p.slot3[tok * kMaxChain + 1], 1,
                                      P, ring);
      __syncthreads();
      if (kTrain) copy_rows(resid + N, C, buf_a, P, HW, C);
      copy_rows(out, C, buf_a, P, HW, C);
    } else if (st.do_same) {
      const int ss = p.same_slot[tok];
      const T* vec = x + static_cast<size_t>(first_argmax(out, HW, C)) * C;
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
  return invalid || out_tag != TAG_FEAT;
}

// The kernels' dynamic shared memory: in bf16 the ring's stages first
// (1024-byte aligned, for the swizzle), thread 0 initialising their
// barriers; then the two tiles. Returns the first tile.
template <typename T, bool kMma>
__device__ __forceinline__ T* smem_setup(Ring& r, const NmnParams& p, unsigned char* raw,
                                         uint64_t* bars, const CUtensorMap* w3,
                                         const CUtensorMap* wc) {
  if constexpr (!kMma) {
    return reinterpret_cast<T*>(raw);
  } else {
    const uint32_t start = smem_u32(raw), base = (start + 1023) & ~1023u;
    r.base = base;
    r.full = smem_u32(bars);
    r.empty = r.full + 8 * kMaxStages;
    r.stages = p.stages;
    r.next = r.issued = 0;
    r.w3 = w3;
    r.wc = wc;
    if (threadIdx.x == 0) {
      for (int s = 0; s < p.stages; ++s) {
        mbar_init(r.full + 8 * s, 1);
        mbar_init(r.empty + 8 * s, blockDim.x / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    return reinterpret_cast<T*>(raw + (base - start) + p.stages * kTapBytes);
  }
}

// The block's next example, in p.order, from the shared counter; -1 when
// none is left.
__device__ __forceinline__ int next_example(const NmnParams& p, int& s_example) {
  if (threadIdx.x == 0) s_example = atomicAdd(p.next, 1);
  __syncthreads();
  const int i = s_example;
  __syncthreads();  // every thread has read it before thread 0 writes the next
  return i < p.batch ? p.order[i] : -1;
}

// K2 / K5: a persistent grid of one block an SM takes the examples in
// p.order (longest program first), each block one at a time. An example's
// results go to its own rows, so the order moves no bit. bf16 blocks run
// kFwdThreads threads, a 64-pixel tile a warpgroup, so that while one
// warpgroup loads a tap's A the others keep the tensor cores busy.
template <typename T, bool kMma, bool kTrain>
__global__ void __launch_bounds__(kMma ? kFwdThreads : kThreads)
    nmn_interpreter_kernel(const NmnParams p, const __grid_constant__ CUtensorMap map_w3,
                           const __grid_constant__ CUtensorMap map_wc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  __shared__ int s_example;
  const int HW = p.H * p.W, N = HW * p.C, T_len = p.T, P = p.C + kRowPad, tid = threadIdx.x;
  Ring ring;
  T* buf_a = smem_setup<T, kMma>(ring, p, smem_raw, bars, &map_w3, &map_wc);
  T* buf_b = buf_a + static_cast<size_t>(HW + 1) * P;
  for (int b; (b = next_example(p, s_example)) >= 0;) {
    T* out = static_cast<T*>(p.out) + static_cast<size_t>(b) * N;
    T* otraj = nullptr;
    T* atraj = nullptr;
    if constexpr (kTrain) {
      otraj = static_cast<T*>(p.otraj) + static_cast<size_t>(b) * T_len * N;
      atraj = static_cast<T*>(p.atraj) + static_cast<size_t>(b) * T_len * 2 * N;
    }
    const bool invalid = interpret_example<T, kMma, kTrain, kFwdTiles>(
        p, p.programs + static_cast<size_t>(b) * T_len,
        static_cast<const T*>(p.x) + static_cast<size_t>(b) * N, out,
        static_cast<T*>(p.saved) + static_cast<size_t>(b) * N, otraj, atraj, buf_a, buf_b,
        ring);
    if (invalid)
      for (int e = tid; e < N; e += blockDim.x) out[e] = from_f<T>(0.f);
    if (tid == 0) p.invalid[b] = invalid ? 1 : 0;
  }
}

// The plan of the persistent kernels: convs[b] = the 3x3 convs example b's
// program runs (the tag machine walked one thread a row up to its first
// invalid op); the wrapper sorts the examples by it, longest first.
__global__ void nmn_plan_kernel(const int* programs, int batch, int T_len, const int* kind,
                                const int* head_slot, int* convs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int* prog = programs + static_cast<size_t>(b) * T_len;
  int out_tag = TAG_FEAT, saved_tag = TAG_NONE, n = 0;
  for (int t = first_step(prog, T_len); t < T_len; ++t) {
    const int tok = prog[T_len - 1 - t];
    const Step st = tag_step(kind[tok], head_slot[tok] >= 0, out_tag, saved_tag);
    if (st.invalid) break;
    n += st.do_chain ? (st.kind == RELATE ? 5 : 2) : st.do_cmp ? 2 : 0;
  }
  convs[b] = n;
}

// ---------------------------------------------------------------- K6
struct BwdParams {
  NmnParams f;          // the forward's operands (out / saved / otraj unused)
  const int* invalid;   // (B,) the forward's flags
  const float* gfin;    // (B, HW, C) cotangent of the final encoding
  const void* otraj;    // K5's residuals (no-replay mode)
  const void* atraj;
  void* traj;           // replay mode: (G, T, 3, HW, C), each block's residuals
  float* scratch;       // (G, 4, HW, C): g_a, g_out, g_saved, dx_acc (G = grid)
  void* acts;           // (G, 6, HW, C): chain activations of the step
  void* ent_inp;        // (E, HW, C) conv inputs, compute type
  void* ent_g;          // (E, HW, C) their g_z, compute type
  int* ent_tag;         // (E,) weight-gradient target of each entry
  int* ent_dil;         // (E,) dilation of a 3x3 entry, 0 for a 1x1
  const int* ent_base;  // (B,) first entry of each example
  float* part;          // (B, R) per-example partials of the small banks
  int S3, S1, Ss, Sc;
  float* dx;            // (B, HW, C)
};

// Offsets of the small banks in a row of BwdParams::part.
struct PartLayout {
  int db3, dw1, db1, dwf, dwa, dsb, dbc, size;
  __host__ __device__ PartLayout(int S3, int S1, int Ss, int Sc, int C) {
    db3 = 0;
    dw1 = db3 + S3 * C;
    db1 = dw1 + S1 * C;
    dwf = db1 + S1;
    dwa = dwf + Ss * C;
    dsb = dwa + Ss;
    dbc = dsb + Ss;
    size = dbc + Sc * C;
  }
};

template <typename T, bool kMma>
__device__ __forceinline__ void conv_input_grad(const T* tile, float* dst, const T* w, int taps,
                                                int d, int H, int W, int C, int P) {
  const StoreF32<false> epi{dst, C};
  if constexpr (kMma) {
    conv_mma(tile, w, taps, d, H, W, epi);
  } else {
    conv_simt<T, true>(tile, nullptr, w, taps, d, true, H, W, C, P, epi);
  }
}

// The reverse sweep over valid example b's steps, reading the out register
// at each step's entry from otraj (T, N) and the two-conv outputs from atraj
// (T, 2, N); ga (4 N floats) and acts (6 N) are the block's scratch. It
// recomputes relate's chains and compare's projections on the forward's
// conv code (bf16: the wgmma core, the ring streaming their weights).
template <typename T, bool kMma>
__device__ __forceinline__ void sweep_example(const BwdParams& q, int b, float* ga, T* acts,
                                              const T* otraj, const T* atraj, T* buf_a, T* buf_b,
                                              float* s_h, Ring& ring) {
  const NmnParams& p = q.f;
  const int H = p.H, W = p.W, C = p.C, HW = H * W, N = HW * C, T_len = p.T, P = C + kRowPad;
  const PartLayout lay(q.S3, q.S1, q.Ss, q.Sc, C);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const T* x = static_cast<const T*>(p.x) + static_cast<size_t>(b) * N;
  float* dx = q.dx + static_cast<size_t>(b) * N;
  float* gout = ga + N;
  float* gsaved = ga + 2 * N;
  float* dxacc = ga + 3 * N;
  T* ent_inp = static_cast<T*>(q.ent_inp);
  T* ent_g = static_cast<T*>(q.ent_g);
  float* part = q.part + static_cast<size_t>(b) * lay.size;
  const T* w1 = static_cast<const T*>(p.w1);
  const int* prog = p.programs + static_cast<size_t>(b) * T_len;
  const T zero = from_f<T>(0.f);
  int entry = q.ent_base[b];

  if constexpr (kMma) ring_begin(ring, p, prog, false);
  for (int c = tid; c < C; c += nthreads) {
    buf_a[HW * P + c] = zero;
    buf_b[HW * P + c] = zero;
  }
  const float* gfin = q.gfin + static_cast<size_t>(b) * N;
  for (int e = tid; e < N; e += nthreads) {
    gout[e] = gfin[e];
    gsaved[e] = 0.f;
    dxacc[e] = 0.f;
  }
  const int start = first_step(prog, T_len);
  __syncthreads();

  // Backward of relu(conv3x3_d(inp)) for bank slot `slot`, from g_a (in ga)
  // to the gradient of inp (into ga): g_z = g_a * (outp > 0) is rounded to
  // the compute type before both products, as the JAX kernel does. The
  // (inp, g_z) pair goes to the workspace for nmn_weight_grad_kernel, the
  // bias gradient to the example's partials.
  auto conv_layer_bwd = [&](const T* inp, const T* outp, int slot, int d) {
    T* eg = ent_g + static_cast<size_t>(entry) * N;
    T* ei = ent_inp + static_cast<size_t>(entry) * N;
    for (int e = tid; e < N; e += nthreads) {
      const T gz = from_f<T>(to_f(outp[e]) > 0.f ? ga[e] : 0.f);
      buf_a[(e / C) * P + e % C] = gz;
      eg[e] = gz;
      ei[e] = inp[e];
    }
    float* db3 = part + lay.db3 + static_cast<size_t>(slot) * C;
    for (int c = tid; c < C; c += nthreads) {
      float s = 0.f;
      for (int pix = 0; pix < HW; ++pix)
        s += to_f(outp[pix * C + c]) > 0.f ? ga[pix * C + c] : 0.f;
      db3[c] += s;
    }
    if (tid == 0) {
      q.ent_tag[entry] = slot;
      q.ent_dil[entry] = d;
    }
    ++entry;
    __syncthreads();
    conv_input_grad<T, kMma>(buf_a, ga, static_cast<const T*>(p.w3) + static_cast<size_t>(slot) * 9 * C * C,
                             9, d, H, W, C, P);
    __syncthreads();
  };

  // Backward of the sigmoid 1x1 head (slot hs) over a_last, broadcast over
  // the channels: g_a = round(g_h0) * w1[hs].
  auto head_bwd = [&](const T* a_last, int hs) {
    const T* w = w1 + static_cast<size_t>(hs) * C;
    const float bias = p.b1[hs];
    for (int pix = warp; pix < HW; pix += nwarps) {
      float s = 0.f, g = 0.f;
      for (int c = lane; c < C; c += 32) {
        s = fmaf(to_f(a_last[pix * C + c]), to_f(w[c]), s);
        g += gout[pix * C + c];
      }
      s = warp_sum(s);
      g = warp_sum(g);
      const float attn = sigmoid(s + bias);
      if (lane == 0) s_h[pix] = g * attn * (1.f - attn);
    }
    __syncthreads();
    for (int c = tid; c < C; c += nthreads) {
      float s = 0.f;
      for (int pix = 0; pix < HW; ++pix) s += to_f(a_last[pix * C + c]) * rnd<T>(s_h[pix]);
      part[lay.dw1 + hs * C + c] += s;
    }
    if (tid == 0) {
      float s = 0.f;
      for (int pix = 0; pix < HW; ++pix) s += s_h[pix];
      part[lay.db1 + hs] += s;
    }
    for (int e = tid; e < N; e += nthreads) ga[e] = rnd<T>(s_h[e / C]) * to_f(w[e % C]);
    __syncthreads();
  };

  for (int t = T_len - 1; t >= start; --t) {
    const int tok = prog[T_len - 1 - t];
    const int kind = p.kind[tok];
    const T* out_in = otraj + static_cast<size_t>(t) * N;
    // The saved register at step t is the entry value of the last scene step
    // before t (the only steps that write it).
    int ls = -1;
    for (int s = t - 1; s >= start; --s)
      if (p.kind[prog[T_len - 1 - s]] == SCENE) {
        ls = s;
        break;
      }
    const T* saved_in = ls >= 0 ? otraj + static_cast<size_t>(ls) * N : nullptr;

    if (kind == SCENE) {
      for (int e = tid; e < N; e += nthreads) {
        gout[e] = gsaved[e];
        gsaved[e] = 0.f;
      }
    } else if (kind == AND || kind == OR) {
      // min / max subgradient, a tie split 0.5 / 0.5 (as torch.minimum).
      for (int e = tid; e < N; e += nthreads) {
        const float a = to_f(out_in[e]), c = saved_in ? to_f(saved_in[e]) : 0.f;
        const float w = (kind == AND ? (a < c ? 1.f : 0.f) : (a > c ? 1.f : 0.f)) + (a == c ? 0.5f : 0.f);
        const float go = gout[e];
        gout[e] = go * w;
        gsaved[e] = go * (1.f - w) + gsaved[e];
      }
    } else if (kind == ATTENTION || kind == QUERY || kind == RELATE) {
      const bool relate = kind == RELATE;
      const int layers = relate ? 5 : 2;
      const int hs = p.head_slot[tok];
      const T* act[kMaxChain + 1];
      for (int e = tid; e < N; e += nthreads) {
        const T v = from_f<T>(to_f(x[e]) * to_f(out_in[e]));
        acts[e] = v;
        if (relate) buf_a[(e / C) * P + e % C] = v;
      }
      act[0] = acts;
      if (relate) {  // recompute the chain from its entry register
        __syncthreads();
        T* src = buf_a;
        T* dst = buf_b;
        for (int l = 0; l < 5; ++l) {
          const int d = l == 4 ? 1 : 1 << l;
          conv3x3<T, kMma, true, 2>(src, dst, acts + static_cast<size_t>(l + 1) * N, p,
                                    p.slot3[tok * kMaxChain + l], d, P, ring);
          __syncthreads();
          T* tmp = src;
          src = dst;
          dst = tmp;
          act[l + 1] = acts + static_cast<size_t>(l + 1) * N;
        }
      } else {
        act[1] = atraj + static_cast<size_t>(t) * 2 * N;
        act[2] = act[1] + N;
      }
      __syncthreads();
      if (hs >= 0) {
        head_bwd(act[layers], hs);
      } else {
        for (int e = tid; e < N; e += nthreads) ga[e] = gout[e];
        __syncthreads();
      }
      for (int l = layers - 1; l >= 0; --l) {
        const int d = relate ? (l == 4 ? 1 : 1 << l) : 1;
        conv_layer_bwd(act[l], act[l + 1], p.slot3[tok * kMaxChain + l], d);
      }
      for (int e = tid; e < N; e += nthreads) {
        const float g = ga[e];
        dxacc[e] += g * to_f(out_in[e]);
        gout[e] = g * to_f(x[e]);
      }
    } else if (kind == COMPARE) {
      const int cs = p.cmp_slot[tok];
      copy_rows(buf_a, P, out_in, C, HW, C);
      if (saved_in) {
        copy_rows(buf_b, P, saved_in, C, HW, C);
      } else {
        for (int e = tid; e < N; e += nthreads) buf_b[(e / C) * P + e % C] = zero;
      }
      __syncthreads();
      compare_projection<T, kMma, 2>(buf_a, buf_b, acts, p, cs, P, ring);  // acts[0], recomputed
      const T* act1 = atraj + static_cast<size_t>(t) * 2 * N;
      for (int e = tid; e < N; e += nthreads) ga[e] = gout[e];
      __syncthreads();
      conv_layer_bwd(act1, act1 + N, p.slot3[tok * kMaxChain + 1], 1);
      conv_layer_bwd(acts, act1, p.slot3[tok * kMaxChain], 1);
      // g_pre = g_a * (acts[0] > 0): the projection's bias gradient, then its
      // two weight halves as workspace entries over out_in and saved_in.
      float* dbc = part + lay.dbc + static_cast<size_t>(cs) * C;
      for (int c = tid; c < C; c += nthreads) {
        float s = 0.f;
        for (int pix = 0; pix < HW; ++pix) s += to_f(acts[pix * C + c]) > 0.f ? ga[pix * C + c] : 0.f;
        dbc[c] += s;
      }
      T* eg0 = ent_g + static_cast<size_t>(entry) * N;
      T* ei0 = ent_inp + static_cast<size_t>(entry) * N;
      for (int e = tid; e < N; e += nthreads) {
        const T gp = from_f<T>(to_f(acts[e]) > 0.f ? ga[e] : 0.f);
        buf_a[(e / C) * P + e % C] = gp;
        eg0[e] = gp;
        eg0[N + e] = gp;
        ei0[e] = out_in[e];
        ei0[N + e] = saved_in ? saved_in[e] : zero;
      }
      if (tid == 0) {
        q.ent_tag[entry] = q.S3 + 2 * cs;
        q.ent_tag[entry + 1] = q.S3 + 2 * cs + 1;
        q.ent_dil[entry] = q.ent_dil[entry + 1] = 0;
      }
      entry += 2;
      __syncthreads();
      const T* wc = static_cast<const T*>(p.wcmp) + static_cast<size_t>(cs) * 2 * C * C;
      conv_input_grad<T, kMma>(buf_a, gout, wc, 1, 1, H, W, C, P);
      if constexpr (kMma) {
        conv_mma(buf_a, wc + C * C, 1, 1, H, W, StoreF32<true>{gsaved, C});
      } else {
        conv_simt<T, true>(buf_a, nullptr, wc + C * C, 1, 1, true, H, W, C, P,
                           StoreF32<true>{gsaved, C});
      }
    } else if (kind == SAME) {
      const int ss = p.same_slot[tok], am = first_argmax(out_in, HW, C);
      const T* vec = x + static_cast<size_t>(am) * C;
      const T* wf = static_cast<const T*>(p.same_wf) + static_cast<size_t>(ss) * C;
      const float wa = p.same_wa[ss], bias = p.same_b[ss];
      for (int pix = warp; pix < HW; pix += nwarps) {
        float s = 0.f, g = 0.f;
        for (int c = lane; c < C; c += 32) {
          s = fmaf(rnd<T>(to_f(x[pix * C + c]) * to_f(vec[c])), to_f(wf[c]), s);
          g += gout[pix * C + c];
        }
        s = warp_sum(s);
        g = warp_sum(g);
        const float attn = sigmoid(s + to_f(out_in[pix * C]) * wa + bias);
        if (lane == 0) s_h[pix] = g * attn * (1.f - attn);
      }
      __syncthreads();
      for (int c = tid; c < C; c += nthreads) {
        const float v = to_f(vec[c]), wfc = to_f(wf[c]);
        float dwf = 0.f, gvec = 0.f;
        for (int pix = 0; pix < HW; ++pix) {
          const float xv = to_f(x[pix * C + c]), gh = rnd<T>(s_h[pix]);
          dwf += rnd<T>(xv * v) * gh;
          const float gx = gh * wfc;
          dxacc[pix * C + c] += gx * v;
          gvec += xv * gx;
        }
        dxacc[am * C + c] += gvec;
        part[lay.dwf + ss * C + c] += dwf;
      }
      if (tid == 0) {
        float dwa = 0.f, dsb = 0.f;
        for (int pix = 0; pix < HW; ++pix) {
          dwa += to_f(out_in[pix * C]) * s_h[pix];
          dsb += s_h[pix];
        }
        part[lay.dwa + ss] += dwa;
        part[lay.dsb + ss] += dsb;
      }
      for (int e = tid; e < N; e += nthreads) gout[e] = e % C == 0 ? s_h[e / C] * wa : 0.f;
    }
    __syncthreads();
  }
  // The initial out register was the stem features themselves.
  for (int e = tid; e < N; e += nthreads) dx[e] = dxacc[e] + gout[e];
}

// K6: a persistent grid of one block an SM takes the examples in p.order
// (longest program first), as K2 does; block j works in slice j of the
// scratch. Without kReplay it reads K5's residuals; with kReplay each
// example's program first re-runs on the forward's own device code
// (interpret_example with K5's stores) into the block's slice of q.traj,
// (T, 3, N): the out register at each step's entry, then the two-conv
// outputs; its out and saved registers borrow acts[0] and acts[1]. The
// sweep then reads that slice where it reads K5's residuals otherwise, so
// the two modes compute the same bits.
template <typename T, bool kMma, bool kReplay>
__global__ void __launch_bounds__(kThreads)
    nmn_backward_kernel(const BwdParams q, const __grid_constant__ CUtensorMap map_w3,
                        const __grid_constant__ CUtensorMap map_wc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  __shared__ float s_h[kMaxHW];
  __shared__ int s_example;
  const NmnParams& p = q.f;
  const int HW = p.H * p.W, N = HW * p.C, T_len = p.T, P = p.C + kRowPad;
  Ring ring;
  T* buf_a = smem_setup<T, kMma>(ring, p, smem_raw, bars, &map_w3, &map_wc);
  T* buf_b = buf_a + static_cast<size_t>(HW + 1) * P;
  const size_t slot = blockIdx.x;
  float* ga = q.scratch + slot * 4 * N;
  T* acts = static_cast<T*>(q.acts) + slot * 6 * N;
  for (int b; (b = next_example(p, s_example)) >= 0;) {
    if (q.invalid[b]) {  // the forward zeroed the output: every gradient is 0
      float* dx = q.dx + static_cast<size_t>(b) * N;
      for (int e = threadIdx.x; e < N; e += blockDim.x) dx[e] = 0.f;
      continue;
    }
    const T* otraj;
    const T* atraj;
    if constexpr (kReplay) {
      T* traj = static_cast<T*>(q.traj) + slot * T_len * 3 * N;
      interpret_example<T, kMma, true, 2>(p, p.programs + static_cast<size_t>(b) * T_len,
                                       static_cast<const T*>(p.x) + static_cast<size_t>(b) * N,
                                       acts, acts + N, traj, traj + static_cast<size_t>(T_len) * N,
                                       buf_a, buf_b, ring);
      __syncthreads();
      otraj = traj;
      atraj = traj + static_cast<size_t>(T_len) * N;
    } else {
      otraj = static_cast<const T*>(q.otraj) + static_cast<size_t>(b) * T_len * N;
      atraj = static_cast<const T*>(q.atraj) + static_cast<size_t>(b) * T_len * 2 * N;
    }
    sweep_example<T, kMma>(q, b, ga, acts, otraj, atraj, buf_a, buf_b, s_h, ring);
  }
}

// ---------------------------------------------------------------- K6: weight gradients
// dw3[t][tap] (C_in, C_out) = sum over the entries of 3x3 target t of
// shift_tap(inp)^T . g_z, and dwc[k][half] likewise over compare's 1x1
// entries (target S3 + 2k + half, one tap, no shift). The JAX kernel
// (probnmn_tpu/ops/pallas/nmn_interpreter.py::_interpreter_bwd_kernel) adds
// each entry into a VMEM-resident bank across its sequential grid; blocks
// here run in parallel, so the sum is split in two fixed-order passes.
// Bound on an H100: operations, 2 * H*W * C * C a tap of an entry (57.8
// MFLOP a 3x3 entry at C = 128 on 14 x 14) against 100 KB of the entry read
// once; the chunk kernel reads an entry once a tap, from L2.
//
// 1. Work items of (target, tap, chunk): each target's entries, in the
//    (example, step) order `order` lists them, are cut into chunks of
//    `chunk` consecutive entries (a function of the workspace's size alone,
//    never of the card), and block 9 j + tap sums chunk j's entries for one
//    tap in entry order into a float32 (C_in, C_out) tile: the target's own
//    tile when the chunk is its only one, else partial slot chunk_slot[j].
//    The nine taps of a chunk are neighbouring blocks, so they run together
//    and read the chunk's entries from L2 at about the same time.
// 2. nmn_weight_grad_reduce sums each several-chunk target's partials in
//    chunk order and writes 0 to each target without entries.
//
// No float atomics: the result repeats bit for bit, and it does not depend
// on the SM count. The work list is built on the card from the entries' tags
// (ops/kernels/nmn_interpreter.py::weight_grad_plan).
struct GradParams {
  const void* ent_inp;       // (E, HW, C) conv inputs
  const void* ent_g;         // (E, HW, C) their g_z
  const int* ent_dil;        // (E,) dilation, 0 for a 1x1 entry
  const int* order;          // entries grouped by target, (example, step) order within
  const int* chunk_target;   // (J,) target of chunk j; S3 + 2 Sc past the last chunk
  const int* chunk_first;    // (J,) its first position in order
  const int* chunk_count;    // (J,) its entries
  const int* chunk_slot;     // (J,) its partial slot, or -1: the target's only chunk
  const int* target_chunks;  // (S3 + 2 Sc,) chunks of each target
  const int* target_slot;    // (S3 + 2 Sc,) partial slot of each target's first chunk
  int S3, Sc;
  float* dw3;                // (S3, 9, C, C)
  float* dwc;                // (Sc, 2, C, C)
  float* partial;            // (P, 9, C, C)
  int H, W, C;
};

// Block blockIdx.x's item: chunk blockIdx.x / 9, tap blockIdx.x % 9. A block
// past the last chunk, or at a tap a 1x1 target does not have, is not live.
struct GradItem {
  int target, tap, taps, first, count;
  float* out;
  bool live;
  __device__ GradItem(const GradParams& g) {
    const int j = blockIdx.x / 9;
    tap = blockIdx.x % 9;
    target = g.chunk_target[j];
    taps = target < g.S3 ? 9 : 1;
    live = target < g.S3 + 2 * g.Sc && tap < taps;
    first = count = 0;
    out = nullptr;
    if (!live) return;
    first = g.chunk_first[j];
    count = g.chunk_count[j];
    const size_t cc = static_cast<size_t>(g.C) * g.C;
    const int slot = g.chunk_slot[j];
    if (slot >= 0) out = g.partial + (static_cast<size_t>(slot) * 9 + tap) * cc;
    else if (target < g.S3) out = g.dw3 + (static_cast<size_t>(target) * 9 + tap) * cc;
    else out = g.dwc + static_cast<size_t>(target - g.S3) * cc;
  }
};

// Source pixel of output pixel `pix` for tap `tap` at dilation d, or -1.
__device__ __forceinline__ int tap_source(int pix, int tap, int taps, int d, int H, int W) {
  if (taps == 1) return pix;
  const int y = pix / W + (tap / 3 - 1) * d, x = pix % W + (tap % 3 - 1) * d;
  return (y >= 0 && y < H && x >= 0 && x < W) ? y * W + x : -1;
}

// SIMT (float32): each thread owns an 8 x 8 block of (C_in, C_out) and sums
// its item's entries with float32 FMAs; pixels are staged kGradChunk at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads) nmn_weight_grad_simt(const GradParams g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GradItem it(g);
  if (!it.live) return;
  const int C = g.C, HW = g.H * g.W, N = HW * C, tid = threadIdx.x;
  float* s_in = reinterpret_cast<float*>(smem_raw);
  float* s_g = s_in + kGradChunk * C;
  const int groups = C / 8, ntile = groups * groups;
  for (int round = 0; round * kThreads < ntile; ++round) {
    const int tile = round * kThreads + tid;
    const bool active = tile < ntile;
    const int ci0 = (tile / groups) * 8, co0 = (tile % groups) * 8;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < it.count; ++k) {
      const int e = g.order[it.first + k];
      const int d = g.ent_dil[e];
      const T* inp = static_cast<const T*>(g.ent_inp) + static_cast<size_t>(e) * N;
      const T* gz = static_cast<const T*>(g.ent_g) + static_cast<size_t>(e) * N;
      for (int p0 = 0; p0 < HW; p0 += kGradChunk) {
        const int np = min(kGradChunk, HW - p0);
        __syncthreads();
        for (int idx = tid; idx < np * C; idx += blockDim.x) {
          const int pp = idx / C, c = idx % C;
          const int src = tap_source(p0 + pp, it.tap, it.taps, d, g.H, g.W);
          s_in[idx] = src >= 0 ? to_f(inp[src * C + c]) : 0.f;
          s_g[idx] = to_f(gz[(p0 + pp) * C + c]);
        }
        __syncthreads();
        if (active) {
          for (int pp = 0; pp < np; ++pp) {
            float a[8], bv[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              a[i] = s_in[pp * C + ci0 + i];
              bv[i] = s_g[pp * C + co0 + i];
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
          }
        }
      }
    }
    if (active)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) it.out[(ci0 + i) * C + co0 + j] = acc[i][j];
  }
}

// Tensor cores (bf16, C == 128, H * W <= 224): one item a block, two
// warpgroups, warpgroup w owning C_in rows 64 w .. 64 w + 63 of the
// (C_in, C_out) tile as 64 float32 accumulators a thread (m64n128k16,
// M = C_in, N = C_out, K = pixels). Thread 0 stages each entry by TMA into a
// ring of two stages, one entry ahead of the products: in each stage four
// boxes of (H, W, 64 channels) at 128 bytes a pixel row, 128-byte swizzled,
// the input's two channel halves placed at the tap's shift (dy, dx) so that
// TMA's zero fill of out-of-range rows and columns (negative starts
// included) is the conv's zero padding, then g_z's two halves unshifted.
// Both operands lie pixel-major, which is the MN-major (transposed) layout
// `wgmma` takes from shared memory for 16-bit types, so neither is
// transposed or touched by a thread; the rows from H * W up to the next
// multiple of 16 (the K step) are zeroed once per stage buffer. g_z is
// staged once per entry for the block's one tap: a block holding more taps
// would need 64 more accumulators a thread for each, and a tap's input box
// takes 53 KB of the 227 KB a block may use, so the reuse across taps is
// left to L2 (the nine taps of a chunk run side by side).
//
// wgmma over mma.sync with ldmatrix.trans: wgmma reads both operands from
// shared memory asynchronously, issues 64 x 128 x 16 per warpgroup per
// instruction, and needs no fragment registers.
constexpr int kWgStages = 2;
constexpr int kWgBox = 64;  // channels in a TMA box: one 128-byte swizzle row

// d (64 x 128, float32) += A (64 x 16, bf16) . B (16 x 128, bf16), both
// operands MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(2 * 128, 1)
    nmn_weight_grad_tma(const GradParams g, const __grid_constant__ CUtensorMap map_inp,
                        const __grid_constant__ CUtensorMap map_g) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kWgStages];
  const GradItem it(g);
  if (!it.live) return;
  const int HW = g.H * g.W, kp = (HW + 15) / 16 * 16, tid = threadIdx.x, wg = tid >> 7;
  const uint32_t tile = static_cast<uint32_t>(kp) * 128;  // one box: kp rows of 128 bytes
  const uint32_t stage_bytes = 4 * tile;                  // input halves 0, 1; g_z halves 0, 1
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles start on 1024-byte boundaries
  unsigned char* base_ptr = smem_raw + (base - raw);
  const int pad16 = (kp - HW) * 8;  // 16-byte pieces of one box's zero rows
  for (int i = tid; i < kWgStages * 4 * pad16; i += blockDim.x) {
    const int box = i / pad16, piece = i % pad16;
    *reinterpret_cast<uint4*>(base_ptr + box * tile + HW * 128 + piece * 16) = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the zero rows, for wgmma
  __syncthreads();

  const uint32_t tx = 4u * HW * 128;
  const CUtensorMap* mi = &map_inp;
  const CUtensorMap* mg = &map_g;
  auto stage_in = [&](int k) {  // entry k of the item into stage k % kWgStages
    const int e = g.order[it.first + k];
    const int d = it.taps == 9 ? g.ent_dil[e] : 0;
    const int dy = (it.tap / 3 - 1) * d, dx = (it.tap % 3 - 1) * d;
    const uint32_t bar = smem_u32(&full[k % kWgStages]);
    const uint32_t dst = base + (k % kWgStages) * stage_bytes;
    mbar_expect_tx(bar, tx);
    tma_load_4d(dst, mi, bar, 0, dx, dy, e);
    tma_load_4d(dst + tile, mi, bar, kWgBox, dx, dy, e);
    tma_load_4d(dst + 2 * tile, mg, bar, 0, 0, 0, e);
    tma_load_4d(dst + 3 * tile, mg, bar, kWgBox, 0, 0, e);
  };
  if (tid == 0)
    for (int k = 0; k < kWgStages && k < it.count; ++k) stage_in(k);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k = 0; k < it.count; ++k) {
    const int s = k % kWgStages;
    mbar_wait(smem_u32(&full[s]), (k / kWgStages) & 1);
    __syncwarp();  // wgmma is .aligned: the warp converges after the spin
    const uint32_t st = base + s * stage_bytes;
    const uint64_t da = wgmma_desc(st + wg * tile, tile, 1024);
    const uint64_t db = wgmma_desc(st + 2 * tile, tile, 1024);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    for (int kk = 0; kk < kp / 16; ++kk)  // 16 pixel rows = 2048 bytes = 128 descriptor units
      wgmma_m64n128k16(acc, da + 128 * kk, db + 128 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && k + kWgStages < it.count) stage_in(k + kWgStages);
  }
  // The accumulator layout of m64nNk16: warp q of the warpgroup holds rows
  // 16 q + lane / 4 and + 8, columns 8 j + 2 (lane % 4) and + 1.
  const int lane = tid & 31, row = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<float2*>(it.out + row * kMmaC + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(it.out + (row + 8) * kMmaC + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The second pass: blockIdx.x = target * 9 + tap. A target with several
// chunks gets the sum of its partials in chunk order, one without entries 0;
// a target with one chunk was written in place.
__global__ void __launch_bounds__(kThreads) nmn_weight_grad_reduce(const GradParams g) {
  const int t = blockIdx.x / 9, tap = blockIdx.x % 9;
  if (tap >= (t < g.S3 ? 9 : 1)) return;
  const int n = g.target_chunks[t];
  if (n == 1) return;
  const size_t cc4 = static_cast<size_t>(g.C) * g.C / 4;
  float4* out = reinterpret_cast<float4*>(
      t < g.S3 ? g.dw3 + (static_cast<size_t>(t) * 9 + tap) * cc4 * 4
               : g.dwc + static_cast<size_t>(t - g.S3) * cc4 * 4);
  const float4* src = reinterpret_cast<const float4*>(g.partial) +
                      (static_cast<size_t>(n > 0 ? g.target_slot[t] : 0) * 9 + tap) * cc4;
  for (size_t i = static_cast<size_t>(blockIdx.y) * blockDim.x + threadIdx.x; i < cc4;
       i += static_cast<size_t>(gridDim.y) * blockDim.x) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < n; ++q) {
      const float4 v = src[static_cast<size_t>(q) * 9 * cc4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

// out[c] = sum over rows r (in order) of part[r][c].
__global__ void nmn_sum_rows_kernel(const float* part, int rows, int cols, float* out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[static_cast<size_t>(r) * cols + c];
  out[c] = s;
}

// ---------------------------------------------------------------- launchers
size_t tile_bytes(int H, int W, int C, size_t elem) {
  return 2ull * (static_cast<size_t>(H) * W + 1) * (C + kRowPad) * elem;
}

// The interpreter kernels' dynamic shared memory: the two tiles, and in bf16
// the weight ring before them (1024 bytes of alignment, then three stages
// where they fit beside the tiles, else two). Sets p.stages; 0 when nothing
// fits.
size_t interpreter_smem(NmnParams& p, size_t elem) {
  const size_t tiles = tile_bytes(p.H, p.W, p.C, elem), room = kMaxSmem - kStaticSmem;
  p.stages = 0;
  if (elem != 2) return tiles <= room ? tiles : 0;
  for (int s = kMaxStages; s >= 2; --s) {
    const size_t bytes = 1024 + s * static_cast<size_t>(kTapBytes) + tiles;
    if (bytes <= room) {
      p.stages = s;
      return bytes;
    }
  }
  return 0;
}

// Sets `kernel`'s dynamic shared memory to `bytes` and returns the
// persistent grid: min(batch, the blocks that fit on the card at once), or
// -1 when none fits.
template <class Kernel>
int persistent_grid(Kernel kernel, size_t bytes, int batch, int threads = kThreads) {
  int per_sm = 0, device = 0, sms = 0;
  if (bytes == 0 ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes) != cudaSuccess ||
      cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      per_sm <= 0)
    return -1;
  return per_sm * sms < batch ? per_sm * sms : batch;
}

// cuTensorMapEncodeTiled, looked up in libcuda through the CUDA runtime, so
// the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(entry);
  }
  return fn;
}

// A TMA map over n bf16 entries of (H, W, C), boxes of one entry's (H, W, 64
// channels), 128-byte swizzle; rows and columns outside the entry read 0.
bool entry_map(CUtensorMap* map, const void* entries, int n, int H, int W, int C) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {2ull * C, 2ull * W * C, 2ull * H * W * C};
  const cuuint32_t box[4] = {kWgBox, static_cast<cuuint32_t>(W), static_cast<cuuint32_t>(H), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(entries), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A TMA map over n bf16 (kMmaC, kMmaC) matrices (C_out contiguous), boxes of
// one matrix's (kMmaC rows, 64 columns), 128-byte swizzle: the ring's
// stages, two boxes each.
bool weight_map(CUtensorMap* map, const void* bank, int n) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || bank == nullptr || n <= 0) return false;
  const cuuint64_t dims[3] = {kMmaC, kMmaC, static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {2ull * kMmaC, 2ull * kMmaC * kMmaC};
  const cuuint32_t box[3] = {kWgBox, kMmaC, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(bank), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The ring's maps over w3 (S3 * 9 matrices) and wcmp (Sc * 2). A bank
// without slots is never read: its map stands over w3.
bool weight_maps(const NmnParams& p, int S3, int Sc, CUtensorMap* m3, CUtensorMap* mc) {
  return weight_map(m3, p.w3, 9 * S3) &&
         (Sc > 0 ? weight_map(mc, p.wcmp, 2 * Sc) : weight_map(mc, p.w3, 9 * S3));
}

template <typename T, bool kMma, bool kTrain>
cudaError_t launch_nmn(NmnParams& p, const CUtensorMap& m3, const CUtensorMap& mc,
                       cudaStream_t stream) {
  constexpr int threads = kMma ? kFwdThreads : kThreads;
  const size_t bytes = interpreter_smem(p, sizeof(T));
  const int grid = persistent_grid(nmn_interpreter_kernel<T, kMma, kTrain>, bytes, p.batch, threads);
  if (grid <= 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(p.next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  nmn_interpreter_kernel<T, kMma, kTrain><<<grid, threads, bytes, stream>>>(p, m3, mc);
  return cudaGetLastError();
}

template <typename T, bool kMma, bool kReplay>
cudaError_t launch_backward(BwdParams& q, int grid, const CUtensorMap& m3, const CUtensorMap& mc,
                            cudaStream_t stream) {
  const size_t bytes = interpreter_smem(q.f, sizeof(T));
  if (persistent_grid(nmn_backward_kernel<T, kMma, kReplay>, bytes, q.f.batch) <= 0)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(q.f.next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  nmn_backward_kernel<T, kMma, kReplay><<<grid, kThreads, bytes, stream>>>(q, m3, mc);
  return cudaGetLastError();
}

// K6's grid: min(batch, the blocks that fit at once), or -1.
template <typename T, bool kMma>
int backward_grid(int batch, int H, int W, int C) {
  NmnParams p = {};
  p.H = H;
  p.W = W;
  p.C = C;
  return persistent_grid(nmn_backward_kernel<T, kMma, true>, interpreter_smem(p, sizeof(T)), batch);
}

// What the kernels take: float32 with C / 4 dividing the block; bf16 at C ==
// kMmaC and H * W <= max_hw.
bool params_ok(int dtype, int H, int W, int C, int max_hw) {
  if (C % 4 != 0 || kThreads % (C / 4) != 0) return false;
  if (dtype == 1) return C == kMmaC && H * W <= max_hw;
  return dtype == 0;
}

NmnParams make_params(const void* programs, int batch, int num_steps, const void* kind,
                      const void* slot3, const void* head_slot, const void* cmp_slot,
                      const void* same_slot, const void* x, const void* w3, const void* b3,
                      const void* w1, const void* b1, const void* same_wf, const void* same_wa,
                      const void* same_b, const void* wcmp, const void* bcmp, const void* order,
                      void* next, int H, int W, int C) {
  NmnParams p = {};
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
  p.b3 = static_cast<const float*>(b3);
  p.w1 = w1;
  p.b1 = static_cast<const float*>(b1);
  p.same_wf = same_wf;
  p.same_wa = static_cast<const float*>(same_wa);
  p.same_b = static_cast<const float*>(same_b);
  p.wcmp = wcmp;
  p.bcmp = static_cast<const float*>(bcmp);
  p.order = static_cast<const int*>(order);
  p.next = static_cast<int*>(next);
  p.H = H;
  p.W = W;
  p.C = C;
  return p;
}

}  // namespace

// The plan of the interpreter kernels: convs (B,) int32, the 3x3 convs each
// example's program runs (nmn_plan_kernel). Launches on `stream`.
extern "C" int probnmn_nmn_plan(const void* programs, int batch, int num_steps, const void* kind,
                                const void* head_slot, void* convs, void* stream) {
  if (batch <= 0) return 0;
  nmn_plan_kernel<<<(batch + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(programs), batch, num_steps, static_cast<const int*>(kind),
      static_cast<const int*>(head_slot), static_cast<int*>(convs));
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 float32 (SIMT), 1 bfloat16 (wgmma: C == 128 and H * W <= 256;
// the banks' S3 and Sc slots give the ring's TMA maps). A persistent grid
// takes the examples in `order` (B,) int32 through the counter `next` (one
// int32, zeroed here). With otraj and atraj set this is K5, else K2.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int probnmn_nmn_interpret(
    int dtype, const void* programs, int batch, int num_steps, const void* kind,
    const void* slot3, const void* head_slot, const void* cmp_slot, const void* same_slot,
    const void* x, const void* w3, const void* b3, const void* w1, const void* b1,
    const void* same_wf, const void* same_wa, const void* same_b, const void* wcmp,
    const void* bcmp, int S3, int Sc, const void* order, void* next, void* out, void* saved,
    void* invalid, void* otraj, void* atraj, int H, int W, int C, void* stream) {
  if (batch <= 0) return 0;
  if (!params_ok(dtype, H, W, C, kFwdMaxHW) || (otraj == nullptr) != (atraj == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  NmnParams p = make_params(programs, batch, num_steps, kind, slot3, head_slot, cmp_slot,
                            same_slot, x, w3, b3, w1, b1, same_wf, same_wa, same_b, wcmp, bcmp,
                            order, next, H, W, C);
  p.out = out;
  p.saved = saved;
  p.invalid = static_cast<int*>(invalid);
  p.otraj = otraj;
  p.atraj = atraj;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool train = otraj != nullptr;
  CUtensorMap m3 = {}, mc = {};
  if (dtype == 1) {
    if (!weight_maps(p, S3, Sc, &m3, &mc)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(train ? launch_nmn<bf16, true, true>(p, m3, mc, s)
                                  : launch_nmn<bf16, true, false>(p, m3, mc, s));
  }
  return static_cast<int>(train ? launch_nmn<float, false, true>(p, m3, mc, s)
                                : launch_nmn<float, false, false>(p, m3, mc, s));
}

// K2's and K5's launch at this shape: returns the persistent grid (or a
// negative value when the kernel cannot launch) and sets *stages to the
// weight ring's stages (0 in float32).
extern "C" int probnmn_nmn_interpret_grid(int dtype, int batch, int H, int W, int C, int* stages) {
  NmnParams p = {};
  p.H = H;
  p.W = W;
  p.C = C;
  if (batch <= 0 || !params_ok(dtype, H, W, C, kFwdMaxHW)) return -1;
  const int grid = dtype == 1 ? persistent_grid(nmn_interpreter_kernel<bf16, true, false>,
                                                interpreter_smem(p, 2), batch, kFwdThreads)
                              : persistent_grid(nmn_interpreter_kernel<float, false, false>,
                                                interpreter_smem(p, 4), batch);
  *stages = p.stages;
  return grid;
}

// K6's grid for `batch` examples (its scratch is sized by it), or a negative
// value when the kernel cannot launch at this shape.
extern "C" int probnmn_nmn_backward_grid(int dtype, int batch, int H, int W, int C) {
  if (batch <= 0) return -1;
  return dtype == 1 ? backward_grid<bf16, true>(batch, H, W, C)
                    : backward_grid<float, false>(batch, H, W, C);
}

// K6's sweep over `grid` blocks (probnmn_nmn_backward_grid), which take the
// examples in `order` through the counter `next`. With otraj and atraj
// (K5's residuals) the no-replay mode; with traj instead the replay mode,
// traj holding (grid, T, 3, HW, C) in the compute type. scratch and acts
// have `grid` rows. Fills dx, the workspace entries and the per-example
// partials (which the caller zeroes); ent_tag must hold the sentinel S3 + 2
// * Sc where no entry is written. bf16 needs C == 128 and H * W <= 224.
extern "C" int probnmn_nmn_backward(
    int dtype, const void* programs, int batch, int num_steps, const void* kind,
    const void* slot3, const void* head_slot, const void* cmp_slot, const void* same_slot,
    const void* x, const void* w3, const void* b3, const void* w1, const void* b1,
    const void* same_wf, const void* same_wa, const void* same_b, const void* wcmp,
    const void* bcmp, int S3, int Sc, const void* order, void* next, const void* invalid,
    const void* gfin, const void* otraj, const void* atraj, void* traj, int grid, void* scratch,
    void* acts, void* ent_inp, void* ent_g, void* ent_tag, void* ent_dil, const void* ent_base,
    void* part, int S1, int Ss, void* dx, int H, int W, int C, void* stream) {
  if (batch <= 0) return 0;
  const bool replay = traj != nullptr;
  if (!params_ok(dtype, H, W, C, 2 * kMmaTiles * 16) || H * W > kMaxHW || grid <= 0 ||
      grid > batch ||
      (replay ? otraj != nullptr || atraj != nullptr : otraj == nullptr || atraj == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams q = {};
  q.f = make_params(programs, batch, num_steps, kind, slot3, head_slot, cmp_slot, same_slot, x,
                    w3, b3, w1, b1, same_wf, same_wa, same_b, wcmp, bcmp, order, next, H, W, C);
  q.invalid = static_cast<const int*>(invalid);
  q.gfin = static_cast<const float*>(gfin);
  q.otraj = otraj;
  q.atraj = atraj;
  q.traj = traj;
  q.scratch = static_cast<float*>(scratch);
  q.acts = acts;
  q.ent_inp = ent_inp;
  q.ent_g = ent_g;
  q.ent_tag = static_cast<int*>(ent_tag);
  q.ent_dil = static_cast<int*>(ent_dil);
  q.ent_base = static_cast<const int*>(ent_base);
  q.part = static_cast<float*>(part);
  q.S3 = S3;
  q.S1 = S1;
  q.Ss = Ss;
  q.Sc = Sc;
  q.dx = static_cast<float*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap m3 = {}, mc = {};
  if (dtype == 1) {
    if (!weight_maps(q.f, S3, Sc, &m3, &mc)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(replay ? launch_backward<bf16, true, true>(q, grid, m3, mc, s)
                                   : launch_backward<bf16, true, false>(q, grid, m3, mc, s));
  }
  return static_cast<int>(replay ? launch_backward<float, false, true>(q, grid, m3, mc, s)
                                 : launch_backward<float, false, false>(q, grid, m3, mc, s));
}

// The floats of one row of probnmn_nmn_backward's partials.
extern "C" int probnmn_nmn_partial_floats(int S3, int S1, int Ss, int Sc, int C) {
  return PartLayout(S3, S1, Ss, Sc, C).size;
}

// K6's weight gradients of the 3x3 bank (dw3 (S3, 9, C, C)) and of compare's
// projection (dwc (Sc, 2, C, C)) from the sweep's n_entries entries: the work
// list (order, the n_chunks chunks and each target's chunks and first partial
// slot, ops/kernels/nmn_interpreter.py::weight_grad_plan) over the chunk
// kernel (9 blocks a chunk), then the second pass into dw3 / dwc through
// `partial` (P, 9, C, C). bf16 needs C == 128 and H * W <= 224.
extern "C" int probnmn_nmn_weight_grad(
    int dtype, const void* ent_inp, const void* ent_g, const void* ent_dil, int n_entries,
    const void* order, const void* chunk_target, const void* chunk_first, const void* chunk_count,
    const void* chunk_slot, int n_chunks, const void* target_chunks, const void* target_slot,
    int S3, int Sc, void* dw3, void* dwc, void* partial, int H, int W, int C, void* stream) {
  const int targets = S3 + 2 * Sc;
  if (targets <= 0) return 0;
  if (C % 8 != 0 || n_chunks < 0 || (n_chunks > 0 && n_entries <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  GradParams g = {ent_inp, ent_g, static_cast<const int*>(ent_dil), static_cast<const int*>(order),
                  static_cast<const int*>(chunk_target), static_cast<const int*>(chunk_first),
                  static_cast<const int*>(chunk_count), static_cast<const int*>(chunk_slot),
                  static_cast<const int*>(target_chunks), static_cast<const int*>(target_slot),
                  S3, Sc, static_cast<float*>(dw3), static_cast<float*>(dwc),
                  static_cast<float*>(partial), H, W, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    if (C != kMmaC || H * W > 2 * kMmaTiles * 16) return static_cast<int>(cudaErrorInvalidValue);
    if (n_chunks > 0) {
      CUtensorMap map_inp, map_g;
      if (!entry_map(&map_inp, ent_inp, n_entries, H, W, C) ||
          !entry_map(&map_g, ent_g, n_entries, H, W, C))
        return static_cast<int>(cudaErrorInvalidValue);
      const size_t bytes = kWgStages * 4ull * ((H * W + 15) / 16 * 16) * 128 + 1024;
      err = cudaFuncSetAttribute(nmn_weight_grad_tma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      nmn_weight_grad_tma<<<9 * n_chunks, 2 * 128, bytes, s>>>(g, map_inp, map_g);
    }
  } else if (dtype == 0) {
    if (n_chunks > 0) {
      const size_t bytes = 2ull * kGradChunk * C * sizeof(float);
      err = cudaFuncSetAttribute(nmn_weight_grad_simt<float>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      nmn_weight_grad_simt<float><<<9 * n_chunks, kThreads, bytes, s>>>(g);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(targets * 9, (C * C / 4 + kThreads - 1) / kThreads);
  nmn_weight_grad_reduce<<<grid, kThreads, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// out (cols,) = the sum of part (rows, cols) over its rows, in row order.
extern "C" int probnmn_nmn_sum_rows(const void* part, int rows, int cols, void* out, void* stream) {
  if (cols <= 0) return 0;
  nmn_sum_rows_kernel<<<(cols + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(part), rows,
                                                             cols, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
