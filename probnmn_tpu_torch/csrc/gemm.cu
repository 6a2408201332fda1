// The float32 GEMM of the training kernels (K3f/K3b in lm_train.cu, K4f/K4b
// in tf_train.cu): C[m, n] (+)= sum_k A[m, k] B[k, n] (+ bias[n]), A and B
// addressed through strides so that a transposed operand needs no copy.
//
// Replaces the jnp.dot products inside the Pallas bodies of
// probnmn_tpu/ops/pallas/seq2seq_train.py, which the TPU's matrix unit ran
// inside each kernel: _tf_forward_kernel's input and embedding projections
// and head (:193, :199, :261), _tf_backward_kernel's gradients (:452, :466,
// :469, :562), and _lm_forward_kernel / _lm_backward_kernel's head and its
// gradients (:1077-1100).
//
// What bounds it on an H100, in float32 on the SIMT cores (67 TFLOP/s):
// the large products (x . W_ih^T over every row-step, the weight gradients
// over T*B rows, dpre . W_ih) do 60-250 FLOP for each byte they must move and
// are bound by operations; the decoder's per-step product
// dpre . [W_ih[:, :H], W_hh] (B x 2H x 4H, ~0.13 GFLOP at B = 128) takes 2 µs
// at the peak, less than a launch, and is bound by how many SMs it keeps busy.
//
// Design:
// - a block of 256 threads computes a 128 x 128 tile (8 x 8 outputs a
//   thread), a 128 x 64 one (8 x 4) or a 64 x 64 one (4 x 4): the largest
//   whose grid has at least kFillCtas blocks; two blocks share an SM (at
//   most 128 registers a thread);
// - K arrives in slices of depth 32 (16 where two blocks of 32 would not
//   fit an SM's shared memory) through a ring of 3 (4) stages filled by
//   cp.async, 16 bytes along whichever axis of the operand is contiguous
//   where the strides and the pointer allow, else 4 bytes, so that the
//   copies of the next slices overlap the FMAs on this one;
// - each operand lands as it lies in memory, one template instance per
//   stride pattern: k contiguous as [x][k] rows padded by 4 floats, then
//   transposed in shared memory into a [k][x] slice; x contiguous as
//   [k][x]. The products read float4 fragments along x, a thread owning
//   x = 4 t + i % 4 + 64 (i / 4), so that a warp's reads are consecutive
//   float4s, and each depth's fragments are read while the previous
//   depth's FMAs run;
// - split-K: where the caller passes scratch and K is longer than
//   gemm_chunk(K) (a function of K alone), grid z sums its chunk of K into
//   its own partial, and gemm_reduce adds the partials in the order z = 0,
//   1, ... (no atomics);
// - every output is summed over k in increasing order within a split, so
//   the GEMM gives the same bits on every run. The plan (tile, depth,
//   splits, grid) depends on M, N, K and the strides, never on the device.

#include <stdint.h>

#include <vector>

#include "gemm.cuh"

namespace probnmn {
namespace {

typedef long long ll;

constexpr int kThreads = 256;
constexpr int kFillCtas = 128;      // the largest tile whose grid has this many blocks
constexpr int kMinBlocks = 2;       // blocks an SM holds: at most 128 registers a thread
constexpr int kTwoBlockSmem = 115712;  // bytes a block may take for two to share an SM's 228 KB
constexpr int kShortK = 1024, kShortChunk = 128, kSplits = 16, kLongChunk = 512;

int cdiv(ll a, ll b) { return static_cast<int>((a + b - 1) / b); }

// K per split, a function of K alone: chunks of 128 up to K = 1024 (the
// decoder's 4H-deep product: 8 of them), 16 chunks (multiples of 4) up to
// K = 8192 (the weight gradients over T*B rows), then chunks of 512. The
// number of splits never falls as K grows, so the scratch a caller sizes
// for its longest contraction serves the shorter ones.
int gemm_chunk(int K) {
  if (K <= kShortK) return kShortChunk;
  if (K > kLongChunk * kSplits) return kLongChunk;
  return 4 * cdiv(K, 4 * kSplits);
}

// A stage's depth BK: 32, or 16 where two blocks of 32 would not share an
// SM (128 x 128 tiles with a k-contiguous operand). The ring has 4 stages of 16
// or 3 of 32; a [x][k] row takes BK + 4 floats (float4-aligned, and eight
// consecutive rows start on distinct groups of four banks).
__host__ __device__ constexpr int stages_for(int bk) { return bk == 16 ? 4 : 3; }
__host__ __device__ constexpr int row_for(int bk) { return bk + 4; }

// Shared floats of one operand: its ring, and the [k][x] slice a
// k-contiguous operand is transposed into.
__host__ __device__ constexpr int operand_floats(int x, bool kc, int bk) {
  return stages_for(bk) * (kc ? x * row_for(bk) : bk * x) + (kc ? bk * x : 0);
}

__host__ __device__ constexpr int smem_bytes(int bm, int bn, bool akc, bool bkc, int bk) {
  return 4 * (operand_floats(bm, akc, bk) + operand_floats(bn, bkc, bk));
}

__host__ __device__ constexpr int depth_for(int bm, int bn, bool akc, bool bkc) {
  return smem_bytes(bm, bn, akc, bkc, 32) <= kTwoBlockSmem ? 32 : 16;
}

struct Args {
  const float* A;
  ll sam, sak;
  const float* B;
  ll sbk, sbn;
  float* C;  // the result (leading dimension ldc), or the split partials
  ll ldc;
  const float* bias;
  int M, N, K, k_chunk;
  bool accumulate, vec_a, vec_b, vec_c;  // vec_c: float4 stores into C (or the partials)
};

__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One operand's part of a stage: extent X along its outer axis (m for A, n
// for B) and BK along k. KC: the copies land [x][k] (k contiguous in
// memory, or neither axis) and are transposed into a [k][x] slice before
// the products read them; else they land [k][x] (x contiguous), as the
// products read them.
template <int X, bool KC, int BK>
struct Operand {
  static constexpr int kRow = row_for(BK);
  static constexpr int kFloats = KC ? X * kRow : BK * X;  // one stage of the ring
  static constexpr int kSliceFloats = KC ? BK * X : 0;    // the transposed slice

  // Copies element (x, k) = p[x * sx + k * sk] for x0 <= x < x0 + X and
  // k0 <= k < k0 + BK into s, zeros where x >= xn or k >= k_end. `vec`:
  // 16-byte copies along the contiguous axis (its stride 1, the other's a
  // multiple of 4, p 16-byte aligned, k0 a multiple of 4).
  __device__ __forceinline__ static void load(float* s, const float* p, ll sx, ll sk, int x0,
                                              int xn, int k0, int k_end, bool vec) {
    const int tid = threadIdx.x;
    if (KC && vec) {
      for (int c = tid; c < X * (BK / 4); c += kThreads) {
        const int xx = c / (BK / 4), kk = 4 * (c % (BK / 4));
        const int x = x0 + xx, k = k0 + kk;
        const int n = x < xn ? max(0, min(4, k_end - k)) : 0;
        cp16(s + xx * kRow + kk, n > 0 ? p + x * sx + k : p, 4 * n);
      }
    } else if (KC) {
      for (int e = tid; e < X * BK; e += kThreads) {
        const int xx = e / BK, kk = e % BK;
        const int x = x0 + xx, k = k0 + kk;
        const bool ok = x < xn && k < k_end;
        cp4(s + xx * kRow + kk, ok ? p + x * sx + k * sk : p, ok ? 4 : 0);
      }
    } else if (vec) {
      for (int c = tid; c < BK * (X / 4); c += kThreads) {
        const int kk = c / (X / 4), xx = 4 * (c % (X / 4));
        const int x = x0 + xx, k = k0 + kk;
        const int n = k < k_end ? max(0, min(4, xn - x)) : 0;
        cp16(s + kk * X + xx, n > 0 ? p + k * sk + x : p, 4 * n);
      }
    } else {
      for (int e = tid; e < BK * X; e += kThreads) {
        const int kk = e / X, xx = e % X;
        const int x = x0 + xx, k = k0 + kk;
        const bool ok = x < xn && k < k_end;
        cp4(s + kk * X + xx, ok ? p + x * sx + k * sk : p, ok ? 4 : 0);
      }
    }
  }

  // KC: the landed [x][k] stage into the [k][x] slice, a float4 of four
  // depths read from a row, written down a column (consecutive threads take
  // consecutive rows: the 80-byte rows spread their reads over the banks).
  __device__ __forceinline__ static void transpose(const float* s, float* slice) {
    if (KC) {
      for (int c = threadIdx.x; c < X * (BK / 4); c += kThreads) {
        const int xx = c % X, kk = 4 * (c / X);
        const float4 v = *reinterpret_cast<const float4*>(s + xx * kRow + kk);
        slice[kk * X + xx] = v.x;
        slice[(kk + 1) * X + xx] = v.y;
        slice[(kk + 2) * X + xx] = v.z;
        slice[(kk + 3) * X + xx] = v.w;
      }
    }
  }

  // f[i] = element (index(t, i), k) of a [k][x] slice for the TX outer
  // indices thread coordinate t (0..15) owns: TX / 4 float4 reads; a warp's
  // 4 (or 8) coordinates read consecutive float4s.
  template <int TX>
  __device__ __forceinline__ static void frag(const float* s, int t, int k, float (&f)[TX]) {
#pragma unroll
    for (int g = 0; g < TX / 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(s + k * X + 4 * t + 64 * g);
      f[4 * g] = v.x;
      f[4 * g + 1] = v.y;
      f[4 * g + 2] = v.z;
      f[4 * g + 3] = v.w;
    }
  }
};

// The outer index (row or column of the tile) of a thread's fragment entry i.
__device__ __forceinline__ int tile_index(int t, int i) { return 4 * t + i % 4 + 64 * (i / 4); }

template <int BM, int BN, bool AKC, bool BKC>
__global__ void __launch_bounds__(kThreads, kMinBlocks) gemm_tile(Args g) {
  constexpr int BK = depth_for(BM, BN, AKC, BKC);
  constexpr int kStages = stages_for(BK);
  typedef Operand<BM, AKC, BK> OpA;
  typedef Operand<BN, BKC, BK> OpB;
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int kStage = OpA::kFloats + OpB::kFloats;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* slice_a = smem + kStages * kStage;  // the transposed slices (KC operands)
  float* slice_b = slice_a + OpA::kSliceFloats;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // A warp covers 4 row coordinates and 8 column coordinates.
  const int ty = lane / 8 + 4 * (warp / 2), tx = lane % 8 + 8 * (warp % 2);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * g.k_chunk;
  const int k_end = min(g.K, k_begin + g.k_chunk);
  const int slices = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  auto load = [&](int slice) {
    float* s = smem + (slice % kStages) * kStage;
    const int k0 = k_begin + slice * BK;
    OpA::load(s, g.A, g.sam, g.sak, m0, g.M, k0, k_end, g.vec_a);
    OpB::load(s + OpA::kFloats, g.B, g.sbn, g.sbk, n0, g.N, k0, k_end, g.vec_b);
  };
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) load(s);
    cp_commit();
  }
  for (int t = 0; t < slices; ++t) {
    cp_wait<kStages - 2>();  // slice t has landed (this thread's copies) ...
    __syncthreads();         // ... every thread's; slice t - 1's products and stage are done
    const float* stage = smem + (t % kStages) * kStage;
    OpA::transpose(stage, slice_a);
    OpB::transpose(stage + OpA::kFloats, slice_b);
    if (t + kStages - 1 < slices) load(t + kStages - 1);
    cp_commit();
    if (AKC || BKC) __syncthreads();  // the transposed slices are complete
    const float* sa = AKC ? slice_a : stage;
    const float* sb = BKC ? slice_b : stage + OpA::kFloats;
    // Depth by depth, the next depth's fragments read while this one's FMAs run.
    float a[2][TM], b[2][TN];
    OpA::template frag<TM>(sa, ty, 0, a[0]);
    OpB::template frag<TN>(sb, tx, 0, b[0]);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      if (k + 1 < BK) {
        OpA::template frag<TM>(sa, ty, k + 1, a[(k + 1) % 2]);
        OpB::template frag<TN>(sb, tx, k + 1, b[(k + 1) % 2]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[k % 2][i], b[k % 2][j], acc[i][j]);
    }
  }
  // Each thread holds runs of 4 consecutive columns: float4 stores where the
  // row's run is whole and aligned.
  const bool split = gridDim.z > 1;
  float* out = split ? g.C + static_cast<ll>(blockIdx.z) * g.M * g.N : g.C;
  const ll ld = split ? g.N : g.ldc;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tile_index(ty, i);
    if (m >= g.M) continue;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int n = n0 + tile_index(tx, 4 * q);
      if (n >= g.N) continue;
      float v[4] = {acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]};
      float* dst = out + m * ld + n;
      if (!split && g.bias != nullptr)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < g.N) v[j] += g.bias[n + j];
      if (g.vec_c && n + 3 < g.N) {
        float4 w = make_float4(v[0], v[1], v[2], v[3]);
        if (!split && g.accumulate) {
          const float4 c = *reinterpret_cast<const float4*>(dst);
          w = make_float4(c.x + w.x, c.y + w.y, c.z + w.z, c.w + w.w);
        }
        *reinterpret_cast<float4*>(dst) = w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < g.N) dst[j] = (!split && g.accumulate) ? dst[j] + v[j] : v[j];
      }
    }
  }
}

// C[m, n] (+)= sum over s of partial[s][m][n] in the order s = 0, 1, ...,
// then + bias[n].
__global__ void gemm_reduce(const float* __restrict__ partial, int splits, int M, int N, float* C,
                            ll ldc, const float* __restrict__ bias, bool accumulate) {
  const ll idx = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  const ll total = static_cast<ll>(M) * N;
  if (idx >= total) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[s * total + idx];
  const int n = static_cast<int>(idx % N);
  if (bias != nullptr) v += bias[n];
  float* dst = C + (idx / N) * ldc + n;
  *dst = accumulate ? *dst + v : v;
}

struct Plan {
  int bm, bn, splits, k_chunk, depth;
  bool a_kc, b_kc;
  dim3 grid;
  int smem;  // bytes of the ring and the transposed slices
};

ll tiles(int M, int N, int bm, int bn, int splits) {
  return static_cast<ll>(cdiv(M, bm)) * cdiv(N, bn) * splits;
}

Plan make_plan(int M, int N, int K, ll sam, ll sak, ll sbk, ll sbn, bool split_ok) {
  Plan p;
  p.a_kc = !(sam == 1 && sak != 1);
  p.b_kc = !(sbn == 1 && sbk != 1);
  p.splits = 1;
  p.k_chunk = K;
  const int chunk = gemm_chunk(K);
  if (split_ok && K > chunk) {
    p.splits = cdiv(K, chunk);
    p.k_chunk = chunk;
  }
  p.bm = p.bn = 64;
  if (tiles(M, N, 128, 128, p.splits) >= kFillCtas) {
    p.bm = p.bn = 128;
  } else if (tiles(M, N, 128, 64, p.splits) >= kFillCtas) {
    p.bm = 128;
  }
  p.grid = dim3(cdiv(N, p.bn), cdiv(M, p.bm), p.splits);
  p.depth = depth_for(p.bm, p.bn, p.a_kc, p.b_kc);
  p.smem = smem_bytes(p.bm, p.bn, p.a_kc, p.b_kc, p.depth);
  return p;
}

template <int BM, int BN, bool AKC, bool BKC>
cudaError_t launch_tile(const Plan& p, const Args& g, cudaStream_t s) {
  static bool sized = false;  // the ring's size is fixed per instance
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_tile<BM, BN, AKC, BKC>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  gemm_tile<BM, BN, AKC, BKC><<<p.grid, kThreads, p.smem, s>>>(g);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_pattern(const Plan& p, const Args& g, cudaStream_t s) {
  if (p.a_kc && p.b_kc) return launch_tile<BM, BN, true, true>(p, g, s);
  if (p.a_kc) return launch_tile<BM, BN, true, false>(p, g, s);
  if (p.b_kc) return launch_tile<BM, BN, false, true>(p, g, s);
  return launch_tile<BM, BN, false, false>(p, g, s);
}

bool aligned16(const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// What gemm() counts and, while recording, notes of each launch.
constexpr int kRecordFields = 12;  // M, N, K, sam, sak, sbk, sbn, splits, bias, accumulate, tile
                                   // rows, tile columns
ll g_launches = 0;
bool g_recording = false;
std::vector<ll> g_records;

}  // namespace

long long gemm_partial_floats(long long M, long long N, long long K) {
  const int chunk = gemm_chunk(static_cast<int>(K));
  return K > chunk ? static_cast<ll>(cdiv(K, chunk)) * M * N : 0;
}

cudaError_t gemm(cudaStream_t s, const float* A, ll sam, ll sak, const float* B, ll sbk, ll sbn,
                 float* C, ll ldc, int M, int N, int K, const float* bias, bool accumulate,
                 float* partial) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const Plan p = make_plan(M, N, K, sam, sak, sbk, sbn, partial != nullptr);
  Args g{A, sam, sak, B, sbk, sbn, p.splits > 1 ? partial : C, ldc, bias, M, N, K, p.k_chunk,
         accumulate, false, false, false};
  g.vec_a = aligned16(A) && (p.a_kc ? sak == 1 && sam % 4 == 0 : sak % 4 == 0);
  g.vec_b = aligned16(B) && (p.b_kc ? sbk == 1 && sbn % 4 == 0 : sbk % 4 == 0);
  g.vec_c = aligned16(g.C) && (p.splits > 1 ? N % 4 == 0 : ldc % 4 == 0);
  ++g_launches;
  if (g_recording) {
    const ll r[kRecordFields] = {M,   N,   K,        sam,
                                 sak, sbk, sbn,      p.splits,
                                 bias != nullptr, accumulate, p.bm, p.bn};
    g_records.insert(g_records.end(), r, r + kRecordFields);
  }
  cudaError_t err = p.bn == 128  ? launch_pattern<128, 128>(p, g, s)
                    : p.bm == 128 ? launch_pattern<128, 64>(p, g, s)
                                  : launch_pattern<64, 64>(p, g, s);
  if (err != cudaSuccess || p.splits == 1) return err;
  gemm_reduce<<<cdiv(static_cast<ll>(M) * N, 256), 256, 0, s>>>(partial, p.splits, M, N, C, ldc,
                                                                 bias, accumulate);
  return cudaGetLastError();
}

}  // namespace probnmn

using namespace probnmn;

// The GEMM on its own (gemm_cuda in ops/kernels/gemm.py): `split` lets K be
// split, with `partial` of probnmn_gemm_partial_floats() floats.
extern "C" int probnmn_gemm(const void* a, long long sam, long long sak, const void* b,
                            long long sbk, long long sbn, void* c, long long ldc, int M, int N,
                            int K, const void* bias, int accumulate, void* partial, void* stream) {
  return static_cast<int>(gemm(static_cast<cudaStream_t>(stream), static_cast<const float*>(a), sam,
                               sak, static_cast<const float*>(b), sbk, sbn, static_cast<float*>(c),
                               ldc, M, N, K, static_cast<const float*>(bias), accumulate != 0,
                               static_cast<float*>(partial)));
}

extern "C" long long probnmn_gemm_partial_floats(int M, int N, int K) {
  return gemm_partial_floats(M, N, K);
}

// The plan of a GEMM: out = {tile rows, tile columns, splits, K per split,
// grid x, y, z, A staged [m][k], B staged [n][k], shared bytes, stage depth}.
extern "C" int probnmn_gemm_plan(int M, int N, int K, long long sam, long long sak, long long sbk,
                                 long long sbn, int split, int* out) {
  const Plan p = make_plan(M, N, K, sam, sak, sbk, sbn, split != 0);
  const int v[] = {p.bm, p.bn, p.splits, p.k_chunk, static_cast<int>(p.grid.x),
                   static_cast<int>(p.grid.y), static_cast<int>(p.grid.z), p.a_kc, p.b_kc, p.smem,
                   p.depth};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// GEMM launches since the library was loaded, or since the last reset.
extern "C" long long probnmn_gemm_launches(int reset) {
  const ll n = g_launches;
  if (reset) g_launches = 0;
  return n;
}

// on != 0: forget earlier records and note every later launch; 0: stop.
extern "C" void probnmn_gemm_record(int on) {
  if (on) g_records.clear();
  g_recording = on != 0;
}

// Copies up to `max` records of kRecordFields values each into out; returns
// how many there are.
extern "C" int probnmn_gemm_records(long long* out, int max) {
  const int n = static_cast<int>(g_records.size() / kRecordFields);
  for (int i = 0; i < n && i < max; ++i)
    for (int f = 0; f < kRecordFields; ++f)
      out[i * kRecordFields + f] = g_records[i * kRecordFields + f];
  return n;
}
