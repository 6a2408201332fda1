// What every persistent thread-block-cluster sweep shares. A sweep runs all
// the steps of a recurrence whose rows are independent in one launch: a
// cluster of n CTAs owns some rows and splits the hidden units between its
// CTAs, keeps its weights in shared memory, pushes each step's hidden state
// into every CTA of the cluster through distributed shared memory and
// meets the cluster barrier once a step. The training kernels' LSTM sweeps
// (lstm_sweep.cuh) and K1's encoder sweep (seq2seq_decode.cu) are built
// from these pieces: the asynchronous copies that fill shared memory, the
// push into the cluster, the split cluster barrier and the launch plan.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace probnmn {
namespace {

namespace cg = cooperative_groups;

constexpr int kSweepMaxCluster = 8;       // the portable cluster size
constexpr size_t kSweepMaxSmem = 232448;  // the H100's shared memory a block can use

#define SWEEP_TRY(expr)                       \
  do {                                        \
    const cudaError_t sweep_err_ = (expr);    \
    if (sweep_err_ != cudaSuccess) return sweep_err_; \
  } while (0)

inline int sweep_ceil(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// 4 bytes from global into shared memory, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The cluster barrier in two halves: the arrival releases this thread's
// earlier writes (the pushes), the wait acquires every CTA's. Work between
// the two overlaps the wait for the other CTAs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// `v` at `slot`, an address in this CTA's shared memory, in each of the n
// CTAs of the cluster (this one included).
template <typename V>
__device__ __forceinline__ void push_to_cluster(cg::cluster_group& cluster, V* slot, const V& v,
                                                int n) {
  for (int p = 0; p < n; ++p) *cluster.map_shared_rank(slot, p) = v;
}

// A sweep's launch plan: the cluster size, the units a CTA, the rows a
// cluster owns (the fewest that let every cluster run at once, up to what
// threads and shared memory allow), the threads a CTA, the clusters, how
// many clusters the card runs at once, and the shared memory of a CTA.
struct SweepPlan {
  int cluster, units, rows, threads, clusters, fit;
  size_t smem;
};

void sweep_config(int n, int threads, size_t smem, int clusters, cudaStream_t s,
                  cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(clusters * n));
  cfg->blockDim = dim3(static_cast<unsigned>(threads));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(n);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The kernel's shared memory, and leave to launch clusters above the
// portable size.
template <typename Kernel>
cudaError_t sweep_attributes(Kernel kernel, size_t smem, int n) {
  SWEEP_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem)));
  if (n > kSweepMaxCluster)
    SWEEP_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  return cudaSuccess;
}

// The plan of `kernel` for B rows in clusters of n CTAs of U units, with
// `smem_bytes(R)` and `threads(R)` for R rows a cluster and at most `r_cap`
// rows. cudaErrorInvalidValue where not one row fits.
template <typename Kernel, typename Smem, typename Threads>
cudaError_t plan_for(Kernel kernel, Smem smem_bytes, Threads threads, int r_cap, int n, int U,
                     int B, cudaStream_t s, SweepPlan* plan) {
  if (B < 1 || n < 1 || U < 1) return cudaErrorInvalidValue;
  int r_max = r_cap;
  while (r_max > 0 && smem_bytes(r_max) > kSweepMaxSmem) --r_max;
  if (r_max == 0) return cudaErrorInvalidValue;
  const size_t smem_max = smem_bytes(r_max);
  SWEEP_TRY(sweep_attributes(kernel, smem_max, n));
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  sweep_config(n, threads(r_max), smem_max, sweep_ceil(B, r_max), s, &cfg, &attr);
  int fit = 0;
  SWEEP_TRY(cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg));
  if (fit < 1) return cudaErrorInvalidValue;
  const int R = sweep_ceil(B, fit) < r_max ? sweep_ceil(B, fit) : r_max;
  *plan = SweepPlan{n, U, R, threads(R), sweep_ceil(B, R), fit, smem_bytes(R)};
  return cudaSuccess;
}

}  // namespace
}  // namespace probnmn
