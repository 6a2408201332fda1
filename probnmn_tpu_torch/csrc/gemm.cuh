// The training kernels' float32 GEMM (gemm.cu), as lm_train.cu and
// tf_train.cu call it through train_common.cuh.
#pragma once

#include <cuda_runtime.h>

namespace probnmn {

// C[m, n] (+)= sum_k A[m, k] B[k, n] (+ bias[n]) for m < M, n < N, with A
// and B addressed through strides (element (m, k) of A at A[m * sam + k * sak])
// so that a transposed operand needs no copy; C row-major with leading
// dimension ldc. `partial` non-null lets a long K be split
// (gemm_partial_floats floats); the splits' partial sums are added in a
// fixed order. Launches on `s` and returns cudaGetLastError().
cudaError_t gemm(cudaStream_t s, const float* A, long long sam, long long sak, const float* B,
                 long long sbk, long long sbn, float* C, long long ldc, int M, int N, int K,
                 const float* bias, bool accumulate, float* partial);

// Floats of `partial` a split GEMM of an (M, N) result over depth K needs (0
// when K is not split).
long long gemm_partial_floats(long long M, long long N, long long K);

}  // namespace probnmn
