// Masked shard mean for Hopper (sm_90a): K3, the butterfly reduce's merge.
//
// Replaces the Pallas TPU kernel `_merge_kernel` of
// src/repro/kernels/shard_merge.py.  It computes
//   out[i] = (sum_m valid[m] * shards[m, i]) / max(sum_m valid[m], 1)
// for shards (M, L) f32 with row stride `ld` (a column slice of a larger
// stacked matrix needs no copy), valid (M,) f32 in {0, 1}, out (L,) f32.
//
// The TPU kernel walked (M x 16384) VMEM panels on a sequential grid.  Here
// each thread owns four neighbouring columns (one 16-byte load per row when
// the rows are 16-byte aligned, single floats otherwise) and the grid covers
// L; the column sums are independent, so no block talks to another.  Every
// CTA sums `valid` once into shared memory for the denominator.
//
// Bound: device-memory bytes.  A column reads M floats and writes one, with
// M multiplies and adds: a fraction of an operation per byte, far below the
// card's ~295.  At the training slice's shape (M 2, L ~750 M, 9 GB moved)
// the bound is ~2.7 ms at 3.35 TB/s.
//
// Numerics equal the plain version (`ref.shard_merge`) bit for bit: the sum
// runs over m = 0 .. M-1 in index order with round-to-nearest multiplies and
// adds (no contraction into FMAs), and the division is an IEEE division
// (__fdiv_rn), as PyTorch divides by a tensor.  Indices are 64-bit: L * M
// passes 2**31 at full width.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;             // columns per thread
constexpr int kMaxMiners = 1024;

__device__ __forceinline__ float merge_col(const float* __restrict__ col,
                                           long long ld, int M,
                                           const float* v) {
  float acc = __fmul_rn(col[0], v[0]);
  for (int m = 1; m < M; ++m)
    acc = __fadd_rn(acc, __fmul_rn(col[(long long)m * ld], v[m]));
  return acc;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
shard_merge_kernel(const float* __restrict__ shards,
                   const float* __restrict__ valid, float* __restrict__ out,
                   int M, long long L, long long ld) {
  __shared__ float v_s[kMaxMiners];
  __shared__ float den_s;
  for (int m = threadIdx.x; m < M; m += blockDim.x) v_s[m] = valid[m];
  __syncthreads();
  if (threadIdx.x == 0) {
    float den = 0.0f;
    for (int m = 0; m < M; ++m) den = __fadd_rn(den, v_s[m]);
    den_s = fmaxf(den, 1.0f);
  }
  __syncthreads();
  const float den = den_s;

  const long long i0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (i0 >= L) return;
  if (kVec && i0 + kCols <= L) {
    float4 acc = *reinterpret_cast<const float4*>(shards + i0);
    acc.x = __fmul_rn(acc.x, v_s[0]);
    acc.y = __fmul_rn(acc.y, v_s[0]);
    acc.z = __fmul_rn(acc.z, v_s[0]);
    acc.w = __fmul_rn(acc.w, v_s[0]);
    for (int m = 1; m < M; ++m) {
      const float4 x =
          *reinterpret_cast<const float4*>(shards + (long long)m * ld + i0);
      acc.x = __fadd_rn(acc.x, __fmul_rn(x.x, v_s[m]));
      acc.y = __fadd_rn(acc.y, __fmul_rn(x.y, v_s[m]));
      acc.z = __fadd_rn(acc.z, __fmul_rn(x.z, v_s[m]));
      acc.w = __fadd_rn(acc.w, __fmul_rn(x.w, v_s[m]));
    }
    float4 o;
    o.x = __fdiv_rn(acc.x, den);
    o.y = __fdiv_rn(acc.y, den);
    o.z = __fdiv_rn(acc.z, den);
    o.w = __fdiv_rn(acc.w, den);
    *reinterpret_cast<float4*>(out + i0) = o;
    return;
  }
  for (long long i = i0; i < i0 + kCols && i < L; ++i)
    out[i] = __fdiv_rn(merge_col(shards + i, ld, M, v_s), den);
}

}  // namespace

extern "C" {

// shards: M rows of L f32 at row stride ld (elements, ld >= L); valid: M
// f32; out: L f32.  The 16-byte path needs shards, out and ld * 4 bytes to
// be 16-byte aligned; the wrapper checks that and passes `vec`.  Returns a
// CUDA error code (cudaErrorInvalidValue for M outside [1, 1024]).
int shard_merge_f32(const void* shards, const void* valid, void* out, int M,
                    long long L, long long ld, int vec, void* stream) {
  if (M < 1 || M > kMaxMiners || L < 1 || ld < L)
    return (int)cudaErrorInvalidValue;
  const long long per_cta = (long long)kThreads * kCols;
  const long long grid = (L + per_cta - 1) / per_cta;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    shard_merge_kernel<true><<<(unsigned)grid, kThreads, 0, s>>>(
        (const float*)shards, (const float*)valid, (float*)out, M, L, ld);
  else
    shard_merge_kernel<false><<<(unsigned)grid, kThreads, 0, s>>>(
        (const float*)shards, (const float*)valid, (float*)out, M, L, ld);
  return (int)cudaGetLastError();
}

}  // extern "C"
