// Blockwise symmetric int8 codec for Hopper (sm_90a): quantize (K2a) and
// dequantize (K2b).
//
// Replaces the Pallas TPU kernels `_quant_kernel` and `_dequant_kernel` of
// src/repro/kernels/quant_stream.py.  Those tiled the flat vector into
// (512 x 256) VMEM panels and walked them on a sequential grid.  Here every
// quantization block is one warp's work and the blocks run in parallel:
// a CTA of 256 threads covers 8 blocks, the grid covers the vector.
//
// Bound: device-memory bytes.  Quantize reads 4 bytes and writes 1 byte (plus
// 4 bytes of scale per block) for each element and does a few operations per
// byte, far below the card's ~295 operations per byte.  The design keeps the
// loads coalesced (a warp reads 32 consecutive floats per step) and reads
// each element twice, the second time from L1/L2, instead of staging the
// block in shared memory.  Dequantize is one thread per element.
//
// Numerics equal the plain version bit for bit: amax is a max (order-free),
// scale = amax / 127 with an IEEE division (no fast math), q = rint(x / scale)
// (round half to even, like torch.round and jnp.round), clamped to +-127.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerCta = 8;

__global__ void quantize_kernel(const float* __restrict__ x,
                                int8_t* __restrict__ q,
                                float* __restrict__ scales,
                                long long n_blocks, int block) {
  const int lane = threadIdx.x & 31;
  const long long b =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (b >= n_blocks) return;
  const float* xb = x + b * block;
  float amax = 0.0f;
  for (int i = lane; i < block; i += 32) amax = fmaxf(amax, fabsf(xb[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
  int8_t* qb = q + b * block;
  for (int i = lane; i < block; i += 32) {
    float r = rintf(__fdiv_rn(xb[i], scale));
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    qb[i] = static_cast<int8_t>(r);
  }
  if (lane == 0) scales[b] = scale;
}

__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scales,
                                  float* __restrict__ out, long long n,
                                  int block) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = __fmul_rn(static_cast<float>(q[i]), scales[i / block]);
}

}  // namespace

extern "C" {

// x: n f32, q: n int8, scales: n / block f32; block divides n, block <= 1024.
int quantize_int8(const void* x, void* q, void* scales, long long n,
                  int block, void* stream) {
  const long long n_blocks = n / block;
  const long long grid = (n_blocks + kWarpsPerCta - 1) / kWarpsPerCta;
  quantize_kernel<<<(unsigned)grid, 32 * kWarpsPerCta, 0,
                    (cudaStream_t)stream>>>(
      (const float*)x, (int8_t*)q, (float*)scales, n_blocks, block);
  return (int)cudaGetLastError();
}

int dequantize_int8(const void* q, const void* scales, void* out,
                    long long n, int block, void* stream) {
  const int threads = 256;
  const long long grid = (n + threads - 1) / threads;
  dequantize_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)scales, (float*)out, n, block);
  return (int)cudaGetLastError();
}

}  // extern "C"
