// Flash attention forward for Hopper (sm_90a): K1.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py.  It computes
//   ref.attention(q, k, v, causal, q_offset)
// for q (B, Sq, H, D) and k/v (B, Skv, KH, D), all bf16, in the port's
// (batch, sequence, head, dim) layout read in place: the TPU kernel's
// transpose to (B, H, S, D) is not needed.  The softmax runs in f32 and the
// output is bf16.  With `causal`, key t is live for the query row at
// absolute position q_offset + i iff t <= q_offset + i; without it every
// key is live.  Query head h reads kv head h / G (G = H / KH).
//
// The TPU kernel carried the online-softmax state (m, l, acc) in VMEM
// scratch across a sequential grid axis over KV blocks.  Blocks run in
// parallel here, so the KV loop runs inside one thread block: a CTA takes
// one (batch, kv head, tile of query positions) and all G query heads that
// share that kv head, so each K/V tile is staged in shared memory once for G
// heads (16 query rows per CTA: 16 / G positions).  Each of the 4 warps owns
// 4 rows and keeps their running max, sum and output accumulator (D / 32
// values per lane) in registers, in f32.  Key tiles of 64 strictly above the
// causal diagonal (shifted by q_offset) are never loaded; inside a tile the
// mask applies key by key.  No atomics: every sum runs in a fixed order, so
// the result repeats bit for bit (validator replay compares a replayed
// forward with a miner's upload).
//
// Bound: on the training path (B 4, S 512, H 32, KH 8, D 64, causal) a call
// moves ~34 MB (q, k, v read once, the output written once) and does
// ~2.2 GFLOP of products (2 * B * H * S^2 * D over the causal half), so the
// tensor cores' 989 TFLOP/s would bound it, not the bytes.  This first
// version multiplies on the CUDA cores in f32 (the products of the plain
// version, in another order) and is bound by those instructions and by
// shared-memory traffic; mma.sync/wgmma tiles are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per CTA
constexpr int kTile = 64;                      // keys per shared-memory tile

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                       int H, int KH, int tq, int causal, int q_offset,
                       float scale) {
  static_assert(D % 32 == 0 && D <= 128, "head dim must be 32, 64 or 128");
  constexpr int kDpl = D / 32;          // output dims per lane
  constexpr int kKStride = D / 2 + 1;   // K row stride in 32-bit words (pad)
  constexpr int kVecs = D / 8;          // 16-byte vectors per K/V row

  __shared__ float q_s[kRows][D];
  __shared__ uint32_t k_s[kTile * kKStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kTile * D];

  const int G = H / KH;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * tq;
  const int n_rows = tq * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int q_last = min(q0 + tq, Sq) - 1;
  const int kend = causal ? min(Skv, q_offset + q_last + 1) : Skv;

  // stage this CTA's query rows, pre-scaled, in f32 (row r -> position
  // q0 + r / G, head kh * G + r % G)
  for (int idx = threadIdx.x; idx < kRows * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + r / G;
    float val = 0.0f;
    if (r < n_rows && qi < Sq) {
      const int h = kh * G + r % G;
      val = __bfloat162float(q[((size_t)(b * Sq + qi) * H + h) * D + d]) *
            scale;
    }
    q_s[r][d] = val;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDpl];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDpl; ++c) acc[i][c] = 0.0f;
  }

  for (int t0 = 0; t0 < kend; t0 += kTile) {
    __syncthreads();   // the previous tile is consumed (and q_s is staged)
    for (int idx = threadIdx.x; idx < kTile * kVecs; idx += blockDim.x) {
      const int row = idx / kVecs, c = idx % kVecs;
      const int t = t0 + row;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (t < kend) {
        const size_t off = ((size_t)(b * Skv + t) * KH + kh) * D + c * 8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      uint32_t* kd = k_s + row * kKStride + c * 4;
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      *reinterpret_cast<uint4*>(v_s + row * D + c * 8) = vv;
    }
    __syncthreads();
    const int n_live = min(kTile, kend - t0);

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      const int qi = q0 + r / G;
      if (r >= n_rows || qi >= Sq) continue;   // uniform across the warp
      const int qpos = q_offset + qi;

      // lane scores keys lane and lane + 32 of the tile
      const uint32_t* kr0 = k_s + lane * kKStride;
      const uint32_t* kr1 = k_s + (lane + 32) * kKStride;
      float dot0 = 0.0f, dot1 = 0.0f;
#pragma unroll
      for (int p = 0; p < D / 2; ++p) {
        const float qa = q_s[r][2 * p], qb = q_s[r][2 * p + 1];
        const float2 k0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(kr0 + p));
        const float2 k1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(kr1 + p));
        dot0 = fmaf(qa, k0.x, dot0);
        dot0 = fmaf(qb, k0.y, dot0);
        dot1 = fmaf(qa, k1.x, dot1);
        dot1 = fmaf(qb, k1.y, dot1);
      }
      const bool live0 = lane < n_live && (!causal || t0 + lane <= qpos);
      const bool live1 =
          lane + 32 < n_live && (!causal || t0 + lane + 32 <= qpos);
      const float s0 = live0 ? dot0 : -INFINITY;
      const float s1 = live1 ? dot1 : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      if (m_new == -INFINITY) continue;        // no live key yet in this row
      const float p0 = live0 ? expf(s0 - m_new) : 0.0f;
      const float p1 = live1 ? expf(s1 - m_new) : 0.0f;
      const float alpha = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p0 + p1);
#pragma unroll
      for (int c = 0; c < kDpl; ++c) acc[i][c] *= alpha;
      const int n_pv = causal ? min(n_live, qpos - t0 + 1) : n_live;
      for (int j = 0; j < n_pv; ++j) {
        const float p = __shfl_sync(0xffffffffu, j < 32 ? p0 : p1, j & 31);
#pragma unroll
        for (int c = 0; c < kDpl; ++c)
          acc[i][c] = fmaf(p, __bfloat162float(v_s[j * D + lane + 32 * c]),
                           acc[i][c]);
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    const int qi = q0 + r / G;
    if (r >= n_rows || qi >= Sq) continue;
    const int h = kh * G + r % G;
    const float inv_l = 1.0f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* o = out + ((size_t)(b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kDpl; ++c)
      o[lane + 32 * c] = __float2bfloat16_rn(acc[i][c] * inv_l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KH, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  const int G = H / KH;
  const int tq = kRows / G;
  dim3 grid((Sq + tq - 1) / tq, KH, B);
  flash_attention_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, Sq, Skv, H, KH, tq,
      causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k/v (B, Skv, KH, D), out (B, Sq, H, D): contiguous bf16.
// Needs H % KH == 0, H / KH <= 16, D in {32, 64, 128}, q_offset >= 0;
// returns cudaErrorInvalidValue else.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Skv, int H, int KH,
                         int D, int causal, int q_offset, float scale,
                         void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > kRows || q_offset < 0 || B <= 0 ||
      Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return launch<32>(q, k, v, out, B, Sq, Skv, H, KH, causal, q_offset,
                        scale, s);
    case 64:
      return launch<64>(q, k, v, out, B, Sq, Skv, H, KH, causal, q_offset,
                        scale, s);
    case 128:
      return launch<128>(q, k, v, out, B, Sq, Skv, H, KH, causal, q_offset,
                         scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
