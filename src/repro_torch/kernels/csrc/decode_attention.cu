// Cached-decode GQA attention for Hopper (sm_90a): K4.
//
// Replaces the Pallas TPU kernel `_decode_kernel` of
// src/repro/kernels/decode_attention.py.  It computes
//   ref.attention(q, k, v, causal=True, q_offset, kv_len)
// for q (B, Sq, H, D) against a KV-cache buffer k/v (B, S_max, KH, D), all
// bf16, with the softmax in f32 and the output in bf16: key t is live for the
// query row at absolute position q_offset[b] + i iff t <= q_offset[b] + i and
// t < kv_len[b].
//
// The TPU kernel carried the online-softmax state (m, l, acc) in VMEM scratch
// across a sequential grid axis over KV blocks.  Blocks run in parallel here,
// so the KV loop runs inside one thread block: a CTA takes one (batch, kv
// head, tile of query positions) and all G = H / KH query heads that share
// that kv head, so each K/V tile is staged in shared memory once for G heads
// (16 query rows per CTA: 16 / G positions).  Each of the 4 warps owns 4 rows
// and keeps their running max, sum and output accumulator (D / 32 values per
// lane) in registers, in f32.  Tiles of 64 keys at or past the CTA's last live
// key (min(kv_len, last query position + 1)) are never loaded; inside a tile
// both masks apply key by key.  No atomics: every sum runs in a fixed order,
// so results repeat bit for bit from run to run.
//
// Bound: on the serve path (decode: Sq = 1, a cache of ~80 keys) the kernel
// reads q, the live prefix of K and V once and writes the output: a few
// hundred KB, so each launch is bound by launch latency and device-memory
// bytes, not by operations (2 * G * D FLOPs per key and head group).  Making
// it fast (wgmma, TMA, split-KV across CTAs for long caches) is later work.
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
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ kv_len,
                        const int* __restrict__ q_offset,
                        __nv_bfloat16* __restrict__ out,
                        int Sq, int H, int KH, int S_max, int tq,
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

  const int kvl = kv_len[b];
  const int qoff = q_offset[b];
  const int q_last = min(q0 + tq, Sq) - 1;
  const int kend = min(min(kvl, qoff + q_last + 1), S_max);

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
        const size_t off = ((size_t)(b * S_max + t) * KH + kh) * D + c * 8;
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
      const int qpos = qoff + qi;

      float s[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        const int t = t0 + j;
        const uint32_t* kr = k_s + j * kKStride;
        float dot = 0.0f;
#pragma unroll
        for (int p = 0; p < D / 2; ++p) {
          const __nv_bfloat162 kk =
              *reinterpret_cast<const __nv_bfloat162*>(kr + p);
          const float2 kf = __bfloat1622float2(kk);
          dot = fmaf(q_s[r][2 * p], kf.x, dot);
          dot = fmaf(q_s[r][2 * p + 1], kf.y, dot);
        }
        const bool live = j < n_live && t <= qpos && t < kvl;
        s[jj] = live ? dot : -INFINITY;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[0], s[1])));
      if (m_new == -INFINITY) continue;        // no live key yet in this row
      const float p0 = s[0] == -INFINITY ? 0.0f : expf(s[0] - m_new);
      const float p1 = s[1] == -INFINITY ? 0.0f : expf(s[1] - m_new);
      const float alpha = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p0 + p1);
#pragma unroll
      for (int c = 0; c < kDpl; ++c) acc[i][c] *= alpha;
      for (int j = 0; j < n_live; ++j) {
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
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           const void* q_offset, void* out, int B, int Sq, int H, int KH,
           int S_max, float scale, cudaStream_t stream) {
  const int G = H / KH;
  const int tq = kRows / G;
  dim3 grid((Sq + tq - 1) / tq, KH, B);
  decode_attention_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)kv_len, (const int*)q_offset,
      (__nv_bfloat16*)out, Sq, H, KH, S_max, tq, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k/v (B, S_max, KH, D), out (B, Sq, H, D): contiguous bf16.
// kv_len, q_offset: (B,) int32 on the device.  Needs H % KH == 0,
// H / KH <= 16 and D in {32, 64, 128}; returns cudaErrorInvalidValue else.
int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* kv_len, const void* q_offset, void* out,
                          int B, int Sq, int H, int KH, int D, int S_max,
                          float scale, void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > kRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return launch<32>(q, k, v, kv_len, q_offset, out, B, Sq, H, KH, S_max,
                        scale, s);
    case 64:
      return launch<64>(q, k, v, kv_len, q_offset, out, B, Sq, H, KH, S_max,
                        scale, s);
    case 128:
      return launch<128>(q, k, v, kv_len, q_offset, out, B, Sq, H, KH, S_max,
                         scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
