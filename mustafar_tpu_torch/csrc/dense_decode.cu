// Dense flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel mustafar_tpu/ops/kernels/dense_decode.py
// flash_decode_attention (Pallas body _flash_decode_kernel), with its
// options (sliding window, final (m, l) stats) off.  For each (batch row b,
// kv head h) the G = Hq / Hkv query heads of that kv head attend the
// post-append cache rows [0, pos] (pos the newest token's index: one
// scalar, or read per slot from a device array; a slot at -1 attends
// nothing and comes out 0).  Scores q . k / sqrt(128) in f32 from bf16 q
// and K; one online softmax (mask value -1e30, final l clamped at 1e-30)
// in steps of `ts` tokens, the TPU kernel's tiles, so the running max, and
// with it the bf16 rounding of p before the value product, is the same at
// every step.  Tokens past pos in the last tile are not read: on the TPU
// they are masked to p = 0, which adds nothing.
//
// What bounds it on this card: bytes.  It must read (pos + 1) * Hkv * 128
// * 2 bytes of K and as many of V for each batch row: 19.7 MB at B=8,
// Hkv=8, pos 599 (5.9 us at 3.35 TB/s), against 4 flops a byte for G=4.
//
// Design (first, simple version), the window loop of the quant decode
// kernel (quant_decode.cuh) over the dense cache: one block of 256 threads
// per (b, kv head), all G query heads in the block, so each K and V byte is
// read once from device memory and used for G heads; a loop over tiles
// takes the place of the TPU's sequential grid.  For scores a warp reads
// one 256-byte K row with an 8-byte load per lane and reduces with
// shuffles; for values each thread owns one channel and one half of the
// tile's tokens, so a warp's loads are 64 contiguous bytes a token.  The
// softmax step is softmax_step.cuh's.  Split-K over tiles (64 blocks fill
// half the card at B=8), TMA and tensor-core products are later work.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "softmax_step.cuh"

namespace dense {

using online_softmax::softmax_step;
using online_softmax::warp_sum;

constexpr int D = 128;
constexpr int TILE = 512;      // most tokens per online-softmax step
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;
constexpr float SM_SCALE = 0.08838834764831845f;   // 1 / sqrt(128)

static_assert(THREADS == 2 * D, "value role: one channel, two token halves");

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <int G>
struct __align__(16) Smem {
  float q[G][D];      // query rows (bf16 values)
  float s[G][TILE];   // one tile's scores, then its bf16-rounded probabilities
  float acc[G][D];    // the second token half's accumulator, for the combine
  float m[G];
  float l[G];
  float corr[G];
};

template <int G>
__global__ void __launch_bounds__(THREADS)
dense_decode_kernel(const __nv_bfloat16* __restrict__ q,   // [B*Hkv, G, D]
                    const __nv_bfloat16* __restrict__ k,   // [B, S, Hkv, D]
                    const __nv_bfloat16* __restrict__ v,   // [B, S, Hkv, D]
                    void* __restrict__ out,                // [B*Hkv, G, D]
                    const int* __restrict__ pos_slot,      // [B] or null
                    int out_f32, int hkv, int S, int ts, int pos) {
  static_assert(G <= WARPS, "one warp per query head in the softmax step");
  __shared__ Smem<G> sm;
  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int h = bh % hkv;
  if (pos_slot != nullptr) pos = pos_slot[b];
  const int n_tok = min(max(pos + 1, 0), S);   // rows [0, pos]; an idle slot none
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = tid & (D - 1);   // value role: this thread's channel ...
  const int half = tid >> 7;     // ... and half of the tile's tokens
  const size_t row = (size_t)hkv * D;   // elements from one token to the next

  for (int i = tid; i < G * D; i += THREADS)
    sm.q[i / D][i % D] = __bfloat162float(q[(size_t)bh * G * D + i]);
  if (tid < G) {
    sm.m[tid] = NEG;
    sm.l[tid] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  __syncthreads();

  float qr[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float4 v4 = *reinterpret_cast<const float4*>(&sm.q[g][4 * lane]);
    qr[g][0] = v4.x;
    qr[g][1] = v4.y;
    qr[g][2] = v4.z;
    qr[g][3] = v4.w;
  }
  const __nv_bfloat16* kb = k + (size_t)b * S * row + (size_t)h * D;
  const __nv_bfloat16* vb = v + (size_t)b * S * row + (size_t)h * D;

  for (int t0 = 0; t0 < n_tok; t0 += ts) {
    const int nt = min(ts, n_tok - t0);
#pragma unroll 4
    for (int t = warp; t < nt; t += WARPS) {
      const uint2 raw =
          __ldg(reinterpret_cast<const uint2*>(kb + (size_t)(t0 + t) * row + 4 * lane));
      const float kf[4] = {bf16_lo(raw.x), bf16_hi(raw.x), bf16_lo(raw.y),
                           bf16_hi(raw.y)};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) s += qr[g][j] * kf[j];
        s = warp_sum(s);
        if (lane == 0) sm.s[g][t] = s * SM_SCALE;
      }
    }
    __syncthreads();
    softmax_step<G>(sm, nt, warp, lane);

    float pv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) pv[g] = 0.f;
    const int hn = (nt + 1) / 2;
    const int tb = half * hn;
    const int te = min(nt, tb + hn);
#pragma unroll 4
    for (int t = tb; t < te; ++t) {
      const float vv = __bfloat162float(vb[(size_t)(t0 + t) * row + d]);
#pragma unroll
      for (int g = 0; g < G; ++g) pv[g] += sm.s[g][t] * vv;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = acc[g] * sm.corr[g] + pv[g];
    __syncthreads();   // the next step overwrites sm.s and sm.corr
  }

  // ---- combine the two token halves and normalise -------------------------
  if (half == 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) sm.acc[g][d] = acc[g];
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float o = (acc[g] + sm.acc[g][d]) / fmaxf(sm.l[g], 1e-30f);
      const size_t at = ((size_t)bh * G + g) * D + d;
      if (out_f32)
        static_cast<float*>(out)[at] = o;
      else
        static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(o);
    }
  }
}

template <int G>
void launch(const void* q, const void* k, const void* v, void* out, const int* pos_slot,
            int out_f32, int BH, int hkv, int S, int ts, int pos, cudaStream_t stream) {
  dense_decode_kernel<G><<<BH, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, pos_slot, out_f32, hkv, S, ts, pos);
}

}  // namespace dense

// q [B, 1, Hkv*G, 128] bf16; k / v [B, S, Hkv, 128] bf16; out like q, f32 if
// `out_f32`, else bf16; pos_slot [B] int32 on the card, or null for the
// scalar `pos`.  All contiguous; shapes checked by the caller.  `device` is
// the ordinal the tensors and the stream belong to; `ts` the tokens per
// softmax step (1..512).
extern "C" int dense_decode(const void* q, const void* k, const void* v, void* out,
                            const void* pos_slot, int out_f32, int device, int BH,
                            int hkv, int G, int S, int ts, int pos, void* stream) {
  using namespace dense;
  if (ts < 1 || ts > TILE || hkv < 1 || BH % hkv) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ps = static_cast<const int*>(pos_slot);
#define DENSE_LAUNCH(g) launch<g>(q, k, v, out, ps, out_f32, BH, hkv, S, ts, pos, s)
  switch (G) {
    case 1: DENSE_LAUNCH(1); break;
    case 2: DENSE_LAUNCH(2); break;
    case 4: DENSE_LAUNCH(4); break;
    case 8: DENSE_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DENSE_LAUNCH
  return (int)cudaGetLastError();
}
