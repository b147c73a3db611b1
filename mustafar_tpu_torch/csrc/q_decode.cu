// q8q4 flash-decode attention for Hopper (sm_90a), uniform batch.
//
// Replaces the TPU kernel mustafar_tpu/ops/kernels/quant_attention.py
// fused_q_decode_attention (Pallas body _q_decode_kernel) for the q8q4
// codec, with its options (sliding window, (m, l) stats, window
// probabilities) off.  For one layer `li` of the stacked cache and each
// (batch row b, kv head h) it attends the G = Hq / Hkv query heads of that
// kv head over
//   1. `n_chunks` packed pool chunks of 256 tokens: K as int8 codes (two
//      tokens per int16 row: token t in the low byte of row t, token t+128
//      in the high byte), V as int4 codes (four tokens per int16 row, token
//      t + 64 j in nibble j), both with a bf16 scale per channel.  The K
//      scale folds into q before the scores (scores = bf16(q * kscale) .
//      codes / sqrt(128)); the V scale multiplies each chunk's p.v partial;
//   2. the first `win_len` tokens of the dense bf16 residual window, with q
//      unscaled,
// under one online softmax in f32 (mask value -1e30, final l clamped at
// 1e-30), p rounded to bf16 before the value product as on the TPU.  The
// softmax steps are the TPU kernel's: one per chunk, then one per window
// tile of `wt` tokens, so the running max, and with it the bf16 rounding
// of p, is the same at every step.
//
// What bounds it on this card: bytes.  Per layer it must read
//   B*Hkv*(n_chunks*192*128*2 + 2*win_len*128*2) bytes (+ q, scales, out),
// about 6.4 MB at B=8, Hkv=8, two chunks: some 2 us at 3.35 TB/s, against a
// few hundred flops per byte the card could do; a decode kernel this small
// is bound in practice by launch latency and by how few blocks there are.
//
// Design (first, simple version): one block of 256 threads per (b, kv
// head), all G query heads in the block, so each packed byte is read once
// from device memory and reused for G heads.  A loop over chunks and then
// over window tiles takes the place of the TPU's sequential
// grid.  For scores a warp reads one 256-byte K row (two tokens) with one
// 8-byte load per lane and reduces with shuffles; for values each thread
// owns one channel and one half of the tile's tokens and reads its int16
// carrier column, so the loads of a warp are contiguous.  Codes are
// unpacked with sign-extending shifts in registers; dequantized chunks
// never exist in memory.  Split-K over chunks, TMA, wgmma and CUDA graphs
// are later work.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;         // head_dim == lane width
constexpr int CHUNK = 256;     // tokens per packed chunk
constexpr int K_ROWS = 128;    // int8 K: two tokens per int16 row
constexpr int V_ROWS = 64;     // int4 V: four tokens per int16 row
constexpr int ROWS = K_ROWS + V_ROWS;
constexpr int TILE = 256;      // most tokens per online-softmax step
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;
constexpr float SM_SCALE = 0.08838834764831845f;   // 1 / sqrt(128)

static_assert(THREADS == 2 * D, "value role: one channel, two token halves");
static_assert(TILE >= CHUNK, "a chunk is one softmax step");

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int G>
struct __align__(16) Smem {
  float q[G][D];      // query rows (bf16 values)
  float s[G][TILE];   // one tile's scores, then its bf16-rounded probabilities
  float acc[G][D];    // the second token half's accumulator, for the combine
  float m[G];
  float l[G];
  float corr[G];
};

// Online-softmax step over the `ntok` scores in sm.s (written and synced by
// the caller).  Warp g owns head g: new running max, p = exp(s - m_new)
// (summed in f32 into l, stored rounded to bf16 for the value product),
// and the correction factor of the old accumulator.
template <int G>
__device__ __forceinline__ void softmax_step(Smem<G>& sm, int ntok, int warp,
                                             int lane) {
  if (warp < G) {
    const int g = warp;
    float mx = NEG;
    for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, sm.s[g][t]);
    mx = warp_max(mx);
    const float m_old = sm.m[g];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int t = lane; t < ntok; t += 32) {
      const float p = expf(sm.s[g][t] - m_new);
      sm.s[g][t] = round_bf16(p);
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float c = expf(m_old - m_new);
      sm.corr[g] = c;
      sm.l[g] = sm.l[g] * c + sum;
      sm.m[g] = m_new;
    }
  }
  __syncthreads();
}

template <int G>
__global__ void __launch_bounds__(THREADS)
q8q4_decode_kernel(const __nv_bfloat16* __restrict__ q,      // [B*Hkv, G, D]
                   const int16_t* __restrict__ pool,         // [L, mc, BH, ROWS, D]
                   const __nv_bfloat16* __restrict__ scales, // [L, mc, BH, 2, D]
                   const __nv_bfloat16* __restrict__ k_win,  // [L, BH, W, D]
                   const __nv_bfloat16* __restrict__ v_win,  // [L, BH, W, D]
                   void* __restrict__ out,                   // [B*Hkv, G, D]
                   int out_f32, int BH, int max_chunks, int W, int wt,
                   int n_chunks, int win_len, int li) {
  static_assert(G <= WARPS, "one warp per query head in the softmax step");
  __shared__ Smem<G> sm;
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = tid & (D - 1);   // value role: this thread's channel ...
  const int half = tid >> 7;     // ... and half of the tile's tokens

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

  // ---- packed pool chunks -------------------------------------------------
  for (int ci = 0; ci < n_chunks; ++ci) {
    const size_t slot = ((size_t)li * max_chunks + ci) * BH + bh;
    const int16_t* rows = pool + slot * ROWS * D;
    const __nv_bfloat16* ks = scales + slot * 2 * D;
    const __nv_bfloat16* vs = ks + D;

    float qk[G][4];   // bf16(q * kscale) for this lane's four channels
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float ksc = __bfloat162float(ks[4 * lane + j]);
#pragma unroll
      for (int g = 0; g < G; ++g)
        qk[g][j] = round_bf16(sm.q[g][4 * lane + j] * ksc);
    }
    for (int r = warp; r < K_ROWS; r += WARPS) {
      const uint2 raw = *reinterpret_cast<const uint2*>(rows + r * D + 4 * lane);
      const uint32_t words[2] = {raw.x, raw.y};
      float lo[G], hi[G];
#pragma unroll
      for (int g = 0; g < G; ++g) lo[g] = hi[g] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = (int)(int16_t)(words[j >> 1] >> (16 * (j & 1)));
        const float c_lo = (float)(int8_t)(x & 0xff);   // token r
        const float c_hi = (float)(x >> 8);             // token r + 128
#pragma unroll
        for (int g = 0; g < G; ++g) {
          lo[g] += qk[g][j] * c_lo;
          hi[g] += qk[g][j] * c_hi;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float a = warp_sum(lo[g]);
        const float b = warp_sum(hi[g]);
        if (lane == 0) {
          sm.s[g][r] = a * SM_SCALE;
          sm.s[g][r + K_ROWS] = b * SM_SCALE;
        }
      }
    }
    __syncthreads();
    softmax_step<G>(sm, CHUNK, warp, lane);

    const int16_t* vrows = rows + K_ROWS * D;
    const float vsc = __bfloat162float(vs[d]);
    float pv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) pv[g] = 0.f;
    for (int r = half * (V_ROWS / 2); r < (half + 1) * (V_ROWS / 2); ++r) {
      const uint32_t w = (uint32_t)(int)vrows[r * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float c = (float)((int)(w << (28 - 4 * j)) >> 28);   // token r + 64 j
#pragma unroll
        for (int g = 0; g < G; ++g) pv[g] += sm.s[g][r + V_ROWS * j] * c;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = acc[g] * sm.corr[g] + pv[g] * vsc;
    __syncthreads();   // the next step overwrites sm.s and sm.corr
  }

  // ---- dense residual window ----------------------------------------------
  const __nv_bfloat16* kw = k_win + ((size_t)li * BH + bh) * W * D;
  const __nv_bfloat16* vw = v_win + ((size_t)li * BH + bh) * W * D;
  float qr[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float4 v4 = *reinterpret_cast<const float4*>(&sm.q[g][4 * lane]);
    qr[g][0] = v4.x;
    qr[g][1] = v4.y;
    qr[g][2] = v4.z;
    qr[g][3] = v4.w;
  }
  for (int t0 = 0; t0 < win_len; t0 += wt) {
    const int nt = min(wt, win_len - t0);
    for (int t = warp; t < nt; t += WARPS) {
      const uint2 raw =
          *reinterpret_cast<const uint2*>(kw + (size_t)(t0 + t) * D + 4 * lane);
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
    for (int t = tb; t < te; ++t) {
      const float vv = __bfloat162float(vw[(size_t)(t0 + t) * D + d]);
#pragma unroll
      for (int g = 0; g < G; ++g) pv[g] += sm.s[g][t] * vv;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = acc[g] * sm.corr[g] + pv[g];
    __syncthreads();
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
void launch(const void* q, const void* pool, const void* scales,
            const void* k_win, const void* v_win, void* out, int out_f32,
            int BH, int max_chunks, int W, int wt, int n_chunks, int win_len,
            int li, cudaStream_t stream) {
  q8q4_decode_kernel<G><<<BH, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int16_t*>(pool),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<const __nv_bfloat16*>(k_win),
      static_cast<const __nv_bfloat16*>(v_win),
      out, out_f32, BH, max_chunks, W, wt, n_chunks, win_len, li);
}

}  // namespace

// q [B, 1, Hkv*G, 128] bf16; pool [L, mc, B*Hkv, 192, 128] int16;
// scales [L, mc, B*Hkv, 2, 128] bf16; k_win / v_win [L, B*Hkv, W, 128] bf16;
// out [B, 1, Hkv*G, 128] f32 if `out_f32`, else bf16.  All contiguous;
// shapes checked by the caller.  `device` is the ordinal the tensors and the
// stream belong to; `wt` the window tokens per softmax step (1..256).
extern "C" int q8q4_decode(const void* q, const void* pool, const void* scales,
                           const void* k_win, const void* v_win, void* out,
                           int out_f32, int device, int BH, int G, int max_chunks, int W,
                           int wt, int n_chunks, int win_len, int li,
                           void* stream) {
  if (wt < 1 || wt > TILE) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: launch<1>(q, pool, scales, k_win, v_win, out, out_f32, BH, max_chunks, W, wt, n_chunks, win_len, li, s); break;
    case 2: launch<2>(q, pool, scales, k_win, v_win, out, out_f32, BH, max_chunks, W, wt, n_chunks, win_len, li, s); break;
    case 4: launch<4>(q, pool, scales, k_win, v_win, out, out_f32, BH, max_chunks, W, wt, n_chunks, win_len, li, s); break;
    case 8: launch<8>(q, pool, scales, k_win, v_win, out, out_f32, BH, max_chunks, W, wt, n_chunks, win_len, li, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
