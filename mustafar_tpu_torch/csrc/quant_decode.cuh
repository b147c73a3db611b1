// The quant-codec flash-decode kernel body of the per-slot entry
// (q_decode_ps.cu), whose header note says what it computes and what
// bounds it.  It is templated on the codec's bit widths (KB, VB) in
// {(8, 8), (8, 4), (4, 4)}: codecs q8, q8q4 and q4q4.  Block bh reads slot
// bh / hkv's counts from the device arrays.  The grid's y dimension is the
// split: split s < mc takes pool chunk s, split mc + j window tile j; so
// each block takes one softmax step, from a fresh state, and its
// accumulator is that step's value product (acc * 0 + pv, bit for bit).  A
// block writes its unnormalised partials to scratch (split_merge.cuh), or
// nothing if its chunk or tile lies past the slot's counts, and
// merge_kernel combines them.  With window probabilities asked for, a
// window split also stores its raw scores (split_merge.cuh).  With a
// sliding window (window > 0) a chunk split wholly at or below its slot's
// edge (split_merge::window_low at the slot's counts) exits before it
// reads anything, and the split that holds the edge scores its columns at
// or below it -1e30 (never -inf: a step's max of -inf would give
// -inf - -inf = NaN); the merge skips the dead splits (SlotLive).  The
// window's own columns are never masked.  (The uniform entry, q_decode.cu,
// has its own body, on decode_tile.cuh.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "softmax_step.cuh"
#include "split_merge.cuh"

namespace qdec {

using online_softmax::round_bf16;
using online_softmax::softmax_step;
using online_softmax::warp_sum;

constexpr int D = 128;         // head_dim == lane width
constexpr int CHUNK = 256;     // tokens per packed chunk
constexpr int TILE = 256;      // most tokens per online-softmax step
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;
constexpr float SM_SCALE = 0.08838834764831845f;   // 1 / sqrt(128)

static_assert(THREADS == 2 * D, "value role: one channel, two token halves");
static_assert(TILE >= CHUNK, "a chunk is one softmax step");

// A chunk at BITS bits a code: 16 / BITS tokens per int16 carrier, token
// t + ROWS * j in field j of row t, so ROWS = CHUNK * BITS / 16 rows.
template <int BITS>
struct Stream {
  static constexpr int FIELDS = 16 / BITS;
  static constexpr int ROWS = CHUNK / FIELDS;
};

// Field j of the int16 carrier `x` (sign-extended to int32), sign-extended.
template <int BITS>
__device__ __forceinline__ float code(int x, int j) {
  return (float)((int)((uint32_t)x << (32 - BITS * (j + 1))) >> (32 - BITS));
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
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

// Blocks an SM the split instance is built for (64 registers a thread at
// G <= 4, no spills): its blocks are many and one step long, so residency
// is what fills the card.  At the engine's mixed slots four blocks an SM
// took 0.0447 ms (q8q4), three 0.0475, two 0.059 (NVIDIA H100 80GB HBM3,
// 700.00 W; q_decode_ps.cu's note).  G = 8 keeps what it needs.
constexpr int split_min_blocks(int G) { return G <= 4 ? 4 : 2; }

template <int G, int KB, int VB>
__global__ void __launch_bounds__(THREADS, split_min_blocks(G))
quant_decode_kernel(const __nv_bfloat16* __restrict__ q,      // [B*Hkv, G, D]
                   const int16_t* __restrict__ pool,         // [L, mc, BH, ROWS, D]
                   const __nv_bfloat16* __restrict__ scales, // [L, mc, BH, 2, D]
                   const __nv_bfloat16* __restrict__ k_win,  // [L, BH, W, D]
                   const __nv_bfloat16* __restrict__ v_win,  // [L, BH, W, D]
                   void* __restrict__ out,                   // [B*Hkv, G, D]
                   int out_f32, int BH, int max_chunks, int W, int wt,
                   int n_chunks, int win_len, int li,
                   const int* __restrict__ nc_slot,          // [B] or null
                   const int* __restrict__ wl_slot,          // [B] or null
                   int hkv,
                   float* __restrict__ part,                 // split_merge layout
                   int n_splits,
                   split_merge::SlotProbs sp,                // window probabilities
                                                             // (sp.out null: off)
                   int window) {                             // sliding window, 0: none
  static_assert(G <= WARPS, "one warp per query head in the softmax step");
  constexpr int KF = Stream<KB>::FIELDS;
  constexpr int K_ROWS = Stream<KB>::ROWS;
  constexpr int VF = Stream<VB>::FIELDS;
  constexpr int V_ROWS = Stream<VB>::ROWS;
  constexpr int ROWS = K_ROWS + V_ROWS;
  __shared__ Smem<G> sm;
  const int bh = blockIdx.x;
  if (nc_slot != nullptr) {
    // per-slot counts: this block's slot b = bh / Hkv reads its own, clamped
    // into range (the host cannot check device counts without a sync); an
    // idle slot arrives as (0, 0), and the upper clamps can only bite when
    // a compaction was missed
    const int b = bh / hkv;
    n_chunks = min(max(nc_slot[b], 0), max_chunks);
    win_len = min(max(wl_slot[b], 0), W);
  }
  // this block's chunks [c0, c1) and window tokens [w0, w1)
  int c0 = 0, c1 = n_chunks, w0 = 0, w1 = win_len;
  const int split = (int)blockIdx.y;
  const int low = split_merge::window_low(n_chunks, win_len, window);
  if (split < max_chunks) {
    c0 = split;
    c1 = c0 < split_merge::first_live_chunk(n_chunks, win_len, window) ? c0
                                                                        : min(c0 + 1, n_chunks);
    w1 = 0;
  } else {
    c1 = 0;
    w0 = (split - max_chunks) * wt;
    w1 = min(w0 + wt, win_len);
  }
  if (c0 >= c1 && w0 >= w1) return;   // not live: the merge skips it
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
  for (int ci = c0; ci < c1; ++ci) {
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
      float part[G][KF];   // token r + K_ROWS * f, this lane's four channels
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int f = 0; f < KF; ++f) part[g][f] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = (int)(int16_t)(words[j >> 1] >> (16 * (j & 1)));
#pragma unroll
        for (int f = 0; f < KF; ++f) {
          const float c = code<KB>(x, f);
#pragma unroll
          for (int g = 0; g < G; ++g) part[g][f] += qk[g][j] * c;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int f = 0; f < KF; ++f) {
          const float a = warp_sum(part[g][f]);
          if (lane == 0) sm.s[g][r + K_ROWS * f] = a * SM_SCALE;
        }
      }
    }
    __syncthreads();
    const int lowc = low - ci * CHUNK;   // the edge's split: columns 0 .. lowc masked
    if (lowc >= 0) {
      for (int i = tid; i < G * (lowc + 1); i += THREADS) sm.s[i / (lowc + 1)][i % (lowc + 1)] = NEG;
      __syncthreads();
    }
    softmax_step<G>(sm, CHUNK, warp, lane);

    const int16_t* vrows = rows + K_ROWS * D;
    const float vsc = __bfloat162float(vs[d]);
    float pv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) pv[g] = 0.f;
    for (int r = half * (V_ROWS / 2); r < (half + 1) * (V_ROWS / 2); ++r) {
      const int x = (int)vrows[r * D + d];
#pragma unroll
      for (int f = 0; f < VF; ++f) {
        const float c = code<VB>(x, f);   // token r + V_ROWS f
#pragma unroll
        for (int g = 0; g < G; ++g) pv[g] += sm.s[g][r + V_ROWS * f] * c;
      }
    }
    // a split block takes one step: acc * corr is 0 and acc = pv * vsc
#pragma unroll
    for (int g = 0; g < G; ++g)
      acc[g] = pv[g] * vsc;
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
  for (int t0 = w0; t0 < w1; t0 += wt) {
    const int nt = min(wt, w1 - t0);
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
    if (sp.out != nullptr) {   // the raw scores, for the window probabilities
      split_merge::store_win_scores<G>(sm.s, sp, bh, t0, nt, tid, THREADS);
      __syncthreads();
    }
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
    for (int g = 0; g < G; ++g) acc[g] = pv[g];
    __syncthreads();
  }

  // ---- combine the two token halves and normalise -------------------------
  if (half == 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) sm.acc[g][d] = acc[g];
  }
  __syncthreads();
  // unnormalised partials: the halves' sum, the step's m and l
  if (half == 0) {
    float* pa = part + split_merge::acc_at(bh, split, G, n_splits);
#pragma unroll
    for (int g = 0; g < G; ++g) pa[g * D + d] = acc[g] + sm.acc[g][d];
  }
  if (tid < G) {
    float* ml = part + split_merge::ml_at(bh, split, G, n_splits, BH) + 2 * tid;
    ml[0] = sm.m[tid];
    ml[1] = sm.l[tid];
  }
}

}  // namespace qdec
