// The pieces the uniform-batch decode kernels share (q_decode.cu for the
// quant codecs, sp_decode.cu's entry sp_decode for the bitmap codecs):
// one CTA takes one softmax step of one (b, kv head) row from a fresh
// state and writes the step's unnormalised partials (acc, m, l) in
// split_merge.cuh's layout; the last CTA of the row to finish merges the
// row's partials in split order (finish_row).  What a CTA computes its
// scores and values over differs by codec (the kernels' own files); a
// window tile is the same for both: `wt` dense bf16 window tokens, staged
// into padded shared rows (stage_window) and attended by tile_scores and
// tile_pv.
//
// The counts on the device (the TPU kernels' scalar prefetch of n_chunks
// and win_len): every CTA reads the call's two int32 counts from device
// memory (read_counts, clamped into [0, mc] and [0, W]), so one launch,
// and a CUDA graph that holds it, serves every step of a decode.  The grid
// is sized on the host from mc and W alone (grid_steps): per row, every
// pool step the pool can hold, then every window tile the window can hold.
// CTA y of a row takes the row's y-th live step (the pool steps past a
// sliding window's edge, then the window tiles that hold tokens) and
// writes its partials at index y; a CTA past the live steps exits at once,
// having read the two counts and nothing else, and takes no part in the
// merge: each live CTA counts itself in on the row's counter, and the one
// that brings it to the row's live steps merges them (finish_row) and
// resets it.  With nothing to attend (no live step) the row's first CTA
// writes what the merge of no split gives: the output 0, the window
// probabilities 0, m = -1e30 and l = 0 (empty_row).
//
// Window probabilities (the TPU kernels' return_win_probs, for the Opa
// policies): each window-tile CTA stores its raw f32 scores into scratch
// beside the partials (store_win_scores), and the row's last CTA, once it
// has merged the final (m, l), writes per window column c
//   sum_g exp(s_g[c] - m_g) / max(l_g, 1e-30)   (0 at and past win_len),
// the heads summed in order, l summed as the merge's plain version sums it
// (products and sums rounded one by one).  The final (m, l) themselves (the
// TPU kernels' return_norm): the same CTA writes M and that l (unclamped)
// for each query head.
//
// Scores are summed in one fixed order that the plain version repeats:
// four lanes a token, each summing a quarter of the channels (32 j ..
// 32 j + 31) in channel order with one f32 rounding a product added
// (every product is exact: bf16(q) or bf16(q * kscale) times a bf16 value
// or an integer code of 8 or fewer bits has at most 16 significant bits),
// then (s0 + s1) + (s2 + s3).  So a score is the plain version's bit for
// bit (quant_attention._scores, ordered); with f32 sums in two orders a
// score could differ by an ulp and move a bf16(p) across a rounding
// boundary, a change of 2^-8 of that token's weight (measured with mma.sync
// scores against a product in f32, on an NVIDIA H100 80GB HBM3: 1.05 of
// chip_smoke's split gate at one case).  The value product runs on
// mma.sync m16n8k16 with the G query rows padded to 16: bf16(p) and the
// values are bf16 numbers, so only its f32 sums run in another order, and
// they move no rounding boundary of p.  Fragments (lane = 4 gid + tig): A
// row gid (a query head; rows G..15 are zero), columns 2 tig, 2 tig + 1
// and 2 tig + 8, 2 tig + 9; B column gid, rows likewise; C row gid,
// columns 2 tig, 2 tig + 1.
//
// The sliding window (the TPU kernels' `window`, Mistral): a call at
// n_chunks chunks and win_len window tokens decodes the token at position
// n_chunks * 256 + win_len - 1, which attends pool column c iff c > low =
// n_chunks * 256 + win_len - 1 - window.  The TPU runs every chunk with
// the masked scores at -1e30 (a chunk wholly masked comes first and the
// next live step's correction exp(-1e30 - m) = 0 wipes it).  Here the live
// steps leave out the pool steps wholly at or below low (Window::first):
// none of their bytes are read.  The step that holds low + 1 sets
// its masked scores to -1e30 before its softmax step (mask_scores), so
// every pool step the merge reads has a live column and a real max, and a
// masked column's p is exp(-1e30 - m) = 0.  The window tiles are never
// masked: the cache keeps the window at least its capacity (as on the TPU).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "smem_stage.cuh"
#include "softmax_step.cuh"
#include "split_merge.cuh"

namespace uniform_decode {

constexpr int D = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LD = D + 8;           // a staged 16-bit row: 256 bytes + 16 of padding,
                                    // so that 8 rows' fragment loads miss each other's banks
constexpr int MAX_STEP = 256;       // most tokens one softmax step takes (a chunk)
constexpr int MAX_WT = 256;         // most window tokens a step (the entries refuse more)
constexpr float NEG = -1e30f;
constexpr float SM_SCALE = 0.08838834764831845f;   // 1 / sqrt(128)

constexpr int QPAD = 36;            // floats of a query quarter in shared memory (32 + 4
                                    // of padding, so that the four quarters' loads miss banks)

template <int G>
struct __align__(16) Smem {
  float s[G][MAX_STEP + 4];   // one step's scores, then bf16(p); the rows padded
                              // so that the value product's A loads miss banks
  float qd[G][4][QPAD];       // the scores' query rows, by channel quarter
  float m[G];
  float l[G];
  float corr[G];
  int last;                   // this CTA is the last of its row to finish
};

__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }

// Bytes of a window tile's K and V rows in shared memory.
__host__ __device__ constexpr int window_bytes(int wt) {
  return 2 * round8(wt) * LD * 2;
}

// Two f32 values that are bf16 numbers packed as bf16x2, low first: their
// bits' upper halves, no conversion.
__device__ __forceinline__ uint32_t pack_exact_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// An integer |c| < 2^22 as f32, without a conversion instruction.
__device__ __forceinline__ float small_int_f32(int c) {
  return __int_as_float(0x4B400000 + c) - 12582912.0f;   // 1.5 * 2^23
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The scores' query rows into sm.qd: bf16(q) of the kv head's G heads
// (q_row [G, 128] bf16), or bf16(bf16(q) * kscale) with `kscale` (bf16
// [128]) given.  The caller syncs before the scores read them.
template <int G>
__device__ __forceinline__ void stage_q(Smem<G>& sm, const __nv_bfloat16* __restrict__ q_row,
                                        const __nv_bfloat16* __restrict__ kscale, int tid) {
  for (int i = tid; i < G * D; i += THREADS) {
    const int c = i % D;
    float x = __bfloat162float(q_row[i]);
    if (kscale != nullptr) x = online_softmax::round_bf16(x * __bfloat162float(kscale[c]));
    sm.qd[i / D][c / 32][c % 32] = x;
  }
}

// Channels 4 h .. 4 h + 3 of head g's query quarter `tig`.
template <int G>
__device__ __forceinline__ float4 q_quad(const Smem<G>& sm, int g, int tig, int h) {
  return *reinterpret_cast<const float4*>(&sm.qd[g][tig][4 * h]);
}

// Sums a token's four quarters (lanes 4 gid .. 4 gid + 3) as (s0 + s1) +
// (s2 + s3) and writes its scores times 1/sqrt(128) to sm.s[g][t] (lane
// tig writes heads g = tig mod 4), if t < n.  f32 addition commutes, so
// every lane of the quad holds the same sum.
template <int G>
__device__ __forceinline__ void put_scores(Smem<G>& sm, float (&acc)[G], int t, int n,
                                           int tig) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], 1);
    acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], 2);
    if (g % 4 == tig && t < n) sm.s[g][t] = acc[g] * SM_SCALE;
  }
}

// Scores of the n tokens of the bf16 K tile `kt` (rows of LD) against
// sm.qd into sm.s[g][0, n): a warp takes 8 tokens at a time, 4 lanes a
// token.  Rows past n up to round8(n) are read and dropped.
template <int G>
__device__ __forceinline__ void tile_scores(Smem<G>& sm, const __nv_bfloat16* kt, int n,
                                            int warp, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  for (int t0 = 8 * warp; t0 < n; t0 += 8 * WARPS) {
    const int t = t0 + gid;
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    const uint4* row = reinterpret_cast<const uint4*>(kt + t * LD + 32 * tig);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 w = row[j];
      const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // channels 8 j + 4 h .. + 3
        const float k[4] = {bf16_lo(wv[2 * h]), bf16_hi(wv[2 * h]), bf16_lo(wv[2 * h + 1]),
                            bf16_hi(wv[2 * h + 1])};
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 qq = q_quad(sm, g, tig, 2 * j + h);
          acc[g] = fmaf(qq.x, k[0], acc[g]);
          acc[g] = fmaf(qq.y, k[1], acc[g]);
          acc[g] = fmaf(qq.z, k[2], acc[g]);
          acc[g] = fmaf(qq.w, k[3], acc[g]);
        }
      }
    }
    put_scores<G>(sm, acc, t, n, tig);
  }
}

// bf16(p) . V over the n tokens of the bf16 V tile `vt` (rows of LD): this
// warp's channels 16 warp + 8 j + (2 tig, 2 tig + 1) of head gid in
// acc[j][0..1].  Tokens past n take p = 0 and V = 0 (their shared rows are
// never read).
template <int G>
__device__ __forceinline__ void tile_pv(float (&acc)[2][4], const Smem<G>& sm,
                                        const __nv_bfloat16* vt, int n, int warp, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const uint16_t* v16 = reinterpret_cast<const uint16_t*>(vt);
  auto p = [&](int t) { return gid < G && t < n ? sm.s[gid][t] : 0.f; };
  auto v = [&](int t, int ch) { return t < n ? (uint32_t)v16[t * LD + ch] : 0u; };
  for (int k0 = 0; k0 < n; k0 += 16) {
    const int t = k0 + 2 * tig;
    const uint32_t a0 = pack_exact_bf16(p(t), p(t + 1));
    const uint32_t a2 = pack_exact_bf16(p(t + 8), p(t + 9));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ch = 16 * warp + 8 * j + gid;
      mma_bf16(acc[j], a0, 0u, a2, 0u, v(t, ch) | v(t + 1, ch) << 16,
               v(t + 8, ch) | v(t + 9, ch) << 16);
    }
  }
}

// Issues the cp.async copies of window tokens [0, n) of one row's K and V
// (k_win / v_win at the row's first token, [.., 128] bf16, a token every
// `stride` elements) into the tiles kt and vt (rows of LD), 16 bytes a
// thread, as one group.
__device__ __forceinline__ void stage_window(__nv_bfloat16* kt, __nv_bfloat16* vt,
                                             const __nv_bfloat16* kw,
                                             const __nv_bfloat16* vw, int n, int tid,
                                             size_t stride = D) {
  const int units = n * (D / 8);   // 16-byte pieces of one tile
  for (int i = tid; i < 2 * units; i += THREADS) {
    const int j = i < units ? i : i - units;
    const int r = j / (D / 8), u = j % (D / 8);
    const __nv_bfloat16* src = (i < units ? kw : vw) + (size_t)r * stride + 8 * u;
    __nv_bfloat16* dst = (i < units ? kt : vt) + r * LD + 8 * u;
    smem::cp_async16(smem::smem_addr(dst), src);
  }
  smem::cp_async_commit();
}

// The window probabilities' outputs: `out` f32 [BH, W] (null: off) and the
// raw window scores in scratch, `ws` f32 [BH, G, W], right after the
// partials (at split_merge::scratch_floats(BH, G, n_parts)); and the final
// stats' output `ml` f32 [2][BH*G] (m, then l; null: off).
struct WinProbs {
  float* out;
  float* ws;
  int W;
  int win_len;
  float* ml;
};

// A window-tile CTA's raw scores sm.s[g][0, n) to ws at columns w0 .. w0 +
// n - 1; the caller syncs before softmax_step overwrites sm.s.
template <int G>
__device__ __forceinline__ void store_win_scores(const Smem<G>& sm, const WinProbs& wp,
                                                 int bh, int w0, int n, int tid) {
  for (int i = tid; i < G * n; i += THREADS) {
    const int g = i / n, t = i % n;
    wp.ws[((size_t)bh * G + g) * wp.W + w0 + t] = sm.s[g][t];
  }
}

// A fresh state for one softmax step.
template <int G>
__device__ __forceinline__ void fresh_state(Smem<G>& sm, int tid) {
  if (tid < G) {
    sm.m[tid] = NEG;
    sm.l[tid] = 0.f;
  }
}

// Writes this CTA's partials as split `sp` of row bh (the scratch laid
// out for n_parts splits a row, the grid's): acc (times the V scale
// `vscale` [128] bf16, if given) and the step's m and l.
template <int G>
__device__ __forceinline__ void write_partial(float* __restrict__ part, int bh, int sp,
                                              int n_parts, int BH, const float (&acc)[2][4],
                                              const __nv_bfloat16* __restrict__ vscale,
                                              const Smem<G>& sm, int warp, int lane,
                                              int tid) {
  const int gid = lane >> 2, tig = lane & 3;
  if (gid < G) {
    float* pa = part + split_merge::acc_at(bh, sp, G, n_parts) + gid * D;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ch = 16 * warp + 8 * j + 2 * tig;
      float2 o = make_float2(acc[j][0], acc[j][1]);
      if (vscale != nullptr) {
        o.x *= __bfloat162float(vscale[ch]);
        o.y *= __bfloat162float(vscale[ch + 1]);
      }
      *reinterpret_cast<float2*>(pa + ch) = o;
    }
  }
  if (tid < G) {
    float* ml = part + split_merge::ml_at(bh, sp, G, n_parts, BH) + 2 * tid;
    ml[0] = sm.m[tid];
    ml[1] = sm.l[tid];
  }
}

// The fused merge: after write_partial, each live CTA of row bh counts
// itself in on counters[bh] (one acq_rel atomic a CTA by thread 0, after a
// block barrier: it releases the CTA's partials at gpu scope and acquires
// the other CTAs'); the last of the row's n_live live CTAs (splits 0 ..
// n_live - 1 of a scratch laid out for n_parts a row) resets the counter
// for the next launch and merges the row's partials in split order as
// split_merge::merge_kernel does (M = max m, w = exp(m - M), out = sum w
// acc / max(sum w l, 1e-30)), so the result is the same bits whichever CTA
// ends last.  (Merging in a second launch of merge_kernel instead took
// 2.6 us more for the quant kernel and 1.2 us more for the bitmap one at
// B=8, 1 chunk + 288 window, and as long at 5 chunks; NVIDIA H100 80GB
// HBM3, 700.00 W, tools/kernel_ab.py.)  `ws` is shared
// memory for 2 * n_live * G floats that the CTA no longer needs.  With
// `wp.out` the last CTA writes the row's window probabilities too, with
// `wp.ml` its final (m, l).
template <int G>
__device__ __forceinline__ void finish_row(const float* __restrict__ part,
                                           int* __restrict__ counters, void* __restrict__ out,
                                           int out_f32, int bh, int n_live, int n_parts,
                                           int BH, Smem<G>& sm, float* ws, int tid,
                                           const WinProbs& wp) {
  __syncthreads();
  if (tid == 0) {
    int done;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(done) : "l"(counters + bh) : "memory");
    sm.last = done == n_live - 1;
    if (sm.last) counters[bh] = 0;
  }
  __syncthreads();
  if (!sm.last) return;
  float* w = ws;                    // [n_live][G]: m, then exp(m - M)
  float* l = ws + n_live * G;       // [n_live][G]
  for (int i = tid; i < n_live * G; i += THREADS) {
    const float* ml = part + split_merge::ml_at(bh, i / G, G, n_parts, BH) + 2 * (i % G);
    w[i] = __ldcg(ml);
    l[i] = __ldcg(ml + 1);
  }
  __syncthreads();
  if (tid < G) {
    float M = NEG;
    for (int sp = 0; sp < n_live; ++sp) M = fmaxf(M, w[sp * G + tid]);
    for (int sp = 0; sp < n_live; ++sp) w[sp * G + tid] = expf(w[sp * G + tid] - M);
    if (wp.out != nullptr || wp.ml != nullptr) {   // the final (m, l)
      float L = 0.f;
      for (int sp = 0; sp < n_live; ++sp)
        L = __fadd_rn(L, __fmul_rn(l[sp * G + tid], w[sp * G + tid]));
      sm.m[tid] = M;
      sm.l[tid] = fmaxf(L, 1e-30f);
      if (wp.ml != nullptr) {
        wp.ml[(size_t)bh * G + tid] = M;
        wp.ml[(size_t)BH * G + (size_t)bh * G + tid] = L;
      }
    }
  }
  __syncthreads();
  if (wp.out != nullptr) {
    for (int c = tid; c < wp.W; c += THREADS) {
      float pr = 0.f;
      if (c < wp.win_len) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          pr += expf(__ldcg(wp.ws + ((size_t)bh * G + g) * wp.W + c) - sm.m[g]) / sm.l[g];
      }
      wp.out[(size_t)bh * wp.W + c] = pr;
    }
  }
  // each thread's PER outputs (channel-major i = tid + THREADS * e) together,
  // so that their loads are in flight at once
  constexpr int PER = (G * D + THREADS - 1) / THREADS;
  if (tid >= G * D) return;
  float num[PER], den[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) num[e] = den[e] = 0.f;
  const float* acc0 = part + split_merge::acc_at(bh, 0, G, n_parts) + tid;
#pragma unroll 4
  for (int sp = 0; sp < n_live; ++sp) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int g = (tid + THREADS * e) / D;
      const float wt = w[sp * G + g];
      num[e] += __ldcg(acc0 + (size_t)sp * G * D + THREADS * e) * wt;
      den[e] += l[sp * G + g] * wt;
    }
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const float o = num[e] / fmaxf(den[e], 1e-30f);
    const size_t at = (size_t)bh * G * D + tid + THREADS * e;
    if (out_f32)
      static_cast<float*>(out)[at] = o;
    else
      static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(o);
  }
}

// A call's sliding window: `low` the newest masked pool column (-1: none)
// and `first` the first pool step, of `step` tokens, that the grid takes
// (quant_attention.masked_steps).  `window` 0 is none.
struct Window {
  int low;
  int first;
};

__host__ __device__ inline Window window_of(int n_chunks, int win_len, int window, int step) {
  if (window <= 0) return Window{-1, 0};
  const int low = n_chunks * 256 + win_len - 1 - window;
  const int first = (low + 1 > 0 ? low + 1 : 0) / step;
  const int steps = n_chunks * (256 / step);
  return Window{low, first < steps ? first : steps};
}

// Splits a row of the grid: every pool step of `step` tokens that
// max_chunks chunks hold, then every window tile of `wt` tokens that W
// holds (quant_attention.uniform_grid).
__host__ __device__ inline int grid_steps(int max_chunks, int W, int wt, int step) {
  return max_chunks * (256 / step) + (W + wt - 1) / wt;
}

// A call's counts as every CTA reads them: n_chunks and win_len from
// device memory, clamped into [0, max_chunks] and [0, W]; the sliding
// window's edge at them; the live pool steps (those past the edge) and
// the live steps in all, window tiles with tokens included.
struct Counts {
  int n_chunks;
  int win_len;
  Window wn;
  int pool_steps;
  int n_live;
};

__device__ __forceinline__ Counts read_counts(const int* __restrict__ n_chunks,
                                              const int* __restrict__ win_len, int max_chunks,
                                              int W, int wt, int window, int step) {
  Counts c;
  c.n_chunks = min(max(*n_chunks, 0), max_chunks);
  c.win_len = min(max(*win_len, 0), W);
  c.wn = window_of(c.n_chunks, c.win_len, window, step);
  c.pool_steps = c.n_chunks * (256 / step) - c.wn.first;
  c.n_live = c.pool_steps + (c.win_len + wt - 1) / wt;
  return c;
}

// A row with nothing to attend: what the merge of no split gives, written
// by the row's first CTA (the others exit unread): the output 0, the
// window probabilities 0 and the final (m, l) = (-1e30, 0).
template <int G>
__device__ __forceinline__ void empty_row(void* __restrict__ out, int out_f32, int bh, int BH,
                                          const WinProbs& wp, int tid) {
  for (int i = tid; i < G * D; i += THREADS) {
    const size_t at = (size_t)bh * G * D + i;
    if (out_f32)
      static_cast<float*>(out)[at] = 0.f;
    else
      static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(0.f);
  }
  if (wp.out != nullptr)
    for (int c = tid; c < wp.W; c += THREADS) wp.out[(size_t)bh * wp.W + c] = 0.f;
  if (wp.ml != nullptr && tid < G) {
    wp.ml[(size_t)bh * G + tid] = NEG;
    wp.ml[(size_t)BH * G + (size_t)bh * G + tid] = 0.f;
  }
}

// The scores of a pool step's columns at or below `low` (its first low + 1
// - c0 tokens, c0 the step's first pool column, c0 <= low) set to -1e30;
// the caller syncs before the softmax step reads them.
template <int G>
__device__ __forceinline__ void mask_scores(Smem<G>& sm, int c0, int low, int tid) {
  const int n = low + 1 - c0;
  for (int i = tid; i < G * n; i += THREADS) sm.s[i / n][i % n] = NEG;
}

// The checks both entries share: the count pointers given, a grid of at
// most split_merge::MAX_SPLITS splits a row, the scratch (with the window
// scores' room when `probs`) and the counters long enough.  n_parts is the
// grid's splits a row (grid_steps); the counts themselves are read and
// clamped on the device.
inline bool args_ok(int BH, int G, int W, int wt, int li, int n_parts, const void* n_chunks,
                    const void* win_len, const void* scratch, long long scratch_floats,
                    const void* counters, int n_counters, const void* probs) {
  const size_t need = split_merge::scratch_floats(BH, G, n_parts) +
                      (probs != nullptr ? (size_t)BH * G * W : 0);
  return BH >= 1 && G >= 1 && W >= 0 && wt >= 1 && wt <= MAX_WT && li >= 0 &&
         n_parts >= 1 && n_parts <= split_merge::MAX_SPLITS && n_chunks != nullptr &&
         win_len != nullptr && scratch != nullptr && scratch_floats >= 0 &&
         (size_t)scratch_floats >= need && counters != nullptr && n_counters >= BH;
}

// The WinProbs of a launch: `probs` (null: off) and the scores' scratch,
// and `ml` (null: off); the kernel sets win_len from the counts it reads.
inline WinProbs win_probs(void* probs, void* ml, float* part, int BH, int G, int n_parts,
                          int W) {
  return WinProbs{static_cast<float*>(probs),
                  part + split_merge::scratch_floats(BH, G, n_parts), W, 0,
                  static_cast<float*>(ml)};
}

}  // namespace uniform_decode
