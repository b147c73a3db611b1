// The merge of split-K flash-decode partials, shared by the split decode
// kernels (dense_decode.cu, and the per-slot entries of sp_decode.cu and
// q_decode_ps.cu).
//
// A split kernel's block (row bh = b * Hkv + h, split s) attends its G query
// heads over one run of tokens and writes the unnormalised partials, f32,
// into scratch laid out as
//   acc [BH, n_splits, G, 128], then ml [BH, n_splits, G, 2] (m, l)
// (acc_at / ml_at below).  A block with nothing to attend writes nothing,
// and the scratch is not initialised (the wrappers keep one buffer from
// call to call), so merge_kernel reads only the splits its row attends:
// the caller's Live functor names them as two runs of split indices,
// [f, a) and [c, c + n).  For each (bh, g) it combines them in split
// order as ops/attention.py merge_partials does:
//   M = max_s m_s,  w_s = exp(m_s - M),
//   out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30)
// in f32, written in the caller's dtype.  A row with no live split comes
// out exactly 0 (M = -1e30, both sums 0).  Given `ml_out` (f32 [2][BH*G]),
// the row's final softmax stats go there too: m = M at [bh*G + g] and l =
// sum_s w_s l_s (unclamped) at [BH*G + bh*G + g], the TPU kernel's
// return_norm (a row with no live split: -1e30 and 0).
//
// Layout: one block of 128 threads per (bh, g), one thread a channel.  The
// live splits' m and l go to shared memory first (all loads in flight at
// once), so each thread's pass over the splits waits only on its own acc
// loads, which the unrolled loop keeps several of in flight.
//
// Window probabilities of the per-slot kernels (the TPU kernels'
// return_win_probs, for the Opa policies): each window split stores its
// raw f32 scores into scratch after the partials (store_win_scores; `ws`
// [BH, G, W]), the merge writes the rows' final (m, l) there too (`ml`
// [2][BH*G]), and a third launch, probs_kernel, writes per row bh and
// window column c
//   sum_g exp(ws[bh, g, c] - m_g) / max(l_g, 1e-30)   (0 at and past win_len),
// one block a row, the heads summed in order g = 0, 1, ...: the merge's
// grid is one block per (bh, g), so a sum over g there would cross blocks
// and need atomics, whose order varies from launch to launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "softmax_step.cuh"

namespace split_merge {

constexpr int D = 128;
constexpr int CHUNK = 256;         // tokens of a pool chunk (the per-slot kernels' chunk split)
constexpr float NEG = -1e30f;
constexpr int MAX_SPLITS = 4096;   // 32 KB of m and l in shared memory

// f32 offsets of split s's partials in row bh, and the scratch's size
__host__ __device__ inline size_t acc_at(int bh, int s, int G, int n_splits) {
  return ((size_t)bh * n_splits + s) * G * D;
}
__host__ __device__ inline size_t ml_at(int bh, int s, int G, int n_splits, int BH) {
  return (size_t)BH * n_splits * G * D + ((size_t)bh * n_splits + s) * G * 2;
}
inline size_t scratch_floats(int BH, int G, int n_splits) {
  return (size_t)BH * n_splits * G * (D + 2);
}

template <class Live>
__global__ void __launch_bounds__(D)
merge_kernel(const float* __restrict__ part, void* __restrict__ out, int out_f32,
             int BH, int G, int n_splits, Live live, float* __restrict__ ml_out) {
  extern __shared__ float w_l[];      // [2][n_splits]: m_s, then exp(m_s - M); l_s
  __shared__ float warp_mx[D / 32];
  const int bh = blockIdx.x;
  const int g = blockIdx.y;
  const int d = threadIdx.x;
  int f, a, c, n;
  live(bh, f, a, c, n);
  const int n_first = a - f;
  const int n_live = n_first + n;
  auto split = [&](int i) { return i < n_first ? f + i : c + i - n_first; };

  float mx = NEG;
  for (int i = d; i < n_live; i += D) {
    const float* ml = part + ml_at(bh, split(i), G, n_splits, BH) + 2 * g;
    w_l[i] = ml[0];
    w_l[n_splits + i] = ml[1];
    mx = fmaxf(mx, ml[0]);
  }
  mx = online_softmax::warp_max(mx);
  if ((d & 31) == 0) warp_mx[d >> 5] = mx;
  __syncthreads();
  float M = warp_mx[0];
#pragma unroll
  for (int w = 1; w < D / 32; ++w) M = fmaxf(M, warp_mx[w]);
  for (int i = d; i < n_live; i += D) w_l[i] = expf(w_l[i] - M);
  __syncthreads();

  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int i = 0; i < n_live; ++i) {
    const float w = w_l[i];
    num += part[acc_at(bh, split(i), G, n_splits) + (size_t)g * D + d] * w;
    den += w_l[n_splits + i] * w;
  }
  const float o = num / fmaxf(den, 1e-30f);
  if (ml_out != nullptr && d == 0) {
    ml_out[(size_t)bh * G + g] = M;
    ml_out[(size_t)BH * G + (size_t)bh * G + g] = den;
  }
  const size_t at = ((size_t)bh * G + g) * D + d;
  if (out_f32)
    static_cast<float*>(out)[at] = o;
  else
    static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(o);
}

// The outputs of the per-slot window probabilities: `out` f32 [BH, W]
// (null: off), and in the scratch after the partials the raw window scores
// `ws` [BH, G, W] and the final stats `ml` [2][BH*G].
struct SlotProbs {
  float* out;
  float* ws;
  float* ml;
  int W;
};

// Floats the window probabilities add to a per-slot call's scratch.
inline size_t slot_probs_floats(int BH, int G, int W) {
  return (size_t)BH * G * W + 2 * (size_t)BH * G;
}

// The SlotProbs of a launch: `probs` (null: off) and its scratch.
inline SlotProbs slot_probs(void* probs, float* part, int BH, int G, int n_splits, int W) {
  float* ws = part + scratch_floats(BH, G, n_splits);
  return SlotProbs{static_cast<float*>(probs), ws, ws + (size_t)BH * G * W, W};
}

// A window split's raw scores s[g][0, n) to ws at columns w0 .. w0 + n - 1
// (`threads` threads); the caller syncs before anything overwrites s.
template <int G, int TS>
__device__ __forceinline__ void store_win_scores(const float (&s)[G][TS], const SlotProbs& sp,
                                                 int bh, int w0, int n, int tid, int threads) {
  for (int i = tid; i < G * n; i += threads) {
    const int g = i / n, t = i % n;
    sp.ws[((size_t)bh * G + g) * sp.W + w0 + t] = s[g][t];
  }
}

// The sliding window of the per-slot decode kernels (the TPU kernels'
// rule): a slot at n_chunks chunks and win_len window tokens decodes the
// token at n_chunks * CHUNK + win_len - 1, and its pool column c is live
// iff c > window_low (-1: nothing masked; window 0 is no window).  The
// window's own columns are never masked: the cache keeps the sliding
// window at least the window's capacity.
__host__ __device__ inline int window_low(int n_chunks, int win_len, int window) {
  return window > 0 ? max(n_chunks * CHUNK + win_len - 1 - window, -1) : -1;
}

// The first chunk with a live column: the chunks before it lie wholly at or
// below the window's edge, and their splits exit before they read anything.
__host__ __device__ inline int first_live_chunk(int n_chunks, int win_len, int window) {
  return min(n_chunks, (window_low(n_chunks, win_len, window) + 1) / CHUNK);
}

// Which splits row bh of a per-slot call attends, for the per-slot decode
// kernels (one split a pool chunk, then one a window tile of `wt` tokens):
// the chunk splits [first_live_chunk, n_chunks) and the window splits
// [mc, mc + ceil(win_len / wt)), the slot's counts clamped as the kernels
// clamp them (`window` 0: no sliding window, every chunk split live).
struct SlotLive {
  const int* nc_slot;
  const int* wl_slot;
  int hkv, max_chunks, W, wt, window;
  __device__ void operator()(int bh, int& f, int& a, int& c, int& n) const {
    const int b = bh / hkv;
    a = min(max(nc_slot[b], 0), max_chunks);
    const int wl = win_len(bh);
    f = first_live_chunk(a, wl, window);
    c = max_chunks;
    n = (wl + wt - 1) / wt;
  }
  // row bh's window tokens, clamped
  __device__ int win_len(int bh) const { return min(max(wl_slot[bh / hkv], 0), W); }
};

// The window probabilities of each row (one block of D threads a row, a
// thread a column at a time) from the scores and stats in `sp`.
template <class Live>
__global__ void __launch_bounds__(D)
probs_kernel(SlotProbs sp, int BH, int G, Live live) {
  const int bh = blockIdx.x;
  const int wl = live.win_len(bh);
  const float* m = sp.ml + (size_t)bh * G;
  const float* l = sp.ml + (size_t)BH * G + (size_t)bh * G;
  for (int c = threadIdx.x; c < sp.W; c += D) {
    float pr = 0.f;
    if (c < wl) {
      for (int g = 0; g < G; ++g)
        pr += expf(sp.ws[((size_t)bh * G + g) * sp.W + c] - m[g]) / fmaxf(l[g], 1e-30f);
    }
    sp.out[(size_t)bh * sp.W + c] = pr;
  }
}

// Launches merge_kernel over BH rows of G heads on `stream` (with the final
// stats into `ml_out` when it is not null).
template <class Live>
cudaError_t launch_merge(const float* part, void* out, int out_f32, int BH, int G,
                         int n_splits, Live live, cudaStream_t stream,
                         float* ml_out = nullptr) {
  if (n_splits < 1 || n_splits > MAX_SPLITS) return cudaErrorInvalidValue;
  const int smem = (int)(2 * sizeof(float) * n_splits);
  merge_kernel<Live><<<dim3(BH, G), D, smem, stream>>>(part, out, out_f32, BH, G,
                                                       n_splits, live, ml_out);
  return cudaGetLastError();
}

// The merge, and with `sp.out` the window probabilities after it (the
// final stats into sp.ml, then probs_kernel).
template <class Live>
cudaError_t launch_merge_probs(const float* part, void* out, int out_f32, int BH, int G,
                               int n_splits, Live live, cudaStream_t stream,
                               const SlotProbs& sp) {
  cudaError_t err = launch_merge(part, out, out_f32, BH, G, n_splits, live, stream,
                                 sp.out != nullptr ? sp.ml : nullptr);
  if (err != cudaSuccess || sp.out == nullptr) return err;
  probs_kernel<Live><<<BH, D, 0, stream>>>(sp, BH, G, live);
  return cudaGetLastError();
}

}  // namespace split_merge
