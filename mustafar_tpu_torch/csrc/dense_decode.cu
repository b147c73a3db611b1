// Dense flash-decode attention for Hopper (sm_90a), split-K.
//
// Replaces the TPU kernel mustafar_tpu/ops/kernels/dense_decode.py
// flash_decode_attention (Pallas body _flash_decode_kernel), with its
// final (m, l) stats (return_norm: the merge writes them) and its sliding
// window.  For each (batch row b,
// kv head h) the G = Hq / Hkv query heads of that kv head attend the
// post-append cache rows [0, pos] (pos the newest token's index: one
// scalar, or read per slot from a device array; a slot at -1 attends
// nothing and comes out 0); with a sliding window (window > 0) only the
// rows past pos - window: [lo, pos] with lo = max(pos - window + 1, 0).
// Scores q . k / sqrt(128) in f32 from bf16 q and K; softmax in f32 (mask
// value -1e30, final l clamped at 1e-30), p rounded to bf16 before the
// value product, accumulated in f32.
//
// What bounds it on this card: bytes.  It must read (pos + 1) * Hkv * 128
// * 2 bytes of K and as many of V for each batch row: 19.7 MB at B=8,
// Hkv=8, pos 599 (5.9 us at 3.35 TB/s), against 4 flops a byte for G=4,
// so the products stay on the CUDA cores.
//
// Design.  The TPU walks a row's tiles in order on one core; a first port
// did the same with one block per (b, kv head), 64 blocks for 132 SMs at
// B=8, each walking 19 softmax steps of 32 tokens in series.  Here the
// tokens are cut into splits of `split_len` consecutive rows and the grid
// covers (b, kv head, split):
//   - The rule (ops/kernels/dense_decode.py split_len): 128 tokens a split
//     where the grid then holds at least four blocks an SM, else 64.  A
//     uniform call sizes the grid from the host's pos (600 tokens: 10
//     splits of 64, 640 blocks); a per-slot call from S, with no host sync
//     (S = 8,448: 66 splits of 128), and blocks past the slot's pos exit
//     at once.  A block of 128 tokens stages 64 KB, three an SM, so a grid
//     under four an SM runs in about one wave, and halving the splits puts
//     twice the blocks, six an SM, in flight; a longer grid keeps 128,
//     half the partials to write and merge.  Measured on an H100 (PERF.md
//     §6): 64 took 5 % off the uniform case, 128 3 % off the per-slot.
//   - A block stages its K rows and then its V rows into shared memory with
//     16-byte cp.async copies (rows are 256 bytes at a stride of Hkv * 256),
//     both in flight at once, so V arrives while the scores are computed.
//   - Scores for all G heads of the kv head (each byte read once for G
//     heads): warp w takes rows w, w + 8, ..., lane l channels 4l..4l+3,
//     reduced over the warp.  One softmax step over the split
//     (softmax_step.cuh).  The value product in the same layout, each warp
//     over its rows; the eight warps' sums are added in a tree in the (now
//     free) K tile.
//   - The block writes its partials (acc[G][128], m[G], l[G]) in f32 to the
//     scratch the wrapper passes (kept from call to call, its size checked
//     here); a second kernel, launched on the same
//     stream by the same entry, merges each (b, kv head)'s live splits in
//     split order (split_merge.cuh).
// Each split rounds p at its own running max, and the merge rescales in
// f32, so the kernel no longer repeats the TPU's step-by-step arithmetic;
// flash_decode_attention_split_plain is its plain version.  TMA and
// programmatic dependent launch of the merge are later work.
//
// The sliding window.  The TPU masks the scores of rows at or below pos -
// window to -1e30 in every tile it walks; a tile wholly below the window
// runs masked (p = exp(0) = 1 from m = -1e30) and the next live tile's
// correction exp(-1e30 - m) = 0 wipes it.  Here a split wholly below the
// window exits before it reads anything, and the merge skips it (Live); the
// split that holds lo stages and attends only its rows [lo, ...), so every
// split the merge reads has a live row and no step of -1e30 scores exists
// (an -inf there would give -inf - -inf = NaN).  A window costs the bytes
// of the rows it keeps.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_stage.cuh"
#include "softmax_step.cuh"
#include "split_merge.cuh"

namespace dense {

using online_softmax::softmax_step;
using online_softmax::warp_sum;

constexpr int D = 128;
constexpr int MIN_SPLIT = 64;      // the red tree below needs 64 K rows at G = 8
constexpr int MAX_SPLIT = 128;     // most tokens a block stages
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;
constexpr float SM_SCALE = 0.08838834764831845f;   // 1 / sqrt(128)

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <int G>
struct __align__(16) Smem {
  float s[G][MAX_SPLIT];   // the split's scores, then its bf16-rounded probabilities
  float m[G];
  float l[G];
  float corr[G];
};

// The rows a slot at `pos` attends: [lo, n_tok), n_tok = min(pos + 1, S)
// (0 for an idle slot), lo = max(pos - window + 1, 0) with a sliding
// window (window > 0), else 0.
__device__ __forceinline__ void slot_rows(int pos, int window, int S, int& lo, int& n_tok) {
  n_tok = min(max(pos + 1, 0), S);
  lo = window > 0 ? max(pos - window + 1, 0) : 0;
}

// Which splits row bh attends, for the merge: those that hold a row of
// [lo, n_tok), [lo / split_len, ceil(n_tok / split_len)).
struct Live {
  const int* pos_slot;
  int pos, hkv, S, split_len, window;
  __device__ void operator()(int bh, int& f, int& a, int& c, int& n) const {
    const int p = pos_slot != nullptr ? pos_slot[bh / hkv] : pos;
    int lo, n_tok;
    slot_rows(p, window, S, lo, n_tok);
    f = a = 0;
    c = n_tok > 0 ? lo / split_len : 0;
    n = (n_tok + split_len - 1) / split_len - c;
  }
};

// Copies `nt` token rows of 256 bytes, `stride` elements apart in device
// memory, into consecutive rows of shared memory: 16 bytes a thread.
__device__ __forceinline__ void stage_tokens(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             int nt, size_t stride, int tid) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  for (int i = tid; i < nt * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = i % (D / 8);
    smem::cp_async16(base + 16u * i, src + r * stride + 8 * c);
  }
  smem::cp_async_commit();
}

template <int G>
__global__ void __launch_bounds__(THREADS)
dense_split_kernel(const __nv_bfloat16* __restrict__ q,   // [B*Hkv, G, D]
                   const __nv_bfloat16* __restrict__ k,   // [B, S, Hkv, D]
                   const __nv_bfloat16* __restrict__ v,   // [B, S, Hkv, D]
                   float* __restrict__ part,              // split_merge layout
                   const int* __restrict__ pos_slot,      // [B] or null
                   int BH, int hkv, int S, int split_len, int n_splits, int pos,
                   int window) {
  static_assert(G <= WARPS, "one warp per query head in the softmax step");
  // dynamic shared memory: Smem, then the K tile and the V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<G>& sm = *reinterpret_cast<Smem<G>*>(smem_raw);
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(smem_raw + sizeof(Smem<G>));
  __nv_bfloat16* vt = kt + (size_t)split_len * D;
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int b = bh / hkv;
  const int h = bh % hkv;
  if (pos_slot != nullptr) pos = pos_slot[b];
  int lo, n_tok;                               // rows [lo, pos]; an idle slot none
  slot_rows(pos, window, S, lo, n_tok);
  const int t_end = min((split + 1) * split_len, n_tok);
  const int t0 = max(split * split_len, lo);   // the window's edge may cut a split
  if (t0 >= t_end) return;                     // not live: the merge skips it
  const int nt = t_end - t0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = (size_t)hkv * D;          // elements from one token to the next
  const size_t at = ((size_t)b * S + t0) * row + (size_t)h * D;
  stage_tokens(kt, k + at, nt, row, tid);
  stage_tokens(vt, v + at, nt, row, tid);

  float qr[G][4];                              // bf16 q of this lane's channels
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint2 raw =
        __ldg(reinterpret_cast<const uint2*>(q + ((size_t)bh * G + g) * D + 4 * lane));
    qr[g][0] = bf16_lo(raw.x);
    qr[g][1] = bf16_hi(raw.x);
    qr[g][2] = bf16_lo(raw.y);
    qr[g][3] = bf16_hi(raw.y);
  }
  if (tid < G) {
    sm.m[tid] = NEG;
    sm.l[tid] = 0.f;
  }
  smem::cp_async_wait<1>();     // this thread's K copies have landed
  __syncthreads();              // ... and every thread's

#pragma unroll 4
  for (int t = warp; t < nt; t += WARPS) {
    const uint2 raw = *reinterpret_cast<const uint2*>(kt + (size_t)t * D + 4 * lane);
    const float kf[4] = {bf16_lo(raw.x), bf16_hi(raw.x), bf16_lo(raw.y), bf16_hi(raw.y)};
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
  softmax_step<G>(sm, nt, warp, lane);   // ends in __syncthreads
  smem::cp_async_wait<0>();
  __syncthreads();

  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
#pragma unroll 4
  for (int t = warp; t < nt; t += WARPS) {
    const uint2 raw = *reinterpret_cast<const uint2*>(vt + (size_t)t * D + 4 * lane);
    const float vf[4] = {bf16_lo(raw.x), bf16_hi(raw.x), bf16_lo(raw.y), bf16_hi(raw.y)};
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = sm.s[g][t];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][j] += p * vf[j];
    }
  }

  // ---- sum the eight warps' accumulators: a tree in the K tile ------------
  float4* red = reinterpret_cast<float4*>(kt);   // [WARPS / 2][G][D / 4]
  for (int half = WARPS / 2; half > 0; half >>= 1) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        red[((warp - half) * G + g) * (D / 4) + lane] =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 o = red[(warp * G + g) * (D / 4) + lane];
        acc[g][0] += o.x;
        acc[g][1] += o.y;
        acc[g][2] += o.z;
        acc[g][3] += o.w;
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
    float4* pa =
        reinterpret_cast<float4*>(part + split_merge::acc_at(bh, split, G, n_splits));
#pragma unroll
    for (int g = 0; g < G; ++g)
      pa[g * (D / 4) + lane] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  if (tid < G) {
    float* ml = part + split_merge::ml_at(bh, split, G, n_splits, BH) + 2 * tid;
    ml[0] = sm.m[tid];
    ml[1] = sm.l[tid];
  }
}

template <int G>
int launch(const void* q, const void* k, const void* v, void* out, float* ml,
           const int* pos_slot, float* part, int out_f32, int device, int BH, int hkv, int S,
           int split_len, int n_splits, int pos, int window, cudaStream_t stream) {
  const int bytes =
      (int)(sizeof(Smem<G>) + 2 * (size_t)split_len * D * sizeof(__nv_bfloat16));
  cudaError_t err = smem::allow_dynamic_smem<dense_split_kernel<G>>(bytes, device);
  if (err != cudaSuccess) return (int)err;
  dense_split_kernel<G><<<dim3(BH, n_splits), THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), part, pos_slot, BH, hkv, S, split_len,
      n_splits, pos, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)split_merge::launch_merge(part, out, out_f32, BH, G, n_splits,
                                        Live{pos_slot, pos, hkv, S, split_len, window}, stream,
                                        ml);
}

}  // namespace dense

// q [B, 1, Hkv*G, 128] bf16; k / v [B, S, Hkv, 128] bf16; out like q, f32 if
// `out_f32`, else bf16; ml null, or f32 [2, B*Hkv*G] for the final (m, l)
// (split_merge.cuh); pos_slot [B] int32 on the card, or null for the
// scalar `pos`; scratch f32, `scratch_floats` of them, refused if fewer
// than split_merge::scratch_floats(BH, G, n_splits).  All contiguous;
// shapes checked by the caller.  `device` is the ordinal
// the tensors and the stream belong to; `split_len` the tokens a split
// (64..128); `n_splits` the grid's splits: at least ceil(S / split_len) per
// slot, ceil((pos + 1) / split_len) (and 1) for a scalar pos.  `window`
// the sliding window (rows past pos - window), or 0 for none.
extern "C" int dense_decode(const void* q, const void* k, const void* v, void* out,
                            void* ml, const void* pos_slot, void* scratch, int scratch_floats,
                            int out_f32, int device, int BH, int hkv, int G, int S,
                            int split_len, int n_splits, int pos, int window,
                            void* stream) {
  using namespace dense;
  const int covered = pos_slot != nullptr ? S : pos + 1 < 0 ? 0 : pos + 1 > S ? S : pos + 1;
  if (split_len < MIN_SPLIT || split_len > MAX_SPLIT || hkv < 1 || BH % hkv ||
      n_splits < 1 || (long long)n_splits * split_len < covered || scratch == nullptr ||
      G < 1 || scratch_floats < 0 || window < 0 ||
      (size_t)scratch_floats < split_merge::scratch_floats(BH, G, n_splits))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ps = static_cast<const int*>(pos_slot);
  float* part = static_cast<float*>(scratch);
#define DENSE_LAUNCH(g) \
  return launch<g>(q, k, v, out, static_cast<float*>(ml), ps, part, out_f32, device, BH, hkv, S, split_len, \
                   n_splits, pos, window, s)
  switch (G) {
    case 1: DENSE_LAUNCH(1);
    case 2: DENSE_LAUNCH(2);
    case 4: DENSE_LAUNCH(4);
    case 8: DENSE_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DENSE_LAUNCH
}
