// The bitmap flash-decode kernel body of the per-slot entry sp_decode_ps
// (sp_decode.cu), whose note there says what it computes and what bounds
// it.  Block bh reads slot bh / hkv's counts from the device arrays.
// Templated on the value width QBITS (bitmap_expand.cuh): at 8 bits the
// expanded values are int8 codes, and each chunk's scales fold in as in
// the quant kernels (quant_decode.cuh): the scores' q is bf16(q * kscale),
// and a warp's value product is multiplied by the V scale before it joins
// the accumulator.  The grid's y dimension is the split: split s < mc
// takes pool chunk s, split mc + j window tile j; so each block takes one
// softmax step, from a fresh state, and its accumulator is that step's
// value product (acc * 0 + pv, bit for bit).  A block writes its
// unnormalised partials to scratch (split_merge.cuh), or nothing if its
// chunk or tile lies past the slot's counts, and merge_kernel combines
// them; with window probabilities asked for, a window split also stores
// its raw scores (split_merge.cuh).  A sliding window (window > 0) as in
// quant_decode.cuh: a chunk split wholly at or below its slot's edge exits
// before it stages anything, the edge's split scores its dead columns
// -1e30.  (The uniform entry sp_decode has its own body, on
// decode_tile.cuh.)
//
// Layout of the work: one block of 8 warps per (b, kv head) and split, all
// G query heads of the kv head in the block, so each packed byte is read
// once and serves G heads.  Each chunk's stream is copied into shared
// memory (cp.async; the loop would double-buffer a block of more than one
// chunk, which a split never has).  A warp takes
// token rows t = warp, warp + 8, ...; its lane l holds channels l + 32 i of
// the row, expanded from the staged stream (bitmap_expand.cuh), so no
// expanded tile exists in memory:
//   scores  a row's four channels times q, reduced over the warp;
//   values  each lane keeps a partial accumulator for its four channels
//           over the warp's rows, rescaled by every step's correction;
// the eight partial accumulators are summed once, at the end.  The softmax
// steps (one per chunk, then window tiles of `wt`) are the quant kernels'
// (softmax_step.cuh).

#pragma once

#include "bitmap_expand.cuh"
#include "softmax_step.cuh"
#include "split_merge.cuh"

namespace bitmap_decode {

using bitmap::CHUNK;
using bitmap::D;
using bitmap::Fmt;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 256;      // most tokens per online-softmax step
constexpr float NEG = -1e30f;
constexpr float SM_SCALE = 0.08838834764831845f;   // 1 / sqrt(128)

template <int G>
struct __align__(16) Smem {
  float s[G][TILE];   // one step's scores, then its bf16-rounded probabilities
  float red[G][D];    // the warps' accumulators, summed at the end
  float m[G];
  float l[G];
  float corr[G];
};

// Blocks an SM the split instance is built for (80 registers a thread): its
// blocks are many and one step long, so residency is what fills the card
// (sp_decode.cu's note).  G = 8 keeps what it needs (142-168 registers).
constexpr int split_min_blocks(int G) { return G <= 4 ? 3 : 1; }

template <int G, int QBITS>
__global__ void __launch_bounds__(THREADS, split_min_blocks(G))
sp_decode_kernel(const __nv_bfloat16* __restrict__ q,      // [B*Hkv, G, D]
                 const int16_t* __restrict__ pool,         // [L, mc, BH, KR+VR, D]
                 const __nv_bfloat16* __restrict__ scales, // [L, mc, BH, 2, D] (8 bits)
                 const __nv_bfloat16* __restrict__ k_win,  // [L, BH, W, D]
                 const __nv_bfloat16* __restrict__ v_win,  // [L, BH, W, D]
                 void* __restrict__ out,                   // [B*Hkv, G, D]
                 int out_f32, int BH, int max_chunks, int W, int wt,
                 int n_chunks, int win_len, int li, Fmt<QBITS> kf, Fmt<QBITS> vf,
                 const int* __restrict__ nc_slot,          // [B] or null
                 const int* __restrict__ wl_slot,          // [B] or null
                 int hkv,
                 float* __restrict__ part,                 // split_merge layout
                 int n_splits,
                 split_merge::SlotProbs sp,                // window probabilities
                                                           // (sp.out null: off)
                 int window) {                             // sliding window, 0: none
  static_assert(G <= WARPS, "one warp per query head in the softmax step");
  // dynamic shared memory: Smem, then one or two buffers of one chunk's
  // stream (two where a block attends more than one chunk)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<G>& sm = *reinterpret_cast<Smem<G>*>(smem_raw);
  int16_t* stage = reinterpret_cast<int16_t*>(smem_raw + sizeof(Smem<G>));
  const int bh = blockIdx.x;
  if (nc_slot != nullptr) {
    // per-slot counts, clamped into range (the host cannot check device
    // counts without a sync); an idle slot arrives as (0, 0), and the upper
    // clamps can only bite when a compaction was missed
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

  float qr[G][4];                // bf16 q of this lane's four channels
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qr[g][i] = __bfloat162float(q[((size_t)bh * G + g) * D + lane + 32 * i]);
  if (tid < G) {
    sm.m[tid] = NEG;
    sm.l[tid] = 0.f;
  }
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  __syncthreads();

  // scores of one row (v = its expanded K) against the query rows qv, for
  // every head, into sm.s[.][t]
  auto score_row = [&](const float (&qv)[G][4], const float (&v)[4], int t) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s += qv[g][i] * v[i];
      s = online_softmax::warp_sum(s);
      if (lane == 0) sm.s[g][t] = s * SM_SCALE;
    }
  };
  // acc = acc * corr + (this warp's share of) bf16(p) . V, after a step; a
  // split block takes one step, so acc * corr is 0 and acc = pv
  auto rescale_add = [&](const float (&pv)[G][4]) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[g][i] = pv[g][i];
  };

  // ---- packed pool chunks -------------------------------------------------
  const int rows = kf.rows() + vf.rows();
  auto chunk = [&](int ci) {
    return pool + (((size_t)li * max_chunks + ci) * BH + bh) * rows * D;
  };
  if (c0 < c1) bitmap::stage_rows_async(stage, chunk(c0), rows, tid, THREADS);
  for (int ci = c0; ci < c1; ++ci) {
    if (ci + 1 < c1) {
      bitmap::stage_rows_async(stage + (size_t)((ci + 1 - c0) & 1) * rows * D,
                               chunk(ci + 1), rows, tid, THREADS);
      bitmap::cp_async_wait<1>();
    } else {
      bitmap::cp_async_wait<0>();
    }
    __syncthreads();   // chunk ci is in shared memory for every thread
    const int16_t* kst = stage + (size_t)((ci - c0) & 1) * rows * D;
    const int16_t* vst = kst + (size_t)kf.rows() * D;
    // 8 bits: the chunk's scales of this lane's four channels, and the
    // scores' q rounded to bf16 after the K scale
    float qk[G][4], vsc[4];
    if constexpr (QBITS == 8) {
      const __nv_bfloat16* ks = scales + (((size_t)li * max_chunks + ci) * BH + bh) * 2 * D;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ksc = __bfloat162float(ks[lane + 32 * i]);
        vsc[i] = __bfloat162float(ks[D + lane + 32 * i]);
#pragma unroll
        for (int g = 0; g < G; ++g) qk[g][i] = online_softmax::round_bf16(qr[g][i] * ksc);
      }
    }
    // rows t0 + j * WARPS, ROWS_IN_FLIGHT of them back to back
    constexpr int NR = bitmap::ROWS_IN_FLIGHT;
    for (int t0 = warp; t0 < CHUNK; t0 += NR * WARPS) {
      float v[NR][4];
#pragma unroll
      for (int j = 0; j < NR; ++j) bitmap::expand_row(kst, kf, t0 + j * WARPS, lane, v[j]);
#pragma unroll
      for (int j = 0; j < NR; ++j) score_row(QBITS == 8 ? qk : qr, v[j], t0 + j * WARPS);
    }
    __syncthreads();
    const int lowc = low - ci * CHUNK;   // the edge's split: columns 0 .. lowc masked
    if (lowc >= 0) {
      for (int i = tid; i < G * (lowc + 1); i += THREADS) sm.s[i / (lowc + 1)][i % (lowc + 1)] = NEG;
      __syncthreads();
    }
    online_softmax::softmax_step<G>(sm, CHUNK, warp, lane);

    float pv[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g) pv[g][0] = pv[g][1] = pv[g][2] = pv[g][3] = 0.f;
    for (int t0 = warp; t0 < CHUNK; t0 += NR * WARPS) {
      float v[NR][4];
#pragma unroll
      for (int j = 0; j < NR; ++j) bitmap::expand_row(vst, vf, t0 + j * WARPS, lane, v[j]);
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = sm.s[g][t0 + j * WARPS];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[g][i] += p * v[j][i];
        }
    }
    if constexpr (QBITS == 8) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[g][i] *= vsc[i];
    }
    rescale_add(pv);
    __syncthreads();   // the next step overwrites sm.s, sm.corr and this buffer
  }

  // ---- dense residual window ----------------------------------------------
  const __nv_bfloat16* kw = k_win + ((size_t)li * BH + bh) * W * D;
  const __nv_bfloat16* vw = v_win + ((size_t)li * BH + bh) * W * D;
  for (int t0 = w0; t0 < w1; t0 += wt) {
    const int nt = min(wt, w1 - t0);
    for (int t = warp; t < nt; t += WARPS) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = __bfloat162float(kw[(size_t)(t0 + t) * D + lane + 32 * i]);
      score_row(qr, v, t);
    }
    __syncthreads();
    if (sp.out != nullptr) {   // the raw scores, for the window probabilities
      split_merge::store_win_scores<G>(sm.s, sp, bh, t0, nt, tid, THREADS);
      __syncthreads();
    }
    online_softmax::softmax_step<G>(sm, nt, warp, lane);

    float pv[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g) pv[g][0] = pv[g][1] = pv[g][2] = pv[g][3] = 0.f;
    for (int t = warp; t < nt; t += WARPS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = __bfloat162float(vw[(size_t)(t0 + t) * D + lane + 32 * i]);
#pragma unroll
        for (int g = 0; g < G; ++g) pv[g][i] += sm.s[g][t] * v;
      }
    }
    rescale_add(pv);
    __syncthreads();
  }

  // ---- sum the warps' accumulators and normalise --------------------------
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sm.red[g][lane + 32 * i] = (w ? sm.red[g][lane + 32 * i] : 0.f) + acc[g][i];
    }
    __syncthreads();
  }
  float* pa = part + split_merge::acc_at(bh, split, G, n_splits);
  for (int i = tid; i < G * D; i += THREADS) pa[i] = sm.red[i / D][i % D];
  if (tid < G) {
    float* ml = part + split_merge::ml_at(bh, split, G, n_splits, BH) + 2 * tid;
    ml[0] = sm.m[tid];
    ml[1] = sm.l[tid];
  }
}

// Checks the launch parameters, selects the instance for the group size G
// and returns cudaGetLastError(): a grid of max_chunks chunk splits and
// ceil(W / wt) window splits per row, its partials in `part`, then the
// merge.
template <int QBITS>
int launch_decode(const void* q, const void* pool, const void* scales,
                  const void* k_win, const void* v_win, void* out, int out_f32,
                  int device, int BH, int G, int max_chunks, int W, int wt,
                  int n_chunks, int win_len, int li, Fmt<QBITS> kf, Fmt<QBITS> vf,
                  const int* nc_slot, const int* wl_slot, int hkv, float* part,
                  int n_splits, void* probs, int window, void* stream) {
  if (wt < 1 || wt > TILE || BH < 1 || max_chunks < 0 || W < 0 || li < 0 || window < 0 ||
      (QBITS == 8) != (scales != nullptr))
    return (int)cudaErrorInvalidValue;
  if (part == nullptr || nc_slot == nullptr || n_splits != max_chunks + (W + wt - 1) / wt)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a split block stages one chunk
  const size_t stage_bytes = (size_t)(kf.rows() + vf.rows()) * D * sizeof(int16_t);
  const dim3 grid(BH, n_splits);
  const split_merge::SlotProbs sp = split_merge::slot_probs(probs, part, BH, G, n_splits, W);
  cudaError_t err = cudaSuccess;
#define SP_INSTANCE(g)                                                        \
  {                                                                           \
    const int bytes = (int)(sizeof(Smem<g>) + stage_bytes);                   \
    err = smem::allow_dynamic_smem<sp_decode_kernel<g, QBITS>>(bytes, device);\
    if (err != cudaSuccess) return (int)err;                                  \
    sp_decode_kernel<g, QBITS><<<grid, THREADS, bytes, s>>>(                  \
        static_cast<const __nv_bfloat16*>(q),                                 \
        static_cast<const int16_t*>(pool),                                    \
        static_cast<const __nv_bfloat16*>(scales),                            \
        static_cast<const __nv_bfloat16*>(k_win),                             \
        static_cast<const __nv_bfloat16*>(v_win), out, out_f32, BH,           \
        max_chunks, W, wt, n_chunks, win_len, li, kf, vf, nc_slot, wl_slot,   \
        hkv, part, n_splits, sp, window);                                     \
  }
  switch (G) {
    case 1: SP_INSTANCE(1); break;
    case 2: SP_INSTANCE(2); break;
    case 4: SP_INSTANCE(4); break;
    case 8: SP_INSTANCE(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SP_INSTANCE
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)split_merge::launch_merge_probs(
      part, out, out_f32, BH, G, n_splits,
      split_merge::SlotLive{nc_slot, wl_slot, hkv, max_chunks, W, wt, window}, s, sp);
}

// The formats (k0, k1) and (vk0, vk1) at `qbits` bits, checked, and the
// instance of that width.
inline int launch_bits(int qbits, int k0, int k1, int vk0, int vk1, const void* q,
                       const void* pool, const void* scales, const void* k_win,
                       const void* v_win, void* out, int out_f32, int device, int BH,
                       int G, int max_chunks, int W, int wt, int n_chunks,
                       int win_len, int li, const int* nc_slot, const int* wl_slot,
                       int hkv, float* part, int n_splits, void* probs, int window,
                       void* stream) {
#define SP_BITS(b)                                                                 \
  {                                                                                \
    bool k_ok, v_ok;                                                               \
    const Fmt<b> kf = bitmap::make_fmt<b>(k0, k1, &k_ok);                          \
    const Fmt<b> vf = bitmap::make_fmt<b>(vk0, vk1, &v_ok);                         \
    if (!k_ok || !v_ok) return (int)cudaErrorInvalidValue;                         \
    return launch_decode<b>(q, pool, scales, k_win, v_win, out, out_f32, device,  \
                            BH, G, max_chunks, W, wt, n_chunks, win_len, li, kf,  \
                            vf, nc_slot, wl_slot, hkv, part, n_splits, probs,     \
                            window, stream);                                       \
  }
  if (qbits == 16) SP_BITS(16);
  if (qbits == 8) SP_BITS(8);
#undef SP_BITS
  return (int)cudaErrorInvalidValue;
}

}  // namespace bitmap_decode
