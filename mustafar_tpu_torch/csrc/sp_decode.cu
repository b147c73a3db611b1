// Bitmap flash-decode attention for Hopper (sm_90a): the uniform-batch entry
// sp_decode and the per-slot entry sp_decode_ps, built into one library,
// each with an instance per value width.
//
// sp_decode replaces the TPU kernel
// mustafar_tpu/ops/kernels/sparse_attention.py fused_sparse_decode_attention_v7
// (Pallas body _fused_v7_kernel) for the codecs bitmap (bf16 values, 16
// bits) and bitmap-q8 (int8 codes, 8 bits), with its window probabilities
// (return_win_probs), final (m, l) (return_norm) and sliding window
// (window: the runs of 64 tokens wholly below its edge take no CTA), all
// decode_tile.cuh.  For one layer `li` of
// the stacked cache and each (batch row b, kv head h) it attends the
// G = Hq / Hkv query heads of that kv head over
//   1. `n_chunks` packed pool chunks of 256 tokens, each a K stream then a
//      V stream of bitmap word planes and interleaved value segments
//      (bitmap_expand.cuh): scores = bf16(q) . K / sqrt(128) at 16 bits; at
//      8 bits bf16(bf16(q) * kscale) . codes / sqrt(128), and the value
//      product bf16(p) . codes times the V scale, the scales read per
//      (layer, chunk, b*Hkv + h) from the [L, mc, BH, 2, 128] bf16 tensor;
//   2. the first `win_len` tokens of the dense bf16 residual window,
// in f32 softmax steps from a fresh state each (mask value -1e30, final l
// clamped at 1e-30), p rounded to bf16 before the value product as on the
// TPU, the steps' partials merged in step order.  The steps: each chunk
// cut into CUT = 4 runs of 64 tokens (t in [64 c, 64 c + 64)), then the
// TPU's window tiles of `wt` tokens.  The TPU takes one step a chunk; a
// step of 64 tokens rounds p at its own max, which
// fused_sparse_decode_attention_split_plain repeats (quant_attention.py
// ps_split_steps with cut=4).
//
// What bounds it on this card: bytes, then the expansion's instructions.
// Per layer it must read B*Hkv*(n_chunks*((KR+VR)*128*2 + S) +
// 2*win_len*128*2) bytes (+ q, out), with KR = VR = 96 rows at sparsity
// 0.7 (keep 40 = 32 + 8) and no scales (S = 0) at 16 bits, 56 rows and
// S = 512 bytes of scales at 8 bits: 12.6 MB at 16 bits, B=8, Hkv=8, one
// chunk and a 288-token window, 3.8 us at 3.35 TB/s, and 11.3 MB, 3.4 us,
// at 8.  Expanding a chunk's 512 rows takes four ballots, popcounts and
// gathers a row and lane, some 40,000 warp instructions a chunk.
//
// Design.  The earlier kernel ran the TPU's grid as a loop: one
// block per (b, kv head), 64 blocks for 132 SMs at B=8, each expanding its
// chunks' 512 rows with 8 warps and reducing every row's scores over the
// warp, G reductions a row, then walking its window tiles in series.  It
// took 0.0713 ms at 16 bits and 0.0733 at 8 at B=8, 1 chunk + 288 window,
// G=4 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6); the per-slot kernel's
// one-chunk blocks, the same work, took ~0.055 ms each.  Now:
//   - the grid is exact, sized on the host from the call's counts:
//     (n_chunks * CUT + ceil(win_len / wt)) steps x B*Hkv rows, one CTA of
//     8 warps a step (448 CTAs at that shape), built for three CTAs an SM
//     (two at G = 8), so a chunk's expansion is spread over four CTAs;
//   - a chunk CTA copies only what its 64 tokens need into shared memory,
//     16 bytes a thread with cp.async, every copy in flight before the
//     first expansion: the 16 word planes of each stream and, of each
//     value segment, the rows' one run of lanes that holds these tokens
//     (32 lanes, or k at a segment of width k > 32; 18 KB of a 48 KB
//     chunk at 16 bits); a window CTA its tile's K and V rows
//     (decode_tile.cuh);
//   - one warp expands one token row (ballots over the word planes, ranks
//     by popcount), 8 K and 8 V rows a warp, into bf16 K and V tiles in
//     shared memory (rows padded by 16 bytes); the scores and values then
//     run on mma.sync m16n8k16 over the tiles with the G query rows padded
//     to 16, so no warp reduction is left but the softmax step's max and
//     sum (softmax_step.cuh), and each warp owns 16 channels over all
//     tokens, so no sum over warps either;
//   - the last CTA of a row to finish merges the row's partials in step
//     order (decode_tile.cuh finish_row), so a call is one launch.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/kernel_ab.py, the
// earlier kernel and this one in one call, L2 flushed, G=4, sparsity
// 0.7): at B=8, 1 chunk + 288 window 0.0711 -> 0.0302 ms at 16 bits,
// 0.0724 -> 0.0341 at 8; at 5 chunks + 288 0.196 -> 0.0631, 0.205 ->
// 0.0787.  What bounds it now: the expansion, 6 us of the 30 at 16 bits
// and 10 of the 34 at 8 (without it 0.0240 and 0.0237 ms), then the
// chunks' scores (2 us).  72-75 registers at G <= 4 (90-92 at G = 8), no
// spill.
// A thread block cluster per chunk (its CTAs agreeing on the chunk's max
// through distributed shared memory) would keep one step a chunk, but a
// cluster spans every step of the grid, and a window tile of fewer tokens
// than the cluster's CTAs would leave CTAs with nothing to attend.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include <algorithm>

#include "decode_tile.cuh"
#include "sp_decode.cuh"

namespace {

using namespace uniform_decode;
using bitmap::CHUNK;
using bitmap::Fmt;
using bitmap::WORD_ROWS;

constexpr int CUT = 4;                // steps a chunk
constexpr int STEP = CHUNK / CUT;     // tokens a chunk step
static_assert(STEP % 16 == 0 && STEP <= MAX_STEP, "whole k-steps of the value product");

// Three CTAs an SM (at most 85 registers a thread); G = 8, two.
constexpr int min_blocks(int G) { return G <= 4 ? 3 : 2; }

// The lanes [lo, lo + w) of every row of a value segment of width k (2^lr
// logical rows) that tokens [t0, t0 + STEP) take, in whole 16-byte
// pieces: token t's values lie at lanes (t >> lr) * k .. + k.
__host__ __device__ inline void share_lanes(int k, int lr, int t0, int& lo, int& w) {
  const int a = ((t0 >> lr) * k) & ~7;
  const int b = (((((t0 + STEP - 1) >> lr) + 1) * k + 7) & ~7);
  lo = a;
  w = (b < D ? b : D) - a;
}

// One stream's staged share: its word planes [16][128], then each value
// segment's rows [p][w], lanes [lo, lo + w) of the stream's (fields, not
// arrays, so that the expansion indexes no local memory).
struct Share {
  const uint16_t* words;
  const uint16_t *seg0, *seg1;
  int lo0, w0, lo1, w1;
};

// 16-bit elements of a stream's share at the widest lane runs over the
// chunk's steps (the shared-memory size the host reserves).
template <int QBITS>
int share_elems(const Fmt<QBITS>& f) {
  int n = WORD_ROWS * D;
  const int p[2] = {f.p0(), f.p1()}, k[2] = {f.k0, f.k1}, lr[2] = {f.lr0, f.lr1};
  for (int j = 0; j < 2; ++j) {
    if (!k[j]) continue;
    int widest = 0;
    for (int c = 0; c < CUT; ++c) {
      int lo, w;
      share_lanes(k[j], lr[j], c * STEP, lo, w);
      widest = std::max(widest, w);
    }
    n += p[j] * widest;
  }
  return n;
}

// Issues the cp.async copies of the share of tokens [t0, t0 + STEP) of the
// stream at `src` into `dst`; returns the share and moves dst past it.
template <int QBITS>
__device__ Share stage_share(uint16_t*& dst, const int16_t* src, const Fmt<QBITS>& f, int t0,
                             int tid) {
  auto copy = [&](const int16_t* from, int rows, int lo, int w) {
    const int per_row = w / 8;
    for (int i = tid; i < rows * per_row; i += THREADS)
      smem::cp_async16(smem::smem_addr(dst + (i / per_row) * w + 8 * (i % per_row)),
                       from + (size_t)(i / per_row) * D + lo + 8 * (i % per_row));
    const uint16_t* at = dst;
    dst += rows * w;
    return at;
  };
  Share sh{};
  sh.words = copy(src + (size_t)f.val_rows() * D, WORD_ROWS, 0, D);
  share_lanes(f.k0, f.lr0, t0, sh.lo0, sh.w0);
  sh.seg0 = copy(src, f.p0(), sh.lo0, sh.w0);
  sh.seg1 = dst;
  if (f.k1) {
    share_lanes(f.k1, f.lr1, t0, sh.lo1, sh.w1);
    sh.seg1 = copy(src + (size_t)f.p0() * D, f.p1(), sh.lo1, sh.w1);
  }
  return sh;
}

// Where token row t's stored values lie in a share: its run of k0 values
// in segment 0 and of k1 in segment 1, each indexed by rank (run1 offset by
// -k0), and at 8 bits the byte of the 16-bit lane that holds each (the
// logical row's half of its stream row).
struct Runs {
  const uint16_t *run0, *run1;
  int byte0, byte1;
};

template <int QBITS>
__device__ __forceinline__ Runs token_runs(const Share& sh, const Fmt<QBITS>& f, int t) {
  auto run = [&](const uint16_t* seg, int k, int lr, int lo, int w, int skip, int& byte) {
    const int row = t & ((1 << lr) - 1);
    int srow = row;
    byte = 0;
    if constexpr (QBITS == 8) {   // logical row `row` in stream row row % (r/2): low, then high
      srow = row & ((1 << (lr - 1)) - 1);
      byte = (row >> (lr - 1)) ? 8 : 0;
    }
    return seg + srow * w + (t >> lr) * k - lo - skip;
  };
  Runs r;
  r.run0 = run(sh.seg0, f.k0, f.lr0, sh.lo0, sh.w0, 0, r.byte0);
  r.run1 = f.k1 ? run(sh.seg1, f.k1, f.lr1, sh.lo1, sh.w1, f.k0, r.byte1) : r.run0;
  if (!f.k1) r.byte1 = r.byte0;
  return r;
}

// Token row t expanded by the calling warp into the bf16 bits of lane's
// channels lane + 32 i (0 where the bit is unset), as bitmap::expand_row
// does from a whole staged stream: a bf16 value's bits, or an int8 code's
// as a bf16 number.
template <int QBITS>
__device__ __forceinline__ void expand_share_row(const Share& sh, const Fmt<QBITS>& f, int t,
                                                 int lane, uint16_t (&v)[4]) {
  const uint16_t* words = sh.words + (t % WORD_ROWS) * D;
  const int shift = t / WORD_ROWS;
  const Runs runs = token_runs<QBITS>(sh, f, t);
  const unsigned below = (1u << lane) - 1u;
  const int keep = f.k0 + f.k1;
  int base = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int bit = (words[lane + 32 * i] >> shift) & 1;
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    const int rank = min(base + __popc(set & below), keep - 1);
    base += __popc(set);
    uint16_t x = 0;
    if (bit) {
      const bool first = rank < f.k0;
      x = (first ? runs.run0 : runs.run1)[rank];
      if constexpr (QBITS == 8) {
        const int byte = (x >> (first ? runs.byte0 : runs.byte1)) & 0xff;
        x = (uint16_t)(__float_as_uint(small_int_f32((byte ^ 0x80) - 0x80)) >> 16);
      }
    }
    v[i] = x;
  }
}

// Tokens [t0, t0 + STEP) of a stream's share expanded into the bf16 tile
// `tile` (rows of LD): warp w takes local rows w + 8 j, ROWS_IN_FLIGHT at
// a time.
template <int QBITS>
__device__ __forceinline__ void expand_share(__nv_bfloat16* tile, const Share& sh,
                                             const Fmt<QBITS>& f, int t0, int warp,
                                             int lane) {
  constexpr int NR = bitmap::ROWS_IN_FLIGHT;
  uint16_t* tile16 = reinterpret_cast<uint16_t*>(tile);
  for (int r0 = warp; r0 < STEP; r0 += NR * WARPS) {
    uint16_t v[NR][4];
#pragma unroll
    for (int j = 0; j < NR; ++j) expand_share_row<QBITS>(sh, f, t0 + r0 + j * WARPS, lane, v[j]);
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) tile16[(r0 + j * WARPS) * LD + lane + 32 * i] = v[j][i];
  }
}
static_assert(STEP % (bitmap::ROWS_IN_FLIGHT * WARPS) == 0, "whole runs of rows a warp");

template <int G, int QBITS>
__global__ void __launch_bounds__(THREADS, min_blocks(G))
sp_uniform_kernel(const __nv_bfloat16* __restrict__ q,      // [B*Hkv, G, D]
                  const int16_t* __restrict__ pool,         // [L, mc, BH, KR+VR, D]
                  const __nv_bfloat16* __restrict__ scales, // [L, mc, BH, 2, D] (8 bits)
                  const __nv_bfloat16* __restrict__ k_win,  // [L, BH, W, D]
                  const __nv_bfloat16* __restrict__ v_win,  // [L, BH, W, D]
                  void* __restrict__ out,                   // [B*Hkv, G, D]
                  float* __restrict__ part,                 // split_merge layout
                  int* __restrict__ counters,               // [BH], zero between launches
                  int out_f32, int BH, int max_chunks, int W, int wt, int n_chunks,
                  int win_len, int li, Fmt<QBITS> kf, Fmt<QBITS> vf, int n_parts,
                  WinProbs wp, Window wn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<G>& sm = *reinterpret_cast<Smem<G>*>(smem_raw);
  unsigned char* region = smem_raw + sizeof(Smem<G>);
  const int sp = blockIdx.x;      // the step: a chunk's run of tokens past the window's
  const int bh = blockIdx.y;      // edge, then a window tile
  const int n_live = n_chunks * CUT - wn.first;   // the pool steps of the grid
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const __nv_bfloat16* q_row = q + (size_t)bh * G * D;
  fresh_state(sm, tid);
  float acc[2][4] = {};
  const __nv_bfloat16* vscale = nullptr;
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(region);

  if (sp < n_live) {
    const int ci = (wn.first + sp) / CUT;
    const int t0 = ((wn.first + sp) % CUT) * STEP;
    const size_t slot = ((size_t)li * max_chunks + ci) * BH + bh;
    const int16_t* stream = pool + slot * (kf.rows() + vf.rows()) * D;
    __nv_bfloat16* vt = kt + STEP * LD;
    uint16_t* dst = reinterpret_cast<uint16_t*>(vt + STEP * LD);
    const Share ksh = stage_share<QBITS>(dst, stream, kf, t0, tid);
    const Share vsh = stage_share<QBITS>(dst, stream + (size_t)kf.rows() * D, vf, t0, tid);
    smem::cp_async_commit();
    const __nv_bfloat16* ks = QBITS == 8 ? scales + slot * 2 * D : nullptr;
    if (ks != nullptr) vscale = ks + D;
    stage_q<G>(sm, q_row, ks, tid);
    smem::cp_async_wait<0>();
    __syncthreads();
    expand_share<QBITS>(kt, ksh, kf, t0, warp, lane);
    expand_share<QBITS>(vt, vsh, vf, t0, warp, lane);
    __syncthreads();
    tile_scores<G>(sm, kt, STEP, warp, lane);
    __syncthreads();
    if (ci * CHUNK + t0 <= wn.low) {   // the run that holds the window's edge
      mask_scores<G>(sm, ci * CHUNK + t0, wn.low, tid);
      __syncthreads();
    }
    online_softmax::softmax_step<G>(sm, STEP, warp, lane);
    tile_pv<G>(acc, sm, vt, STEP, warp, lane);
  } else {
    const int w0 = (sp - n_live) * wt;
    const int n = min(wt, win_len - w0);
    __nv_bfloat16* vt = kt + round8(wt) * LD;
    const size_t at = ((size_t)li * BH + bh) * W * D + (size_t)w0 * D;
    stage_window(kt, vt, k_win + at, v_win + at, n, tid);
    stage_q<G>(sm, q_row, nullptr, tid);
    smem::cp_async_wait<0>();
    __syncthreads();
    tile_scores<G>(sm, kt, n, warp, lane);
    __syncthreads();
    if (wp.out != nullptr) {
      store_win_scores<G>(sm, wp, bh, w0, n, tid);
      __syncthreads();
    }
    online_softmax::softmax_step<G>(sm, n, warp, lane);
    tile_pv<G>(acc, sm, vt, n, warp, lane);
  }
  write_partial<G>(part, bh, sp, n_parts, BH, acc, vscale, sm, warp, lane, tid);
  finish_row<G>(part, counters, out, out_f32, bh, n_parts, BH, sm,
                reinterpret_cast<float*>(region), tid, wp);
}

struct Args {
  const void *q, *pool, *scales, *k_win, *v_win;
  void* out;
  float* part;
  int* counters;
  int out_f32, BH, max_chunks, W, wt, n_chunks, win_len, li, n_parts;
  void* probs;
  void* ml;
  Window wn;
};

template <int G, int QBITS>
int launch(const Args& a, const Fmt<QBITS>& kf, const Fmt<QBITS>& vf, int device,
           cudaStream_t s) {
  const int chunk = 2 * STEP * LD * 2 + 2 * (share_elems(kf) + share_elems(vf));
  const int region = std::max({chunk, window_bytes(a.wt), 2 * a.n_parts * G * 4});
  const int bytes = (int)sizeof(Smem<G>) + region;
  cudaError_t err = smem::allow_dynamic_smem<sp_uniform_kernel<G, QBITS>>(bytes, device);
  if (err != cudaSuccess) return (int)err;
  sp_uniform_kernel<G, QBITS><<<dim3(a.n_parts, a.BH), THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const int16_t*>(a.pool),
      static_cast<const __nv_bfloat16*>(a.scales), static_cast<const __nv_bfloat16*>(a.k_win),
      static_cast<const __nv_bfloat16*>(a.v_win), a.out, a.part, a.counters, a.out_f32, a.BH,
      a.max_chunks, a.W, a.wt, a.n_chunks, a.win_len, a.li, kf, vf, a.n_parts,
      win_probs(a.probs, a.ml, a.part, a.BH, G, a.n_parts, a.W, a.win_len), a.wn);
  return (int)cudaGetLastError();
}

template <int QBITS>
int launch_width(int G, const Args& a, int k0, int k1, int vk0, int vk1, int device,
                 cudaStream_t s) {
  bool k_ok, v_ok;
  const Fmt<QBITS> kf = bitmap::make_fmt<QBITS>(k0, k1, &k_ok);
  const Fmt<QBITS> vf = bitmap::make_fmt<QBITS>(vk0, vk1, &v_ok);
  if (!k_ok || !v_ok) return (int)cudaErrorInvalidValue;
  switch (G) {
    case 1: return launch<1, QBITS>(a, kf, vf, device, s);
    case 2: return launch<2, QBITS>(a, kf, vf, device, s);
    case 4: return launch<4, QBITS>(a, kf, vf, device, s);
    case 8: return launch<8, QBITS>(a, kf, vf, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, 1, Hkv*G, 128] bf16; pool [L, mc, B*Hkv, KR+VR, 128] int16; scales
// [L, mc, B*Hkv, 2, 128] bf16 at `qbits` 8, null at 16; k_win / v_win
// [L, B*Hkv, W, 128] bf16; out [B, 1, Hkv*G, 128] f32 if `out_f32`, else
// bf16.  All contiguous; shapes checked by the caller.  `device` is the
// ordinal the tensors and the stream belong to; `wt` the window tokens per
// softmax step (1..256); (k0, k1) and (vk0, vk1) the K and V streams'
// segment widths (k1 = 0: one segment).  There must be something to
// attend (n_chunks + win_len > 0).  Scratch: f32, `scratch_floats` of
// them, refused if fewer than split_merge::scratch_floats(BH, G, n_chunks
// * 4 + ceil(win_len / wt)); int32 counters, `n_counters` of them, at
// least BH, zero before the launch and left so.  `probs` null, or f32
// [B*Hkv, W] for the window probabilities (decode_tile.cuh); the scratch
// then holds B*Hkv*G*W floats more, for the window scores.  `ml` null, or
// f32 [2][B*Hkv*G] for the final (m, l).  `window` the sliding window (0:
// none); the runs of 64 tokens wholly at or below its edge are left out of
// the grid (decode_tile.cuh Window), so n_parts counts n_chunks * 4 -
// Window::first pool steps.
extern "C" int sp_decode(const void* q, const void* pool, const void* scales,
                         const void* k_win, const void* v_win, void* out, void* probs,
                         void* ml, void* scratch, void* counters, int scratch_floats,
                         int n_counters, int out_f32, int device, int qbits, int BH, int G,
                         int max_chunks, int W, int wt, int n_chunks, int win_len, int li,
                         int window, int k0, int k1, int vk0, int vk1, void* stream) {
  if (wt < 1 || window < 0 || (qbits == 8) != (scales != nullptr))
    return (int)cudaErrorInvalidValue;
  const Window wn = window_of(n_chunks, win_len, window, STEP);
  const int n_parts = n_chunks * CUT - wn.first + (win_len + wt - 1) / wt;
  if (!args_ok(BH, G, max_chunks, W, wt, n_chunks, win_len, li, n_parts, scratch,
               scratch_floats, counters, n_counters, probs))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const Args a{q, pool, scales, k_win, v_win, out, static_cast<float*>(scratch),
               static_cast<int*>(counters), out_f32, BH, max_chunks, W, wt, n_chunks,
               win_len, li, n_parts, probs, ml, wn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qbits == 16) return launch_width<16>(G, a, k0, k1, vk0, vk1, device, s);
  if (qbits == 8) return launch_width<8>(G, a, k0, k1, vk0, vk1, device, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Per-slot decode (continuous batching)
//
// sp_decode_ps replaces the TPU kernel
// mustafar_tpu/ops/kernels/sparse_attention.py
// fused_sparse_decode_attention_v6ps (Pallas body _fused_v6ps_kernel) for
// the codecs bitmap and bitmap-q8, with its window probabilities
// (return_win_probs, split_merge.cuh: a third launch after the merge) and
// its sliding window (window > 0: a slot's chunk splits wholly below its
// edge exit unread, the edge's split masks its dead columns, the merge
// reads the live splits; sp_decode.cuh, split_merge.cuh: at q_decode_ps.cu's
// windowed slots 0.0688 ms against 0.0728 without the window at 16 bits,
// NVIDIA H100 80GB HBM3, 700.00 W).  It is sp_decode
// with the counts read per slot: the
// G query heads of (b, kv head h) attend slot b's first n_chunks[b] pool
// chunks and win_len[b] window tokens, taken from int32 device arrays, so
// the continuous-batching decode step never syncs with the host to size
// itself.  Counts are clamped into [0, mc] and [0, W] in the kernel; an
// idle slot is passed as (0, 0) and writes 0.
//
// Softmax steps: the TPU block spans 16 heads, trips to the block's largest
// chunk count and window length, and masks each head's columns by its own
// counts.  A masked step adds exactly zero to a head once it has a live
// column (p = exp(-1e30 - m) = 0, correction 1); masked steps before its
// first live one are wiped by that step's correction exp(-1e30 - m) = 0.
// So the TPU takes one step per chunk of the slot, then window tiles of
// `wt` tokens (fused_sparse_decode_attention_ps_plain); the splits below
// take the same steps' ranges, each from its own running max.
//
// What bounds it on this card: bytes, as for sp_decode: per layer
// the sum over slots of Hkv*(n_chunks[b]*((KR+VR)*128*2 + S) +
// 2*win_len[b]*128*2) bytes of pools, scales and windows: 21.6 MB at the
// engine's mixed slots (45 chunks and 910 window tokens over 8 slots, 8 kv
// heads, 16 bits), 6.4 us.
//
// Design: split-K.  With one block per (b, kv head) a call waits on its
// longest slot: at those slots the 8 blocks of a 31-chunk slot walked 31
// chunks in series (~0.031 ms a chunk) while the other 56 sat done, 1.0 ms
// in all.  So the grid covers (b, kv head, split), sized on the host from
// mc and W with no sync: split s < mc takes pool chunk s, split mc + j
// window tile j of `wt` tokens (3 at W = 288).  Each split does the
// per-chunk (or per-tile) work and softmax step of sp_decode.cuh from a
// fresh state; a block past its slot's clamped
// counts exits at once and writes nothing.  Its partials go to scratch and
// a second kernel merges each row's live splits in split order
// (split_merge.cuh); an idle slot comes out 0, a slot with chunks but no
// window (or the reverse) merges what it has.  A split rounds p at its own
// running max, so the kernel's plain version is
// fused_sparse_decode_attention_ps_split_plain.
//
// One chunk a split, and three blocks an SM.  The work is the chunks: 45
// per kv head at the mixed slots, 360 chunk blocks beside 24 window ones.
// A one-chunk block stages one chunk, one stage buffer of 48 KB at 16 bits
// (28 at 8) beside 6 KB of Smem at G = 4, and takes one softmax step, so
// its accumulator needs no second copy: built for three blocks an SM (80
// registers, no spills), 396 resident blocks hold the mixed slots' 384 in
// one wave.  Measured on an H100 (PERF.md §6): two chunks a split with
// a double buffer (102 KB, two blocks an SM) took 0.100 ms there against
// 0.075; one chunk a split built for two blocks an SM (107-116 registers)
// 0.096, two waves, though it takes the light slots (128 chunk blocks) in
// 0.054 ms against 0.066.  The blocks past the counts (most of the 35 x 64
// at mc = 32) cost a read of two counts each.
//
// Splits need (acc, m, l) scratch of BH * n_splits * G * 130 floats (4.7 MB
// at mc = 32, G = 4): the wrapper passes an uninitialised buffer, kept from
// call to call, and its size, which the entry checks.

// As sp_decode, with the counts in device arrays:
// n_chunks[B], win_len[B] int32; `hkv` the kv heads per slot (BH = B*hkv);
// scratch f32, `scratch_floats` of them, refused if fewer than
// split_merge::scratch_floats(BH, G, n_splits), with n_splits = max_chunks +
// ceil(W / wt); `window` the sliding window, 0 for none.
extern "C" int sp_decode_ps(const void* q, const void* pool, const void* scales,
                            const void* k_win, const void* v_win, const void* n_chunks,
                            const void* win_len, void* out, void* probs, void* scratch,
                            int scratch_floats, int out_f32, int device, int qbits,
                            int BH, int hkv, int G,
                            int max_chunks, int W, int wt, int li, int k0, int k1,
                            int vk0, int vk1, int n_splits, int window, void* stream) {
  if (n_chunks == nullptr || win_len == nullptr || scratch == nullptr || hkv < 1 ||
      BH % hkv || G < 1 || n_splits < 1 || scratch_floats < 0 || W < 0 ||
      (size_t)scratch_floats < split_merge::scratch_floats(BH, G, n_splits) +
                                   (probs != nullptr ? split_merge::slot_probs_floats(BH, G, W)
                                                     : 0))
    return (int)cudaErrorInvalidValue;
  return bitmap_decode::launch_bits(qbits, k0, k1, vk0, vk1, q, pool, scales, k_win,
                                    v_win, out, out_f32, device, BH, G, max_chunks, W,
                                    wt, 0, 0, li, static_cast<const int*>(n_chunks),
                                    static_cast<const int*>(win_len), hkv,
                                    static_cast<float*>(scratch), n_splits, probs, window,
                                    stream);
}
