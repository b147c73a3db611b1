// The archive's fused decode-attention generations v2 and v3 for Hopper
// (sm_90a), over split pools (ops/sparse_format.py encode_chunk): one
// kernel body, templated on the pool layout.
//
// sp_fused_v2 replaces the TPU kernel
// mustafar_tpu/ops/kernels/sparse_attention_archive.py
// fused_sparse_decode_attention (v2, Pallas body _fused_decode_kernel), whose
// pools are head-major: segments [B*Hkv, mc*R_i, 128], words
// [B*Hkv, mc*8, 128].  sp_fused_v3 replaces fused_sparse_decode_attention_v3
// (_fused_v3_kernel), the same function over chunk-major pools
// [mc, B*Hkv, R_i, 128] and [mc, B*Hkv, 8, 128].  For each (batch row b, kv
// head h) they attend the G = Hq / Hkv query heads of that kv head over
//   1. `n_chunks` chunks of 256 tokens, K and V expanded from value
//      segments (bf16) and 8 uint32 word planes (token t is bit t / 8 of
//      plane t % 8): scores = bf16(q) . K / sqrt(128) in f32;
//   2. the first `win_len` rows of the dense bf16 window [B, W, Hkv, 128],
// in f32 online-softmax steps, p rounded to bf16 before the value product,
// out = acc / l.  n_chunks and win_len are int32 scalars in device memory,
// read by every CTA and clamped into [0, mc] and [0, W] (decode_tile.cuh
// read_counts), as the TPU kernels take them by scalar prefetch, so one
// launch, and a CUDA graph that holds it, serves any counts.
//
// The steps.  The TPU takes one step a chunk, then the whole window in ONE
// step over its W columns, those at or past win_len at -1e30 (a masked
// column adds exactly 0 once a live column has set the running max).  Here
// each chunk is cut into CUT = 4 runs of 64 tokens and the window into
// tiles of `wt` live tokens, each one softmax step from a fresh state whose
// partials (acc, m, l) the row's last CTA merges in step order
// (decode_tile.cuh finish_row).  A step rounds p to bf16 at its own max, so
// the result differs from the TPU order by such roundings:
// fused_sparse_decode_attention_split_plain (and _v3_split_plain) repeat
// this kernel's arithmetic, the scores summed in decode_tile.cuh's fixed
// order bit for bit.  With nothing to attend (n_chunks = win_len = 0)
// every one of the TPU's W masked columns has p = exp(0) = 1 and the
// output is the mean of the head's W window rows of V; the row's first CTA
// writes that mean, summed over the rows in order and divided by W in f32,
// as the split plain versions sum it (window_mean), not decode_tile.cuh's
// empty row of zeros.
//
// What bounds it on this card: bytes.  Per call it must read
//   B*Hkv*(n_chunks*2*24,576 + 2*win_len*128*2) bytes (+ q, out)
// at sparsity 0.7 (keep 40 = 32 + 8: 80 value rows and 16 rows of words a
// stream and chunk).  At B=8, Hkv=8, one chunk and a 288-token window that
// is 12.7 MB, some 3.8 us at 3.35 TB/s; at B=32, three chunks and 132
// window tokens 55.6 MB, 16.6 us.  The products are a few flops a byte.
//
// Design: the uniform bitmap decode's (sp_decode.cu's entry sp_decode).
// Its earlier form, one block of 8 warps a (b, kv head) walking its chunks
// and then its window in series (64 blocks for 132 SMs at B=8), was these
// kernels' too: 0.0696 ms (v2) and 0.0677 (v3) at B=8, 1 chunk + 288
// window, G=4, sparsity 0.7, where that form of the bitmap decode took
// 0.0711 (NVIDIA H100 80GB HBM3, 700.00 W).  Now:
//   - one CTA of 8 warps a step, built for three CTAs an SM (two at G = 8):
//     B*Hkv rows x (mc * CUT + ceil(W / wt)) steps, the grid sized from the
//     capacities alone (decode_tile.cuh grid_steps); CTA y of a row takes
//     the row's y-th live step (n_chunks * CUT + ceil(win_len / wt)), the
//     others read the counts and exit;
//   - a chunk CTA copies with cp.async only what its 64 tokens need, the
//     8 uint32 word planes of each stream (4 KB) and the run of each value
//     segment that holds these tokens, from the chunk's place in either
//     layout (chunk_share.cuh, shared with sp_decode.cu, whose fused
//     stream differs only in where the pieces lie and in the word width);
//     one warp expands one token row into padded bf16 K and V tiles;
//     scores in decode_tile.cuh's fixed order (tile_scores), p.V on
//     mma.sync m16n8k16 with the G query rows padded to 16 (tile_pv);
//   - a window CTA stages its tile's K and V rows (stage_window, a row
//     every Hkv*128 elements: the window's layout is [B, W, Hkv, 128]);
//   - the last CTA of a row merges the row's partials, so a call is one
//     launch.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include <algorithm>

#include "chunk_share.cuh"
#include "decode_tile.cuh"

namespace {

using namespace uniform_decode;
using namespace chunk_share;

// One stream's split pools: its segments (bf16 bits; seg1 null without a
// second segment) and its uint32 word planes.
struct SplitPool {
  const int16_t* seg0;
  const int16_t* seg1;
  const uint32_t* words;
};

// Where chunk `piece` of a stream's split pools lies (piece = bh*mc + ci
// head-major, ci*B*Hkv + bh chunk-major): each pool a run of such pieces,
// segments [p][128], words [8][128].
__device__ __forceinline__ Sources split_sources(const SplitPool& p, const Fmt<16>& f,
                                                 size_t piece) {
  return Sources{reinterpret_cast<const int16_t*>(p.words + piece * (CHUNK / 32) * D),
                 p.seg0 + piece * f.p0() * D, p.seg1 + piece * f.p1() * D};
}

// The output of a row with nothing to attend: for each channel (one thread
// each) the sum of the head's W window rows of V in row order, in f32,
// divided by W; the same for the G query heads.
template <int G>
__device__ __forceinline__ void window_mean(const __nv_bfloat16* __restrict__ v_win,
                                            void* __restrict__ out, int out_f32, int bh,
                                            int Hkv, int W, int tid) {
  if (tid >= D) return;
  const size_t stride = (size_t)Hkv * D;
  const __nv_bfloat16* col = v_win + (size_t)(bh / Hkv) * W * stride + (bh % Hkv) * D + tid;
  float s = 0.f;
#pragma unroll 8
  for (int t = 0; t < W; ++t) s = __fadd_rn(s, __bfloat162float(col[t * stride]));
  const float o = __fdiv_rn(s, (float)W);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t at = ((size_t)bh * G + g) * D + tid;
    if (out_f32)
      static_cast<float*>(out)[at] = o;
    else
      static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(o);
  }
}

template <int G, bool CHUNK_MAJOR>
__global__ void __launch_bounds__(THREADS, min_blocks(G))
split_pool_kernel(const __nv_bfloat16* __restrict__ q,       // [B*Hkv, G, D]
                  const SplitPool kp, const SplitPool vp,
                  const __nv_bfloat16* __restrict__ k_win,   // [B, W, Hkv, D]
                  const __nv_bfloat16* __restrict__ v_win,
                  const int* __restrict__ nc_in,             // n_chunks, one int32
                  const int* __restrict__ wl_in,             // win_len, one int32
                  void* __restrict__ out,                    // [B*Hkv, G, D]
                  float* __restrict__ part,                  // split_merge layout
                  int* __restrict__ counters,                // [BH], zero between launches
                  int out_f32, int BH, int Hkv, int max_chunks, int W, int wt,
                  Fmt<16> kf, Fmt<16> vf, int n_parts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<G>& sm = *reinterpret_cast<Smem<G>*>(smem_raw);
  unsigned char* region = smem_raw + sizeof(Smem<G>);
  const int bh = blockIdx.x;
  const int sp = blockIdx.y;      // the live step: a chunk's run of tokens, then a
  const int tid = threadIdx.x;    // window tile
  const Counts c = read_counts(nc_in, wl_in, max_chunks, W, wt, 0, STEP);
  if (sp >= c.n_live) {           // past the live steps: nothing read, no merge
    if (sp == 0) window_mean<G>(v_win, out, out_f32, bh, Hkv, W, tid);
    return;
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  fresh_state(sm, tid);
  float acc[2][4] = {};
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(region);

  if (sp < c.pool_steps) {
    const int ci = sp / CUT;
    const int t0 = (sp % CUT) * STEP;
    const size_t piece = CHUNK_MAJOR ? (size_t)ci * BH + bh : (size_t)bh * max_chunks + ci;
    __nv_bfloat16* vt = kt + STEP * LD;
    uint16_t* dst = reinterpret_cast<uint16_t*>(vt + STEP * LD);
    const Share ksh = stage_share<16>(dst, split_sources(kp, kf, piece), kf, t0, tid);
    const Share vsh = stage_share<16>(dst, split_sources(vp, vf, piece), vf, t0, tid);
    smem::cp_async_commit();
    stage_q<G>(sm, q + (size_t)bh * G * D, nullptr, tid);
    smem::cp_async_wait<0>();
    __syncthreads();
    expand_share<16, 32>(kt, ksh, kf, t0, warp, lane);
    expand_share<16, 32>(vt, vsh, vf, t0, warp, lane);
    __syncthreads();
    tile_scores<G>(sm, kt, STEP, warp, lane);
    __syncthreads();
    online_softmax::softmax_step<G>(sm, STEP, warp, lane);
    tile_pv<G>(acc, sm, vt, STEP, warp, lane);
  } else {
    const int w0 = (sp - c.pool_steps) * wt;
    const int n = min(wt, c.win_len - w0);
    __nv_bfloat16* vt = kt + round8(wt) * LD;
    const size_t at = ((size_t)(bh / Hkv) * W + w0) * Hkv * D + (size_t)(bh % Hkv) * D;
    stage_window(kt, vt, k_win + at, v_win + at, n, tid, (size_t)Hkv * D);
    stage_q<G>(sm, q + (size_t)bh * G * D, nullptr, tid);
    smem::cp_async_wait<0>();
    __syncthreads();
    tile_scores<G>(sm, kt, n, warp, lane);
    __syncthreads();
    online_softmax::softmax_step<G>(sm, n, warp, lane);
    tile_pv<G>(acc, sm, vt, n, warp, lane);
  }
  write_partial<G>(part, bh, sp, n_parts, BH, acc, nullptr, sm, warp, lane, tid);
  finish_row<G>(part, counters, out, out_f32, bh, c.n_live, n_parts, BH, sm,
                reinterpret_cast<float*>(region), tid, WinProbs{});
}

struct Args {
  const void* q;
  SplitPool kp, vp;
  const void *k_win, *v_win, *n_chunks, *win_len;
  void* out;
  float* part;
  int* counters;
  int out_f32, BH, Hkv, max_chunks, W, wt, n_parts;
};

template <int G, bool CHUNK_MAJOR>
int launch(const Args& a, const Fmt<16>& kf, const Fmt<16>& vf, int device, cudaStream_t s) {
  const int region =
      std::max({chunk_region_bytes(kf, vf), window_bytes(a.wt), 2 * a.n_parts * G * 4});
  const int bytes = (int)sizeof(Smem<G>) + region;
  cudaError_t err = smem::allow_dynamic_smem<split_pool_kernel<G, CHUNK_MAJOR>>(bytes, device);
  if (err != cudaSuccess) return (int)err;
  split_pool_kernel<G, CHUNK_MAJOR><<<dim3(a.BH, a.n_parts), THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.kp, a.vp,
      static_cast<const __nv_bfloat16*>(a.k_win), static_cast<const __nv_bfloat16*>(a.v_win),
      static_cast<const int*>(a.n_chunks), static_cast<const int*>(a.win_len), a.out, a.part,
      a.counters, a.out_f32, a.BH, a.Hkv, a.max_chunks, a.W, a.wt, kf, vf, a.n_parts);
  return (int)cudaGetLastError();
}

template <bool CHUNK_MAJOR>
int launch_split(const void* q, const void* ks0, const void* ks1, const void* kb,
                 const void* vs0, const void* vs1, const void* vb, const void* k_win,
                 const void* v_win, const void* n_chunks, const void* win_len, void* out,
                 void* scratch, void* counters, int scratch_floats, int n_counters,
                 int out_f32, int device, int B, int Hkv, int G, int mc, int W, int wt,
                 int k0, int k1, int vk0, int vk1, void* stream) {
  bool k_ok, v_ok;
  const Fmt<16> kf = bitmap::make_fmt<16>(k0, k1, &k_ok);
  const Fmt<16> vf = bitmap::make_fmt<16>(vk0, vk1, &v_ok);
  if (!k_ok || !v_ok || (k1 > 0) != (ks1 != nullptr) || (vk1 > 0) != (vs1 != nullptr) ||
      B < 1 || Hkv < 1 || mc < 1 || W < 1 || ks0 == nullptr || kb == nullptr ||
      vs0 == nullptr || vb == nullptr)
    return (int)cudaErrorInvalidValue;
  const int BH = B * Hkv;
  const int n_parts = grid_steps(mc, W, wt, STEP);
  if (!args_ok(BH, G, W, wt, 0, n_parts, n_chunks, win_len, scratch, scratch_floats,
               counters, n_counters, nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const Args a{q,
               SplitPool{static_cast<const int16_t*>(ks0), static_cast<const int16_t*>(ks1),
                         static_cast<const uint32_t*>(kb)},
               SplitPool{static_cast<const int16_t*>(vs0), static_cast<const int16_t*>(vs1),
                         static_cast<const uint32_t*>(vb)},
               k_win, v_win, n_chunks, win_len, out, static_cast<float*>(scratch),
               static_cast<int*>(counters), out_f32, BH, Hkv, mc, W, wt, n_parts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return launch<1, CHUNK_MAJOR>(a, kf, vf, device, s);
    case 2: return launch<2, CHUNK_MAJOR>(a, kf, vf, device, s);
    case 4: return launch<4, CHUNK_MAJOR>(a, kf, vf, device, s);
    case 8: return launch<8, CHUNK_MAJOR>(a, kf, vf, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, 1, Hkv*G, 128] bf16; the K and V pools' segments (bf16; the second
// null when that stream has one segment) and words (uint32), head-major;
// k_win / v_win [B, W, Hkv, 128] bf16; n_chunks, win_len one int32 each in
// device memory, read by the kernel and clamped into [0, mc] and [0, W];
// out [B, 1, Hkv*G, 128], f32 if `out_f32`, else bf16.  All contiguous and
// 16-byte aligned; shapes checked by the caller.  `wt` the window tokens a
// step (1..256); (k0, k1) and (vk0, vk1) the streams' segment widths.  The
// grid takes mc * 4 + ceil(W / wt) steps a row (at most
// split_merge::MAX_SPLITS), the live ones at the counts attended; nothing
// to attend writes the mean of the head's W window rows of V.  Scratch:
// f32, `scratch_floats` of them, refused if fewer than
// split_merge::scratch_floats(B*Hkv, G, mc * 4 + ceil(W / wt)); int32
// counters, `n_counters` of them, at least B*Hkv, zero before the launch
// and left so.
extern "C" int sp_fused_v2(const void* q, const void* ks0, const void* ks1, const void* kb,
                           const void* vs0, const void* vs1, const void* vb,
                           const void* k_win, const void* v_win, const void* n_chunks,
                           const void* win_len, void* out, void* scratch, void* counters,
                           int scratch_floats, int n_counters, int out_f32, int device, int B,
                           int Hkv, int G, int mc, int W, int wt, int k0, int k1, int vk0,
                           int vk1, void* stream) {
  return launch_split<false>(q, ks0, ks1, kb, vs0, vs1, vb, k_win, v_win, n_chunks, win_len,
                             out, scratch, counters, scratch_floats, n_counters, out_f32,
                             device, B, Hkv, G, mc, W, wt, k0, k1, vk0, vk1, stream);
}

// As sp_fused_v2, over chunk-major pools.
extern "C" int sp_fused_v3(const void* q, const void* ks0, const void* ks1, const void* kb,
                           const void* vs0, const void* vs1, const void* vb,
                           const void* k_win, const void* v_win, const void* n_chunks,
                           const void* win_len, void* out, void* scratch, void* counters,
                           int scratch_floats, int n_counters, int out_f32, int device, int B,
                           int Hkv, int G, int mc, int W, int wt, int k0, int k1, int vk0,
                           int vk1, void* stream) {
  return launch_split<true>(q, ks0, ks1, kb, vs0, vs1, vb, k_win, v_win, n_chunks, win_len,
                            out, scratch, counters, scratch_floats, n_counters, out_f32,
                            device, B, Hkv, G, mc, W, wt, k0, k1, vk0, vk1, stream);
}
