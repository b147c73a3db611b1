// Quant-codec flash-decode attention for Hopper (sm_90a), uniform batch.
//
// Replaces the TPU kernel mustafar_tpu/ops/kernels/quant_attention.py
// fused_q_decode_attention (Pallas body _q_decode_kernel) for the codecs
// q8 (int8 K, int8 V), q8q4 (int8 K, int4 V) and q4q4 (int4 K, int4 V),
// with its window probabilities (return_win_probs), final (m, l)
// (return_norm) and sliding window (window), all decode_tile.cuh.  For
// one layer `li` of the stacked cache and each (batch row b, kv head h) it
// attends the G = Hq / Hkv query heads of that kv head over
//   1. `n_chunks` packed pool chunks of 256 tokens (with a sliding window
//      only the columns past its edge: the chunks wholly below it are not
//      read), K, then V, as codes of
//      `kbits` / `vbits` bits, 16/bits tokens per int16 row (at 8 bits
//      token t in the low byte of row t and token t+128 in the high byte;
//      at 4 bits token t + 64 j in nibble j), each with a bf16 scale per
//      channel.  The K scale folds into q before the scores (scores =
//      bf16(q * kscale) . codes / sqrt(128)); the V scale multiplies each
//      chunk's p.v partial;
//   2. the first `win_len` tokens of the dense bf16 residual window, with q
//      unscaled,
// in f32 softmax steps (mask value -1e30, final l clamped at 1e-30), p
// rounded to bf16 before the value product as on the TPU.  The steps'
// token ranges are the TPU kernel's: one per chunk, then one per window
// tile of `wt` tokens.  Here each step starts from a fresh state and the
// steps' partials are merged in step order, so p is rounded at its own
// step's max: the arithmetic of the per-slot kernel (q_decode_ps.cu) with
// every slot at the call's counts, fused_q_decode_attention_split_plain.
// n_chunks and win_len are int32 scalars in device memory, read by every
// CTA (decode_tile.cuh read_counts), as the TPU kernel takes them by
// scalar prefetch: a CUDA graph of the decode step replays this launch at
// every position.
//
// What bounds it on this card: bytes.  Per layer it must read
//   B*Hkv*(n_chunks*(ROWS*128*2 + 512) + 2*win_len*128*2) bytes (+ q, out),
// with ROWS = 256 / 192 / 128 int16 rows a chunk at q8 / q8q4 / q4q4:
// 12.8 MB at q8q4, B=8, Hkv=8, one chunk and a 288-token window, 3.8 us at
// 3.35 TB/s (NVIDIA H100 SXM's rate at its 700 W limit); the products are
// a few flops a byte.
//
// Design.  The earlier kernel ran the TPU's grid as a loop: one
// block per (b, kv head), 64 blocks for 132 SMs at B=8, each walking its
// chunk and window tiles in series, its scores one warp reduction per (K
// row, head, field) and its values 2-byte loads from device memory.  It
// took 0.0548 ms at q8q4 (q8 0.0541, q4q4 0.0514) at B=8, 1 chunk + 288
// window, G=4 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6).  Now:
//   - one CTA of 8 warps a step, built for three CTAs an SM (two at G =
//     8): B*Hkv rows x (mc + ceil(W / wt)) steps, the grid sized from the
//     pool's and the window's capacity; CTA y of a row takes the row's
//     y-th live step (n_chunks + ceil(win_len / wt) of them: 256 live CTAs
//     at that shape), the others read the counts and exit
//     (decode_tile.cuh);
//   - a CTA copies its step's bytes into shared memory first, 16 bytes a
//     thread with cp.async, every copy in flight before the first
//     product: a chunk's int16 rows with 16 bytes of padding a row, or a
//     window tile's bf16 K and V rows (decode_tile.cuh);
//   - scores and values run on mma.sync m16n8k16, the G query rows padded
//     to 16 (the tensor cores' rate leaves the padding free; a lane per
//     token would need 128 f32 FMAs and 32 shared loads a token and
//     query head).  The codes go from the staged carriers straight to
//     bf16 B fragments: a lane's 4-byte load at (row, 2 channels) gives
//     the fragments of the row's 16/bits tokens.  For the value product
//     the mma's 16 k-slots take the tokens of a few carrier rows in the
//     order the carriers hold them (at 4 bits rows 4 ks + tig, its four
//     nibbles' tokens; at 8 bits rows 8 ks + tig and 8 ks + 4 + tig, two
//     each), and the A fragments read bf16(p) in the same order, so a
//     carrier is loaded once and no token leaves its row;
//   - no warp reduction is left: the softmax step's per-head max and sum
//     (softmax_step.cuh) and a warp's own 16 channels over all tokens;
//   - the last CTA of a row to finish merges the row's partials in step
//     order (decode_tile.cuh finish_row: one acq_rel counter a row, reset
//     by that CTA), so a call is one launch.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/kernel_ab.py, the
// earlier kernel and this one in one call, L2 flushed, G=4): at B=8, 1
// chunk + 288 window 0.0546 -> 0.0203 ms at q8q4, 0.0540 -> 0.0213 at q8,
// 0.0514 -> 0.0192 at q4q4; at 5 chunks + 288 0.132 -> 0.0344, 0.133 ->
// 0.0368, 0.114 -> 0.0308.  What bounds it now: the staged bytes' latency
// and the launch; the chunk's scores take 2.5 us of the 20 (without them
// 0.0180 ms at q8q4).  72-80 registers at G <= 4 (114 at G = 8), no
// spill.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include <algorithm>

#include "decode_tile.cuh"
#include "quant_decode.cuh"

namespace {

using namespace uniform_decode;
using qdec::Stream;

constexpr int CHUNK = 256;

// Field j of the int16 carrier in the low half of `x`, sign-extended
// (quant_decode.cuh code, as an integer).
template <int BITS>
__device__ __forceinline__ int icode(int x, int j) {
  return (int)((uint32_t)x << (32 - BITS * (j + 1))) >> (32 - BITS);
}

// Fields j0 of carrier x0 and j1 of x1 as a bf16x2 B fragment (codes are
// bf16 numbers).
template <int BITS>
__device__ __forceinline__ uint32_t pack_code(int x0, int j0, int x1, int j1) {
  return pack_exact_bf16(small_int_f32(icode<BITS>(x0, j0)), small_int_f32(icode<BITS>(x1, j1)));
}

// Three CTAs an SM (at most 85 registers a thread); G = 8 takes more
// registers and shared memory, two.
constexpr int min_blocks(int G) { return G <= 4 ? 3 : 2; }

template <int G, int KB, int VB>
__global__ void __launch_bounds__(THREADS, min_blocks(G))
q_uniform_kernel(const __nv_bfloat16* __restrict__ q,      // [B*Hkv, G, D]
                 const int16_t* __restrict__ pool,         // [L, mc, BH, ROWS, D]
                 const __nv_bfloat16* __restrict__ scales, // [L, mc, BH, 2, D]
                 const __nv_bfloat16* __restrict__ k_win,  // [L, BH, W, D]
                 const __nv_bfloat16* __restrict__ v_win,  // [L, BH, W, D]
                 const int* __restrict__ nc_in,            // n_chunks, one int32
                 const int* __restrict__ wl_in,            // win_len, one int32
                 void* __restrict__ out,                   // [B*Hkv, G, D]
                 float* __restrict__ part,                 // split_merge layout
                 int* __restrict__ counters,               // [BH], zero between launches
                 int out_f32, int BH, int max_chunks, int W, int wt, int li, int n_parts,
                 int window, WinProbs wp) {
  constexpr int KF = Stream<KB>::FIELDS;
  constexpr int K_ROWS = Stream<KB>::ROWS;
  constexpr int V_ROWS = Stream<VB>::ROWS;
  constexpr int ROWS = K_ROWS + V_ROWS;
  static_assert(VB == 4 || VB == 8, "the value product's token order");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<G>& sm = *reinterpret_cast<Smem<G>*>(smem_raw);
  unsigned char* region = smem_raw + sizeof(Smem<G>);
  const int bh = blockIdx.x;
  const int sp = blockIdx.y;      // the live step: a chunk past the window's edge, then a tile
  const int tid = threadIdx.x;
  const Counts c = read_counts(nc_in, wl_in, max_chunks, W, wt, window, CHUNK);
  wp.win_len = c.win_len;
  if (sp >= c.n_live) {           // past the live steps: nothing read, no merge
    if (sp == 0) empty_row<G>(out, out_f32, bh, BH, wp, tid);
    return;
  }
  const Window wn = c.wn;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* q_row = q + (size_t)bh * G * D;
  fresh_state(sm, tid);
  float acc[2][4] = {};
  const __nv_bfloat16* vscale = nullptr;
  auto p = [&](int t) { return gid < G ? sm.s[gid][t] : 0.f; };

  if (sp < c.pool_steps) {
    const int ci = wn.first + sp;
    const size_t slot = ((size_t)li * max_chunks + ci) * BH + bh;
    const int16_t* rows = pool + slot * ROWS * D;
    const __nv_bfloat16* ks = scales + slot * 2 * D;
    vscale = ks + D;
    int16_t* st = reinterpret_cast<int16_t*>(region);   // [ROWS][LD]
    for (int i = tid; i < ROWS * (D / 8); i += THREADS)
      smem::cp_async16(smem::smem_addr(st + (i / (D / 8)) * LD + 8 * (i % (D / 8))),
                       rows + (size_t)8 * i);
    smem::cp_async_commit();
    stage_q<G>(sm, q_row, ks, tid);
    smem::cp_async_wait<0>();
    __syncthreads();

    // scores: 8 K rows a warp at a time, 4 lanes a row (a quarter of the
    // channels each), each row the KF tokens row + K_ROWS * field, summed
    // in the fixed order of decode_tile.cuh
    for (int r0 = 8 * warp; r0 < K_ROWS; r0 += 8 * WARPS) {
      const int r = r0 + gid;
      float sacc[KF][G];
#pragma unroll
      for (int f = 0; f < KF; ++f)
#pragma unroll
        for (int g = 0; g < G; ++g) sacc[f][g] = 0.f;
      const uint4* row = reinterpret_cast<const uint4*>(st + r * LD + 32 * tig);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 w = row[j];
        const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // channels 8 j + 4 h .. + 3
          const int x[4] = {(int)wv[2 * h], (int)(wv[2 * h] >> 16), (int)wv[2 * h + 1],
                            (int)(wv[2 * h + 1] >> 16)};
#pragma unroll
          for (int f = 0; f < KF; ++f) {
            float c[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) c[e] = small_int_f32(icode<KB>(x[e], f));
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float4 qq = q_quad(sm, g, tig, 2 * j + h);
              sacc[f][g] = fmaf(qq.x, c[0], sacc[f][g]);
              sacc[f][g] = fmaf(qq.y, c[1], sacc[f][g]);
              sacc[f][g] = fmaf(qq.z, c[2], sacc[f][g]);
              sacc[f][g] = fmaf(qq.w, c[3], sacc[f][g]);
            }
          }
        }
      }
#pragma unroll
      for (int f = 0; f < KF; ++f) put_scores<G>(sm, sacc[f], r + K_ROWS * f, CHUNK, tig);
    }
    __syncthreads();
    if (ci * CHUNK <= wn.low) {   // the chunk that holds the window's edge
      mask_scores<G>(sm, ci * CHUNK, wn.low, tid);
      __syncthreads();
    }
    online_softmax::softmax_step<G>(sm, CHUNK, warp, lane);

    // values: this warp's 16 channels over the chunk's 256 tokens, 16 a
    // k-step in carrier order
    const int16_t* vrows = st + K_ROWS * LD;
#pragma unroll 4
    for (int k = 0; k < CHUNK / 16; ++k) {
      if constexpr (VB == 4) {
        const int r = 4 * k + tig;               // tokens r + 64 j, j = 0..3
        const uint32_t a0 = pack_exact_bf16(p(r), p(r + 64));
        const uint32_t a2 = pack_exact_bf16(p(r + 128), p(r + 192));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int x = vrows[r * LD + 16 * warp + 8 * j + gid];
          mma_bf16(acc[j], a0, 0u, a2, 0u, pack_code<4>(x, 0, x, 1), pack_code<4>(x, 2, x, 3));
        }
      } else {
        const int r = 8 * k + tig, r2 = r + 4;   // tokens r, r + 128, r2, r2 + 128
        const uint32_t a0 = pack_exact_bf16(p(r), p(r + 128));
        const uint32_t a2 = pack_exact_bf16(p(r2), p(r2 + 128));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ch = 16 * warp + 8 * j + gid;
          const int x = vrows[r * LD + ch], x2 = vrows[r2 * LD + ch];
          mma_bf16(acc[j], a0, 0u, a2, 0u, pack_code<8>(x, 0, x, 1), pack_code<8>(x2, 0, x2, 1));
        }
      }
    }
  } else {
    const int w0 = (sp - c.pool_steps) * wt;
    const int n = min(wt, c.win_len - w0);
    __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(region);
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
  finish_row<G>(part, counters, out, out_f32, bh, c.n_live, n_parts, BH, sm,
                reinterpret_cast<float*>(region), tid, wp);
}

struct Args {
  const void *q, *pool, *scales, *k_win, *v_win, *n_chunks, *win_len;
  void* out;
  float* part;
  int* counters;
  int out_f32, BH, max_chunks, W, wt, li, n_parts, window;
  void* probs;
  void* ml;
};

template <int G, int KB, int VB>
int launch(const Args& a, int device, cudaStream_t s) {
  constexpr int ROWS = Stream<KB>::ROWS + Stream<VB>::ROWS;
  const int region = std::max({ROWS * LD * 2, window_bytes(a.wt), 2 * a.n_parts * G * 4});
  const int bytes = (int)sizeof(Smem<G>) + region;
  cudaError_t err = smem::allow_dynamic_smem<q_uniform_kernel<G, KB, VB>>(bytes, device);
  if (err != cudaSuccess) return (int)err;
  q_uniform_kernel<G, KB, VB><<<dim3(a.BH, a.n_parts), THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const int16_t*>(a.pool),
      static_cast<const __nv_bfloat16*>(a.scales), static_cast<const __nv_bfloat16*>(a.k_win),
      static_cast<const __nv_bfloat16*>(a.v_win), static_cast<const int*>(a.n_chunks),
      static_cast<const int*>(a.win_len), a.out, a.part, a.counters, a.out_f32, a.BH,
      a.max_chunks, a.W, a.wt, a.li, a.n_parts, a.window,
      win_probs(a.probs, a.ml, a.part, a.BH, G, a.n_parts, a.W));
  return (int)cudaGetLastError();
}

template <int KB, int VB>
int launch_groups(int G, const Args& a, int device, cudaStream_t s) {
  switch (G) {
    case 1: return launch<1, KB, VB>(a, device, s);
    case 2: return launch<2, KB, VB>(a, device, s);
    case 4: return launch<4, KB, VB>(a, device, s);
    case 8: return launch<8, KB, VB>(a, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, 1, Hkv*G, 128] bf16; pool [L, mc, B*Hkv, ROWS, 128] int16 (ROWS
// = 256 * (kbits + vbits) / 16; (kbits, vbits) one of (8, 8), (8, 4), (4, 4));
// scales [L, mc, B*Hkv, 2, 128] bf16; k_win / v_win [L, B*Hkv, W, 128] bf16;
// n_chunks, win_len one int32 each in device memory, read by the kernel
// and clamped into [0, max_chunks] and [0, W]; out [B, 1, Hkv*G, 128] f32
// if `out_f32`, else bf16.  All contiguous; shapes checked by the caller.
// `device` is the ordinal the tensors and the stream belong to; `wt` the
// window tokens per softmax step (1..256).  The grid takes max_chunks +
// ceil(W / wt) steps a row (decode_tile.cuh grid_steps), the live ones at
// the counts attended; nothing to attend writes 0 (m -1e30, l 0).
// Scratch: f32, `scratch_floats` of them, refused if fewer than
// split_merge::scratch_floats(BH, G, max_chunks + ceil(W / wt)); int32
// counters, `n_counters` of them, at least BH, zero before the launch and
// left so.  `probs` null, or f32 [B*Hkv, W] for the window probabilities;
// the scratch then holds B*Hkv*G*W floats more, for the window scores.
// `ml` null, or f32 [2][B*Hkv*G] for the final (m, l).  `window` the
// sliding window (0: none); the chunks wholly at or below its edge are not
// live steps (decode_tile.cuh Window).
extern "C" int q_decode_attention(const void* q, const void* pool, const void* scales,
                                  const void* k_win, const void* v_win, const void* n_chunks,
                                  const void* win_len, void* out, void* probs, void* ml,
                                  void* scratch, void* counters, int scratch_floats,
                                  int n_counters, int out_f32, int device, int kbits,
                                  int vbits, int BH, int G, int max_chunks, int W, int wt,
                                  int li, int window, void* stream) {
  if (wt < 1 || window < 0 || max_chunks < 0) return (int)cudaErrorInvalidValue;
  const int n_parts = grid_steps(max_chunks, W, wt, CHUNK);
  if (!args_ok(BH, G, W, wt, li, n_parts, n_chunks, win_len, scratch, scratch_floats,
               counters, n_counters, probs))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const Args a{q, pool, scales, k_win, v_win, n_chunks, win_len, out,
               static_cast<float*>(scratch), static_cast<int*>(counters), out_f32, BH,
               max_chunks, W, wt, li, n_parts, window, probs, ml};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kbits == 8 && vbits == 8) return launch_groups<8, 8>(G, a, device, s);
  if (kbits == 8 && vbits == 4) return launch_groups<8, 4>(G, a, device, s);
  if (kbits == 4 && vbits == 4) return launch_groups<4, 4>(G, a, device, s);
  return (int)cudaErrorInvalidValue;
}
