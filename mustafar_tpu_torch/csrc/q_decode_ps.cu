// Quant-codec flash-decode attention for Hopper (sm_90a), per-slot counts.
//
// Replaces the TPU kernel mustafar_tpu/ops/kernels/quant_attention.py
// fused_q_decode_attention_ps (Pallas body _q_ps_kernel) for the codecs
// q8, q8q4 and q4q4, with its window probabilities (return_win_probs,
// split_merge.cuh: a third launch after the merge) and its sliding window
// (window > 0: slot b attends its pool columns past n_chunks[b] * 256 +
// win_len[b] - 1 - window; quant_decode.cuh).  The G query heads of (slot
// b, kv head h) attend
// slot b's first n_chunks[b] pool chunks and win_len[b] window tokens, the
// counts taken from int32 device arrays, so the continuous-batching decode
// step never syncs with the host to size itself.  Counts are clamped into
// [0, mc] and [0, W] in the kernel; an idle slot is passed as (0, 0) and
// comes out 0.  Per chunk and window token the arithmetic is that of
// fused_q_decode_attention (q_decode.cu): the same casts and scaling.
//
// Softmax steps: the TPU kernel runs a block of up to 16 heads, and loops
// every head to the largest chunk count and window length among them; the
// extra steps of a head are fully masked (scores -1e30).  For a head with
// something to attend they add exactly zero: once its running max m is
// finite, p = exp(-1e30 - m) = 0 and the correction exp(m - m) = 1.  (A
// head whose first real step comes after such masked steps starts from
// m = -1e30; its first real step multiplies whatever was summed by
// exp(-1e30 - m) = 0.)  So the TPU takes one step per chunk of the slot,
// then window tiles of `wt` tokens (fused_q_decode_attention_ps_plain);
// the splits below take the same steps' ranges, each from its own running
// max.  With a sliding window the TPU also runs the chunks wholly below a
// slot's edge, masked, and relies on the next live step's correction
// exp(-1e30 - m) = 0; here their splits exit unread (the grid is still
// sized from mc and W on the host: nothing syncs), the edge's split masks
// its dead columns, and the merge reads the live splits only
// (split_merge::SlotLive): a split merged at its own max must have a live
// column.  At the engine's slots with the 8,000-token one at 31 chunks +
// 160 and Mistral's window of 4,096 (15 of its chunk splits exit) the
// call took 0.0419 ms against 0.0446 without the window at q8q4 (NVIDIA
// H100 80GB HBM3, 700.00 W; chip_smoke.py kernel_ps, PERF.md §6).
//
// What bounds it on this card: bytes.  Per layer it must read the sum over
// slots of Hkv*(n_chunks[b]*(ROWS*128*2 + 512) + 2*win_len[b]*128*2) bytes
// of pools, scales and windows (ROWS = 256 / 192 / 128 at q8 / q8q4 /
// q4q4): 21.7 MB at q8q4 at the engine's mixed slots (45 chunks and 910
// window tokens over 8 slots, 8 kv heads), 6.5 us at 3.35 TB/s.
//
// Design: split-K.  With one block per (b, kv head) a call waited on its
// longest slot: at those slots the 8 blocks of the 31-chunk slot walked 31
// chunks in series while the other 56 sat done, 0.631 ms at q8q4 (NVIDIA
// H100 80GB HBM3, 700.00 W).  So the grid covers (b, kv head, split),
// sized on the host from mc and W with no sync: split s < mc takes pool
// chunk s, split mc + j window tile j (3 at W = 288).  Each split does the
// per-chunk (or per-tile) work and softmax step of quant_decode.cuh
// from a fresh state; a block past its slot's clamped
// counts exits at once and writes nothing.  Its partials go to scratch and
// a second kernel merges each row's live splits in split order
// (split_merge.cuh, split_merge::SlotLive); an idle slot comes out 0, a
// slot with chunks but no window (or the reverse) merges what it has.  A
// split rounds p at its own running max, so the kernel's plain version is
// fused_q_decode_attention_ps_split_plain.
//
// One chunk a split, and four blocks an SM.  The work is the chunks: 45
// per kv head at the mixed slots, 360 chunk blocks beside 96 window ones
// at G = 4.  A block of 256 threads keeps no stage buffer (its loads go
// straight to registers) and 8 KB of shared memory at G = 4; built for four
// blocks an SM (64 registers, no spills), 528 resident blocks hold the
// mixed slots' 456 in one wave.  The blocks past the counts (most of the
// 35 x 64 at mc = 32) cost a read of two counts each.  Measured on an
// NVIDIA H100 80GB HBM3 at 700.00 W (tools/kernel_ab.py, PERF.md §6): at
// the mixed slots 0.0447 ms at q8q4, 0.0449 at q8, 0.0434 at q4q4 (one
// block per (b, kv head): 0.632 / 0.650 / 0.538), at the light slots (0-5
// chunks) 0.035 (0.138); built for three blocks an SM 0.0475 at the mixed
// slots, for two 0.059 (two waves), though two take the light slots in
// 0.033.
//
// Splits need (acc, m, l) scratch of BH * n_splits * G * 130 floats (4.7 MB
// at mc = 32, G = 4): the wrapper passes an uninitialised buffer, kept from
// call to call, and its size, which the entry checks.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches the
// split kernel and the merge on the caller's stream, synchronises nothing
// and returns cudaGetLastError().

#include "quant_decode.cuh"

namespace {

using qdec::quant_decode_kernel;
using qdec::THREADS;
using qdec::TILE;

// The launch parameters of the per-slot entry.
struct Args {
  const void *q, *pool, *scales, *k_win, *v_win;
  void* out;
  int out_f32, BH, max_chunks, W, wt, n_chunks, win_len, li;
  const int *nc_slot, *wl_slot;
  int hkv;
  float* part;                    // scratch of n_splits splits a row
  int n_splits;
  split_merge::SlotProbs sp;      // window probabilities (sp.out null: off)
  int window;                     // sliding window, 0: none
};

template <int G, int KB, int VB>
void launch(const Args& a, cudaStream_t stream) {
  quant_decode_kernel<G, KB, VB><<<dim3(a.BH, a.n_splits), THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const int16_t*>(a.pool),
      static_cast<const __nv_bfloat16*>(a.scales), static_cast<const __nv_bfloat16*>(a.k_win),
      static_cast<const __nv_bfloat16*>(a.v_win), a.out, a.out_f32, a.BH, a.max_chunks, a.W,
      a.wt, a.n_chunks, a.win_len, a.li, a.nc_slot, a.wl_slot, a.hkv, a.part, a.n_splits,
      a.sp, a.window);
}

template <int KB, int VB>
int launch_groups(int G, const Args& a, cudaStream_t s) {
  switch (G) {
    case 1: launch<1, KB, VB>(a, s); break;
    case 2: launch<2, KB, VB>(a, s); break;
    case 4: launch<4, KB, VB>(a, s); break;
    case 8: launch<8, KB, VB>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Checks the launch parameters, selects the instance for the codec's bit
// widths (kbits, vbits) and the group size G: a grid of max_chunks chunk
// splits and ceil(W / wt) window splits per row, its partials in `a.part`,
// then the merge of each row's live splits (split_merge::SlotLive); returns
// cudaGetLastError().
inline int launch_decode(const Args& a, int device, int kbits, int vbits, int G,
                         void* stream) {
  if (a.wt < 1 || a.wt > TILE || a.window < 0) return (int)cudaErrorInvalidValue;
  if (a.nc_slot == nullptr || a.part == nullptr ||
      a.n_splits != a.max_chunks + (a.W + a.wt - 1) / a.wt)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = (int)cudaErrorInvalidValue;
  if (kbits == 8 && vbits == 8) err = launch_groups<8, 8>(G, a, s);
  if (kbits == 8 && vbits == 4) err = launch_groups<8, 4>(G, a, s);
  if (kbits == 4 && vbits == 4) err = launch_groups<4, 4>(G, a, s);
  if (err != (int)cudaSuccess) return err;
  return (int)split_merge::launch_merge_probs(
      a.part, a.out, a.out_f32, a.BH, G, a.n_splits,
      split_merge::SlotLive{a.nc_slot, a.wl_slot, a.hkv, a.max_chunks, a.W, a.wt, a.window}, s,
      a.sp);
}

}  // namespace

// As q_decode_attention (q_decode.cu), with the counts in device arrays:
// n_chunks[B], win_len[B] int32; `hkv` the kv heads per slot (BH = B*hkv);
// scratch f32, `scratch_floats` of them, refused if fewer than
// split_merge::scratch_floats(BH, G, n_splits), with n_splits = max_chunks +
// ceil(W / wt).  `probs` null, or f32 [B*Hkv, W] for the window
// probabilities; the scratch then holds split_merge::slot_probs_floats(BH,
// G, W) floats more, for the window scores and the final stats.  `window`
// the sliding window, 0 for none.
extern "C" int q_decode_attention_ps(const void* q, const void* pool,
                                     const void* scales, const void* k_win,
                                     const void* v_win, const void* n_chunks,
                                     const void* win_len, void* out, void* probs,
                                     void* scratch, int scratch_floats, int out_f32,
                                     int device, int kbits, int vbits, int BH, int hkv,
                                     int G, int max_chunks, int W, int wt, int li,
                                     int n_splits, int window, void* stream) {
  if (n_chunks == nullptr || win_len == nullptr || scratch == nullptr || hkv < 1 ||
      BH % hkv || G < 1 || n_splits < 1 || scratch_floats < 0 || W < 0 ||
      (size_t)scratch_floats < split_merge::scratch_floats(BH, G, n_splits) +
                                   (probs != nullptr ? split_merge::slot_probs_floats(BH, G, W)
                                                     : 0))
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(scratch);
  const Args a{q, pool, scales, k_win, v_win, out, out_f32, BH, max_chunks, W, wt,
                     0, 0, li, static_cast<const int*>(n_chunks),
                     static_cast<const int*>(win_len), hkv, part, n_splits,
                     split_merge::slot_probs(probs, part, BH, G, n_splits, W), window};
  return launch_decode(a, device, kbits, vbits, G, stream);
}
