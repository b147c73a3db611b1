// Bitmap flash-decode attention for Hopper (sm_90a): the uniform-batch entry
// sp_decode and the per-slot entry sp_decode_ps, one kernel body
// (sp_decode.cuh) built into one library, with an instance per value width.
//
// sp_decode replaces the TPU kernel
// mustafar_tpu/ops/kernels/sparse_attention.py fused_sparse_decode_attention_v7
// (Pallas body _fused_v7_kernel) for the codecs bitmap (bf16 values, 16
// bits) and bitmap-q8 (int8 codes, 8 bits), with its options (sliding
// window, (m, l) stats, window probabilities) off.  For one layer `li` of
// the stacked cache and each (batch row b, kv head h) it attends the
// G = Hq / Hkv query heads of that kv head over
//   1. `n_chunks` packed pool chunks of 256 tokens, each a K stream then a
//      V stream of bitmap word planes and interleaved value segments
//      (bitmap_expand.cuh), expanded row by row in registers:
//      scores = bf16(q) . K / sqrt(128) at 16 bits; at 8 bits
//      bf16(bf16(q) * kscale) . codes / sqrt(128), and the chunk's value
//      product bf16(p) . codes times the V scale, the scales read per
//      (layer, chunk, b*Hkv + h) from the [L, mc, BH, 2, 128] bf16 tensor
//      through its strides, as the quant kernels read theirs;
//   2. the first `win_len` tokens of the dense bf16 residual window,
// under one online softmax in f32 (mask value -1e30, final l clamped at
// 1e-30), p rounded to bf16 before the value product as on the TPU.  The
// softmax steps are the TPU kernel's: one per chunk, then one per window
// tile of `wt` tokens, so the bf16 rounding of p happens at the same
// running max.
//
// What bounds it on this card: bytes.  Per layer it must read
//   B*Hkv*(n_chunks*((KR+VR)*128*2 + S) + 2*win_len*128*2) bytes (+ q, out),
// with KR = VR = 96 rows at sparsity 0.7 (keep 40 = 32 + 8) and no scales
// (S = 0) at 16 bits, 56 rows and S = 512 bytes of scales at 8 bits.  At
// B=8, Hkv=8, one chunk and a full 288-token window that is 12.6 MB at 16
// bits, some 3.8 us at 3.35 TB/s, and 11.3 MB, 3.4 us, at 8; the products
// are a few flops a byte.  In practice a kernel this small is bound by
// launch latency, by 64 blocks for 132 SMs and, here, by the expansion's
// instructions: every row costs four ballots, popcounts and gathers per
// lane.
//
// Design (first, simple version): sp_decode.cuh.  One block per (b, kv
// head), no split (the per-slot entry below splits); each chunk's stream
// is copied into shared memory with cp.async (the next chunk's copy in
// flight while this one is attended; the buffers are sized for the
// instance's width), and warps own token rows and expand
// them there with warp ballots (the counterpart of the CUDA reference's
// __clzll decompression), so each packed byte is read once from device
// memory and expanded chunks never exist in memory.  Split-K for this
// entry, TMA and CUDA graphs are later work.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include "sp_decode.cuh"

// q [B, 1, Hkv*G, 128] bf16; pool [L, mc, B*Hkv, KR+VR, 128] int16; scales
// [L, mc, B*Hkv, 2, 128] bf16 at `qbits` 8, null at 16; k_win / v_win
// [L, B*Hkv, W, 128] bf16; out [B, 1, Hkv*G, 128] f32 if `out_f32`, else
// bf16.  All contiguous; shapes checked by the caller.  `device` is the
// ordinal the tensors and the stream belong to; `wt` the window tokens per
// softmax step (1..256); (k0, k1) and (vk0, vk1) the K and V streams'
// segment widths (k1 = 0: one segment).
extern "C" int sp_decode(const void* q, const void* pool, const void* scales,
                         const void* k_win, const void* v_win, void* out, int out_f32,
                         int device, int qbits, int BH, int G, int max_chunks, int W,
                         int wt, int n_chunks, int win_len, int li, int k0, int k1,
                         int vk0, int vk1, void* stream) {
  if (n_chunks < 0 || n_chunks > max_chunks || win_len < 0 || win_len > W)
    return (int)cudaErrorInvalidValue;
  return bitmap_decode::launch_bits(qbits, k0, k1, vk0, vk1, q, pool, scales, k_win,
                                    v_win, out, out_f32, device, BH, G, max_chunks, W,
                                    wt, n_chunks, win_len, li, nullptr, nullptr, 1,
                                    nullptr, 0, stream);
}

// ---------------------------------------------------------------------------
// Per-slot decode (continuous batching)
//
// sp_decode_ps replaces the TPU kernel
// mustafar_tpu/ops/kernels/sparse_attention.py
// fused_sparse_decode_attention_v6ps (Pallas body _fused_v6ps_kernel) for
// the codecs bitmap and bitmap-q8, with its options (sliding window, window
// probabilities) off.  It is sp_decode with the counts read per slot: the
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
// What bounds it on this card: bytes, as for the uniform kernel: per layer
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
// uniform kernel's per-chunk (or per-tile) work and softmax step
// (sp_decode.cuh) from a fresh state; a block past its slot's clamped
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
// ceil(W / wt).
extern "C" int sp_decode_ps(const void* q, const void* pool, const void* scales,
                            const void* k_win, const void* v_win, const void* n_chunks,
                            const void* win_len, void* out, void* scratch,
                            int scratch_floats, int out_f32, int device, int qbits,
                            int BH, int hkv, int G,
                            int max_chunks, int W, int wt, int li, int k0, int k1,
                            int vk0, int vk1, int n_splits, void* stream) {
  if (n_chunks == nullptr || win_len == nullptr || scratch == nullptr || hkv < 1 ||
      BH % hkv || G < 1 || n_splits < 1 || scratch_floats < 0 ||
      (size_t)scratch_floats < split_merge::scratch_floats(BH, G, n_splits))
    return (int)cudaErrorInvalidValue;
  return bitmap_decode::launch_bits(qbits, k0, k1, vk0, vk1, q, pool, scales, k_win,
                                    v_win, out, out_f32, device, BH, G, max_chunks, W,
                                    wt, 0, 0, li, static_cast<const int*>(n_chunks),
                                    static_cast<const int*>(win_len), hkv,
                                    static_cast<float*>(scratch), n_splits, stream);
}
