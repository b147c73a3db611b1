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
// head); each chunk's stream is copied into shared memory with cp.async
// (the next chunk's copy in flight while this one is attended; the buffers
// are sized for the instance's width), and warps own token rows and expand
// them there with warp ballots (the counterpart of the CUDA reference's
// __clzll decompression), so each packed byte is read once from device
// memory and expanded chunks never exist in memory.  Split-K over chunks,
// TMA and CUDA graphs are later work.
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
                                    stream);
}

// ---------------------------------------------------------------------------
// Per-slot decode (continuous batching)
//
// sp_decode_ps replaces the TPU kernel
// mustafar_tpu/ops/kernels/sparse_attention.py
// fused_sparse_decode_attention_v6ps (Pallas body _fused_v6ps_kernel) for
// the codecs bitmap and bitmap-q8, with its options (sliding window, window
// probabilities) off.  It is sp_decode with the
// counts read per slot: block (b, kv head h) attends
// its G query heads over slot b's first n_chunks[b] pool chunks and
// win_len[b] window tokens, taken from int32 device arrays, so the
// continuous-batching decode step never syncs with the host to size itself.
// Counts are clamped into [0, mc] and [0, W] in the kernel; an idle slot is
// passed as (0, 0) and writes 0.
//
// Softmax steps: the TPU block spans 16 heads, trips to the block's largest
// chunk count and window length, and masks each head's columns by its own
// counts.  A masked step adds exactly zero to a head once it has a live
// column (p = exp(-1e30 - m) = 0, correction 1); masked steps before its
// first live one are wiped by that step's correction exp(-1e30 - m) = 0.
// So a block that loops over its own slot's counts, one step per chunk and
// then window tiles of `wt` tokens, takes the TPU's steps.
//
// What bounds it on this card: bytes, as for the uniform kernel: per layer
// the sum over slots of Hkv*(n_chunks[b]*((KR+VR)*128*2 + S) +
// 2*win_len[b]*128*2) bytes of pools, scales and windows.  Slots with long caches keep their blocks
// longest; split-K over chunks would even that out and is later work.

// As sp_decode, with the counts in device arrays:
// n_chunks[B], win_len[B] int32; `hkv` the kv heads per slot (BH = B*hkv).
extern "C" int sp_decode_ps(const void* q, const void* pool, const void* scales,
                            const void* k_win, const void* v_win, const void* n_chunks,
                            const void* win_len, void* out, int out_f32, int device,
                            int qbits, int BH, int hkv, int G, int max_chunks, int W,
                            int wt, int li, int k0, int k1, int vk0, int vk1,
                            void* stream) {
  if (n_chunks == nullptr || win_len == nullptr || hkv < 1 || BH % hkv)
    return (int)cudaErrorInvalidValue;
  return bitmap_decode::launch_bits(qbits, k0, k1, vk0, vk1, q, pool, scales, k_win,
                                    v_win, out, out_f32, device, BH, G, max_chunks, W,
                                    wt, 0, 0, li, static_cast<const int*>(n_chunks),
                                    static_cast<const int*>(win_len), hkv, stream);
}
