// Quant-codec flash-decode attention for Hopper (sm_90a), uniform batch.
//
// Replaces the TPU kernel mustafar_tpu/ops/kernels/quant_attention.py
// fused_q_decode_attention (Pallas body _q_decode_kernel) for the codecs
// q8 (int8 K, int8 V), q8q4 (int8 K, int4 V) and q4q4 (int4 K, int4 V),
// with its options (sliding window, (m, l) stats, window probabilities)
// off.  For one layer `li` of the stacked cache and each (batch row b, kv
// head h) it attends the G = Hq / Hkv query heads of that kv head over
//   1. `n_chunks` packed pool chunks of 256 tokens: K, then V, as codes of
//      `kbits` / `vbits` bits, 16/bits tokens per int16 row (at 8 bits
//      token t in the low byte of row t and token t+128 in the high byte;
//      at 4 bits token t + 64 j in nibble j), each with a bf16 scale per
//      channel.  The K scale folds into q before the scores (scores =
//      bf16(q * kscale) . codes / sqrt(128)); the V scale multiplies each
//      chunk's p.v partial;
//   2. the first `win_len` tokens of the dense bf16 residual window, with q
//      unscaled,
// under one online softmax in f32 (mask value -1e30, final l clamped at
// 1e-30), p rounded to bf16 before the value product as on the TPU.  The
// softmax steps are the TPU kernel's: one per chunk, then one per window
// tile of `wt` tokens, so the running max, and with it the bf16 rounding
// of p, is the same at every step.
//
// What bounds it on this card: bytes.  Per layer it must read
//   B*Hkv*(n_chunks*ROWS*128*2 + 2*win_len*128*2) bytes (+ q, scales, out),
// with ROWS = 256 / 192 / 128 int16 rows a chunk at q8 / q8q4 / q4q4:
// about 6.4 MB at q8q4, B=8, Hkv=8, two chunks: some 2 us at 3.35 TB/s
// (NVIDIA H100 SXM's rate at its 700 W limit), against a
// few hundred flops per byte the card could do; a decode kernel this small
// is bound in practice by launch latency and by how few blocks there are.
//
// Design (first, simple version): one block of 256 threads per (b, kv
// head), all G query heads in the block, so each packed byte is read once
// from device memory and reused for G heads.  A loop over chunks and then
// over window tiles takes the place of the TPU's sequential
// grid.  For scores a warp reads one 256-byte K row (two or four tokens)
// with one 8-byte load per lane and reduces with shuffles; for values each
// thread owns one channel and one half of the tile's tokens and reads its
// int16 carrier column, so the loads of a warp are contiguous.  Codes are
// unpacked with sign-extending shifts in registers; dequantized chunks
// never exist in memory.  One source, templated on the bit widths: each
// library holds the 3 codecs x G in {1, 2, 4, 8}.  Split-K over chunks (the
// per-slot entry's design, q_decode_ps.cu), TMA, wgmma and CUDA graphs are
// later work.
//
// The kernel body lives in quant_decode.cuh, shared with the per-slot entry
// (q_decode_ps.cu).  Interface: plain C, no PyTorch headers, bound with
// ctypes.  Launches on the caller's stream, synchronises nothing and
// returns cudaGetLastError().

#include "quant_decode.cuh"

// q [B, 1, Hkv*G, 128] bf16; pool [L, mc, B*Hkv, ROWS, 128] int16 (ROWS
// = 256 * (kbits + vbits) / 16; (kbits, vbits) one of (8, 8), (8, 4), (4, 4));
// scales [L, mc, B*Hkv, 2, 128] bf16; k_win / v_win [L, B*Hkv, W, 128] bf16;
// out [B, 1, Hkv*G, 128] f32 if `out_f32`, else bf16.  All contiguous;
// shapes checked by the caller.  `device` is the ordinal the tensors and the
// stream belong to; `wt` the window tokens per softmax step (1..256).
extern "C" int q_decode_attention(const void* q, const void* pool, const void* scales,
                                  const void* k_win, const void* v_win, void* out,
                                  int out_f32, int device, int kbits, int vbits, int BH,
                                  int G, int max_chunks, int W, int wt, int n_chunks,
                                  int win_len, int li, void* stream) {
  const qdec::Args a{q, pool, scales, k_win, v_win, out, out_f32, BH, max_chunks,
                     W, wt, n_chunks, win_len, li, nullptr, nullptr, 1, nullptr, 0};
  return qdec::launch_decode<false>(a, device, kbits, vbits, G, stream);
}
