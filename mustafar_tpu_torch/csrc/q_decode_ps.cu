// Quant-codec flash-decode attention for Hopper (sm_90a), per-slot counts.
//
// Replaces the TPU kernel mustafar_tpu/ops/kernels/quant_attention.py
// fused_q_decode_attention_ps (Pallas body _q_ps_kernel) for the codecs
// q8, q8q4 and q4q4, with its options (sliding window, window
// probabilities) off.  It
// is the uniform kernel of q_decode.cu with the counts read per slot:
// block (b, kv head h) attends its G query heads over slot b's first
// n_chunks[b] pool chunks and win_len[b] window tokens, the counts taken
// from int32 device arrays, so the continuous-batching decode step never
// syncs with the host to size itself.  Counts are clamped into [0, mc] and
// [0, W] in the kernel; an idle slot is passed as (0, 0) and writes 0.
//
// Softmax steps: the TPU kernel runs a block of up to 16 heads, and loops
// every head to the largest chunk count and window length among them; the
// extra steps of a head are fully masked (scores -1e30).  For a head with
// something to attend they add exactly zero: once its running max m is
// finite, p = exp(-1e30 - m) = 0 and the correction exp(m - m) = 1.  (A
// head whose first real step comes after such masked steps starts from
// m = -1e30; its first real step multiplies whatever was summed by
// exp(-1e30 - m) = 0.)  So a block that loops only over its own slot's
// counts, one step per chunk and then window tiles of `wt` tokens, takes
// the same steps and rounds p to bf16 at the same running max.
//
// What bounds it on this card: bytes, as for the uniform kernel: per layer
// B*Hkv*(n_chunks*ROWS*128*2 + 2*win_len*128*2) bytes of pools and windows.
// At the serving shape (B=8, Hkv=8, a few chunks) that is some 2-8 us of
// device memory time; one block per (slot, kv head) is 64 blocks for 132
// SMs, and slots with long caches keep their blocks longest.  Split-K over
// chunks would even that out and is later work.
//
// Design and interface: the kernel body of quant_decode.cuh (see
// q_decode.cu), plain C entry bound with ctypes, launched on the caller's
// stream, returning cudaGetLastError().

#include "quant_decode.cuh"

// As q_decode_attention (q_decode.cu), with the counts in device arrays:
// n_chunks[B], win_len[B] int32; `hkv` the kv heads per slot (BH = B*hkv).
extern "C" int q_decode_attention_ps(const void* q, const void* pool,
                                     const void* scales, const void* k_win,
                                     const void* v_win, const void* n_chunks,
                                     const void* win_len, void* out, int out_f32,
                                     int device, int kbits, int vbits, int BH, int hkv,
                                     int G, int max_chunks, int W, int wt, int li,
                                     void* stream) {
  if (n_chunks == nullptr || win_len == nullptr || hkv < 1 || BH % hkv)
    return (int)cudaErrorInvalidValue;
  return qdec::launch_decode(q, pool, scales, k_win, v_win, out, out_f32, device,
                             kbits, vbits, BH, G, max_chunks, W, wt, 0, 0, li,
                             static_cast<const int*>(n_chunks),
                             static_cast<const int*>(win_len), hkv, stream);
}
