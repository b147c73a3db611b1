// The archive's fused decode-attention generations v2 and v3 for Hopper
// (sm_90a), over split pools (ops/sparse_format.py encode_chunk): one
// kernel body over two pool layouts.
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
//      segments (bf16) and 8 uint32 word planes (bitmap_expand.cuh):
//      scores = bf16(q) . K / sqrt(128) in f32;
//   2. the dense bf16 window [B, W, Hkv, 128], in ONE online-softmax step
//      over its columns, those at or past `win_len` at -1e30,
// p rounded to bf16 before the value product, out = acc / l.  A masked
// column adds exactly 0 once a live column has set the running max (p =
// exp(-1e30 - m) = 0, and no max moves), so the kernel leaves masked
// columns out, reading only `win_len` window rows, except with nothing to
// attend at all (n_chunks = win_len = 0): there every column's p is
// exp(0) = 1, as on the TPU, and the output is the mean of all W rows of V.
//
// What bounds it on this card: bytes.  Per call it must read
//   B*Hkv*(n_chunks*2*24,576 + 2*win_len*128*2) bytes (+ q, out)
// at sparsity 0.7 (keep 40 = 32 + 8: 80 value rows and 16 rows of words a
// stream and chunk).  At B=8, Hkv=8, one chunk and a 288-token window that
// is 12.7 MB, some 3.8 us at 3.35 TB/s; at B=32, three chunks and 132
// window tokens 55.6 MB, 16.6 us.  The products are a few flops a byte.
// As for the production kernel (sp_decode.cu), the expansion's
// instructions, one block per kv head and launch latency bound it first.
//
// Design (first, simple version), one block of 8 warps per (b, kv head),
// the body shared with v4 and v6 (archive_fused.cuh, which says what it
// computes):
//   v2: each chunk's pieces (K segments, K words, V segments, V words) are
//       loaded into shared memory in stream order with plain 16-byte loads,
//       then attended: the TPU's grid step per chunk becomes a loop in the
//       block, and a load waits for nothing but itself;
//   v3: the next chunk's pieces are in flight with cp.async while this one
//       is attended (two buffers), the Hopper form of v3's make_async_copy
//       pair over its chunk-major pools.
// Warps own token rows and expand them with warp ballots; a lane keeps its
// four channels of every head's accumulator, rescaled at each step, and
// the warps' accumulators are summed once at the end.  Split-K, wgmma and
// TMA are later work.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include "archive_fused.cuh"

namespace {

using archive_fused::Layout;

template <Layout LAYOUT>
int launch_split(const void* q, const void* ks0, const void* ks1, const void* kb,
                 const void* vs0, const void* vs1, const void* vb, const void* k_win,
                 const void* v_win, void* out, int out_f32, int device, int B, int Hkv,
                 int G, int mc, int W, int n_chunks, int win_len, int k0, int k1, int vk0,
                 int vk1, void* stream) {
  const archive_fused::Pools pools{
      static_cast<const int16_t*>(ks0), static_cast<const int16_t*>(ks1),
      static_cast<const uint32_t*>(kb), static_cast<const int16_t*>(vs0),
      static_cast<const int16_t*>(vs1), static_cast<const uint32_t*>(vb), nullptr};
  return archive_fused::launch<LAYOUT, false>(q, pools, k_win, v_win, out, nullptr, nullptr,
                                              out_f32, device, B, Hkv, G, mc, W, n_chunks,
                                              win_len, -1, k0, k1, vk0, vk1, stream);
}

}  // namespace

// q [B, 1, Hkv*G, 128] bf16; the K and V pools' segments (bf16; the second
// null when that stream has one segment) and words (uint32), head-major;
// k_win / v_win [B, W, Hkv, 128] bf16; out [B, 1, Hkv*G, 128], f32 if
// `out_f32`, else bf16.  All contiguous and 16-byte aligned; shapes checked
// by the caller.  (k0, k1) and (vk0, vk1) are the streams' segment widths.
// A window whose scores do not fit in shared memory beside the chunk
// buffers (W past some 1,500 at G=8) is refused (cudaErrorInvalidValue).
extern "C" int sp_fused_v2(const void* q, const void* ks0, const void* ks1, const void* kb,
                           const void* vs0, const void* vs1, const void* vb,
                           const void* k_win, const void* v_win, void* out, int out_f32,
                           int device, int B, int Hkv, int G, int mc, int W, int n_chunks,
                           int win_len, int k0, int k1, int vk0, int vk1, void* stream) {
  return launch_split<Layout::kHeadMajor>(q, ks0, ks1, kb, vs0, vs1, vb, k_win, v_win, out,
                                          out_f32, device, B, Hkv, G, mc, W, n_chunks, win_len,
                                          k0, k1, vk0, vk1, stream);
}

// As sp_fused_v2, over chunk-major pools.
extern "C" int sp_fused_v3(const void* q, const void* ks0, const void* ks1, const void* kb,
                           const void* vs0, const void* vs1, const void* vb,
                           const void* k_win, const void* v_win, void* out, int out_f32,
                           int device, int B, int Hkv, int G, int mc, int W, int n_chunks,
                           int win_len, int k0, int k1, int vk0, int vk1, void* stream) {
  return launch_split<Layout::kChunkMajor>(q, ks0, ks1, kb, vs0, vs1, vb, k_win, v_win, out,
                                           out_f32, device, B, Hkv, G, mc, W, n_chunks, win_len,
                                           k0, k1, vk0, vk1, stream);
}
