// Expansion of one bitmap-coded chunk row, shared by the bitmap attention
// kernels (sp_decode.cu, sp_segment.cu) and the archived generations
// (sp_archive_spmv.cu over split pools, sp_archive_stream.cu), templated on
// the value width QBITS: 16 (codec bitmap, bf16 values) or 8 (codec
// bitmap-q8, int8 codes), and on the bitmap's word width WORD_BITS (16 or
// 32).  The uniform decodes expand from a run of a chunk's tokens
// (chunk_share.cuh), on this format.
//
// A chunk's fused stream (ops/sparse_format.py encode_stream and
// encode_stream_q8) is, for C=256 tokens and D=128 channels, int16 rows of
// 128 lanes:
//   rows [0, p0)             segment 0, width k0 per token
//   rows [p0, p0 + p1)       segment 1 (if k1 > 0), width k1
//   rows [p0 + p1, +16)      the bitmap as uint16 word planes: the bit of
//                            (token t, channel d) is bit t / 16 of word
//                            [t % 16, d]
// A width-k segment has r = C*k/128 logical rows of 128 values: token t's
// values lie in logical row t % r, lanes (t / r)*k ..  At 16 bits a logical
// row is a stream row (p = r, bf16 bit patterns).  At 8 bits two logical
// rows share one (p = r / 2): stream row j holds logical row j in its low
// byte and logical row j + r/2 in its high byte, each a sign-extended int8
// code; the chunk's per-channel scales are applied by the kernels, not
// here.  Every row has exactly k0 + k1 set bits (zero-valued pads
// included), and its j-th set channel (rank j) holds value j of the token:
// segment 0 while j < k0, else segment 1 at j - k0.  Values are placed by
// the bitmap: a kept value smaller than half its scale has code 0 and its
// bit set.
//
// The archive's split pools (ops/sparse_format.py encode_chunk) keep the
// same segments apart from a bitmap of C/32 = 8 uint32 word planes [8, 128]:
// the bit of (token t, channel d) is bit t / 8 of word [t % 8, d].  The
// SpMV kernels stage a chunk's pieces into shared memory in the stream's order,
// segment 0 rows, segment 1 rows, then the words (8 planes of 512 bytes
// take the 16 rows of the uint16 planes), so stored_value addresses the
// values as in a stream and only the word read differs (WORD_BITS = 32).
//
// The kernels first copy a chunk's whole stream (K and V: 192 rows, 48 KB
// at sparsity 0.7 and 16 bits; 112 rows, 28 KB at 8 bits) into shared
// memory with cp.async, 16 bytes a thread, every copy in flight at once
// (stage_rows_async), and expand from there: reading the rows straight
// from device memory made every row wait on two dependent loads (its
// words, then its values).
//
// The TPU kernel computes the ranks with a triangular matmul over the whole
// tile.  Here one warp expands one token row: lane l owns channels l + 32 i
// (i = 0..3), each of the four warp ballots over a 32-channel slice gives
// every lane its set bits below it, and the rank is a popcount.  A lane
// reads its value only where its bit is set (the TPU's gather clamps an
// out-of-range index; CUDA would read out of bounds), and a rank past the
// stored count, which a well-formed stream never has, is clamped as
// decode_stream clamps it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_stage.cuh"

namespace bitmap {

using smem::cp_async_commit;
using smem::cp_async_wait;

constexpr int D = 128;                 // head_dim == lane width
constexpr int CHUNK = 256;             // tokens per packed chunk
constexpr int WORD_ROWS = CHUNK / 16;  // bitmap rows of one stream (uint16 planes;
                                       // the 8 uint32 planes take as many bytes)
constexpr int ROWS_IN_FLIGHT = 4;      // rows a warp expands back to back

// One stream's value segments: widths k0 and k1 (k1 = 0: one segment), and
// the log2 of their logical row counts r = C*k/128 (powers of two), so that
// a token's row and lane come from shifts and masks, not divisions.  The
// stream rows a segment takes, p0 and p1, are r at 16 bits and r / 2 at 8.
template <int QBITS>
struct Fmt {
  static_assert(QBITS == 16 || QBITS == 8, "bf16 values or int8 codes");
  int k0, k1;
  int lr0, lr1;
  __host__ __device__ int p0() const { return (CHUNK * k0 / D) * QBITS / 16; }
  __host__ __device__ int p1() const { return (CHUNK * k1 / D) * QBITS / 16; }
  __host__ __device__ int val_rows() const { return p0() + p1(); }
  __host__ __device__ int rows() const { return val_rows() + WORD_ROWS; }
};

inline int log2_exact(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return (1 << l) == x ? l : -1;
}

// The format of widths (k0, k1); ok is false unless they are what the codec
// produces: powers of two, k1 <= k0, k0 + k1 <= 128, whole rows (and at 8
// bits an even number of logical rows a segment, to pair them).
template <int QBITS>
inline Fmt<QBITS> make_fmt(int k0, int k1, bool* ok) {
  Fmt<QBITS> f{k0, k1, 0, 0};
  *ok = k0 >= 1 && k1 >= 0 && k1 <= k0 && k0 + k1 <= D &&
        (CHUNK * k0) % D == 0 && (CHUNK * k1) % D == 0;
  if (!*ok) return f;
  f.lr0 = log2_exact(CHUNK * k0 / D);
  f.lr1 = k1 ? log2_exact(CHUNK * k1 / D) : 0;
  const int min_lr = QBITS == 8 ? 1 : 0;
  *ok = f.lr0 >= min_lr && (k1 == 0 || f.lr1 >= min_lr);
  return f;
}

__device__ __forceinline__ float bf16_bits(uint16_t x) {
  return __uint_as_float((uint32_t)x << 16);
}

// The value of rank `rank` in token row t (its bit set): the bf16 value as
// f32, or the int8 code as an exact f32 integer.
template <int QBITS>
__device__ __forceinline__ float stored_value(const uint16_t* s, const Fmt<QBITS> f,
                                              int t, int rank) {
  int lr, row, at, base;   // log2 of the segment's logical rows, the token's
  if (rank < f.k0) {       // logical row, its lane, the segment's first row
    lr = f.lr0;
    row = t & ((1 << f.lr0) - 1);
    at = (t >> f.lr0) * f.k0 + rank;
    base = 0;
  } else {
    lr = f.lr1;
    row = t & ((1 << f.lr1) - 1);
    at = (t >> f.lr1) * f.k1 + (rank - f.k0);
    base = (1 << f.lr0) * QBITS / 16;
  }
  if constexpr (QBITS == 16) {
    return bf16_bits(s[(base + row) * D + at]);
  } else {
    // logical row `row` is stream row row % (r/2), in the low byte in the
    // first half of the logical rows, in the high byte in the second
    const int lp = lr - 1;
    const int w = s[(base + (row & ((1 << lp) - 1))) * D + at];
    const int byte = (row >> lp) ? (w >> 8) : (w & 0xff);
    return (float)((byte ^ 0x80) - 0x80);       // sign-extended int8
  }
}

// Token row t of the stream at `stream`, expanded by the calling warp into
// v[i] = channel lane + 32 i (bf16 values or int8 codes as f32; 0 where the
// bit is unset).  All 32 lanes must call it together.  Callers expand a few
// rows back to back (ROWS_IN_FLIGHT), so that their independent chains of
// shared-memory loads, ballots and popcounts overlap.  WORD_BITS is the
// bitmap's word width: 16 for a fused stream, 32 for staged split pools.
template <int QBITS, int WORD_BITS = 16>
__device__ __forceinline__ void expand_row(const int16_t* __restrict__ stream,
                                           const Fmt<QBITS> f, int t, int lane,
                                           float (&v)[4]) {
  static_assert(WORD_BITS == 16 || (WORD_BITS == 32 && QBITS == 16),
                "uint16 word planes, or the split pools' uint32 planes (bf16 values)");
  constexpr int PLANES = CHUNK / WORD_BITS;
  const uint16_t* s = reinterpret_cast<const uint16_t*>(stream);
  const uint16_t* words = s + (size_t)(f.val_rows() + t % PLANES) * D;
  const uint32_t* words32 =
      reinterpret_cast<const uint32_t*>(s + (size_t)f.val_rows() * D) + (t % PLANES) * D;
  const int sh = t / PLANES;
  const unsigned below = (1u << lane) - 1u;
  const int keep = f.k0 + f.k1;
  int base = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // unsigned words (uint16 widens to a non-negative int), so the shift is
    // logical
    int bit;
    if constexpr (WORD_BITS == 16)
      bit = (words[lane + 32 * i] >> sh) & 1;
    else
      bit = (int)((words32[lane + 32 * i] >> sh) & 1u);
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    const int rank = min(base + __popc(set & below), keep - 1);
    base += __popc(set);
    float x = 0.f;
    if (bit) x = stored_value<QBITS>(s, f, t, rank);
    v[i] = x;
  }
}

// Issues the copy of `rows` rows of 256 bytes (16-byte aligned) from device
// memory to shared memory with cp.async, 16 bytes a thread, without closing
// the group: a split-pool chunk's pieces join one group.
__device__ __forceinline__ void copy_rows_async(void* dst, const void* src, int rows,
                                                int tid, int nthreads) {
  const int n = rows * (D * 2 / 16);
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  const char* from = reinterpret_cast<const char*>(src);
  for (int i = tid; i < n; i += nthreads)
    smem::cp_async16(base + 16u * i, from + 16 * (size_t)i);
}

// Starts the copy of `rows` stream rows (rows * 256 bytes, 16-byte aligned)
// from device memory to shared memory, 16 bytes a thread, as one cp.async
// group; cp_async_wait<N>() then waits until at most N groups are pending.
__device__ __forceinline__ void stage_rows_async(int16_t* dst, const int16_t* src,
                                                 int rows, int tid, int nthreads) {
  copy_rows_async(dst, src, rows, tid, nthreads);
  cp_async_commit();
}

// Stages chunk `piece` of one stream's split pools (segments [p0 | p1, 128]
// bf16 and words [8, 128] uint32, each pool a run of such pieces) into
// `dst` in the stream's order, for expand_row<16, 32>: cp.async copies of
// the caller's open group.
__device__ __forceinline__ void stage_split(int16_t* dst, const int16_t* seg0,
                                            const int16_t* seg1, const uint32_t* words,
                                            const Fmt<16> f, size_t piece, int tid,
                                            int nthreads) {
  const int16_t* from[3] = {seg0 + piece * f.p0() * D, seg1 + piece * f.p1() * D,
                            reinterpret_cast<const int16_t*>(words + piece * (CHUNK / 32) * D)};
  const int rows[3] = {f.p0(), f.k1 ? f.p1() : 0, WORD_ROWS};
  int16_t* to = dst;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    copy_rows_async(to, from[j], rows[j], tid, nthreads);
    to += (size_t)rows[j] * D;
  }
}

}  // namespace bitmap
