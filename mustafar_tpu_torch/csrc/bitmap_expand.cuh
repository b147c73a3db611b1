// Expansion of one bitmap-coded chunk row, shared by the bitmap attention
// kernels (sp_decode.cu, sp_segment.cu).
//
// A chunk's fused stream (ops/sparse_format.py encode_stream) is, for C=256
// tokens and D=128 channels, int16 rows of 128 lanes:
//   rows [0, r0)             segment 0: bf16 values, width k0 per token;
//                            token t's in row t % r0, lanes (t / r0)*k0 ..
//   rows [r0, r0 + r1)       segment 1 (if k1 > 0), width k1, same rule
//   rows [r0 + r1, +16)      the bitmap as uint16 word planes: the bit of
//                            (token t, channel d) is bit t / 16 of word
//                            [t % 16, d]
// with r = C*k/128.  Every row has exactly k0 + k1 set bits (zero-valued
// pads included), and its j-th set channel (rank j) holds value j of the
// token: segment 0 while j < k0, else segment 1 at j - k0.
//
// The kernels first copy a chunk's whole stream (K and V: 192 rows, 48 KB
// at sparsity 0.7) into shared memory with cp.async, 16 bytes a thread,
// every copy in flight at once (stage_rows_async), and expand from there:
// reading the rows straight from device memory made every row wait on two
// dependent loads (its words, then its values).
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

namespace bitmap {

constexpr int D = 128;                 // head_dim == lane width
constexpr int CHUNK = 256;             // tokens per packed chunk
constexpr int WORD_ROWS = CHUNK / 16;  // bitmap word planes of one stream
constexpr int ROWS_IN_FLIGHT = 4;      // rows a warp expands back to back

// One stream's value segments: widths k0 and k1 (k1 = 0: one segment), and
// the log2 of their row counts r = C*k/128 (powers of two), so that a token's
// row and lane come from shifts and masks, not divisions.
struct Fmt {
  int k0, k1;
  int lr0, lr1;
  __host__ __device__ int r0() const { return CHUNK * k0 / D; }
  __host__ __device__ int r1() const { return CHUNK * k1 / D; }
  __host__ __device__ int val_rows() const { return r0() + r1(); }
  __host__ __device__ int rows() const { return val_rows() + WORD_ROWS; }
};

inline int log2_exact(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return (1 << l) == x ? l : -1;
}

// The format of widths (k0, k1); ok is false unless they are what the codec
// produces: powers of two, k1 <= k0, k0 + k1 <= 128, whole rows.
inline Fmt make_fmt(int k0, int k1, bool* ok) {
  Fmt f{k0, k1, 0, 0};
  *ok = k0 >= 1 && k1 >= 0 && k1 <= k0 && k0 + k1 <= D &&
        (CHUNK * k0) % D == 0 && (CHUNK * k1) % D == 0;
  if (!*ok) return f;
  f.lr0 = log2_exact(f.r0());
  f.lr1 = k1 ? log2_exact(f.r1()) : 0;
  *ok = f.lr0 >= 0 && f.lr1 >= 0;
  return f;
}

__device__ __forceinline__ float bf16_bits(uint16_t x) {
  return __uint_as_float((uint32_t)x << 16);
}

// Token row t of the stream at `stream`, expanded by the calling warp into
// v[i] = channel lane + 32 i (bf16 values as f32; 0 where the bit is unset).
// All 32 lanes must call it together.  Callers expand a few rows back to
// back (ROWS_IN_FLIGHT), so that their independent chains of shared-memory
// loads, ballots and popcounts overlap.
__device__ __forceinline__ void expand_row(const int16_t* __restrict__ stream,
                                           const Fmt f, int t, int lane,
                                           float (&v)[4]) {
  const uint16_t* s = reinterpret_cast<const uint16_t*>(stream);
  const uint16_t* words = s + (size_t)(f.val_rows() + t % WORD_ROWS) * D;
  const int sh = t / WORD_ROWS;
  const unsigned below = (1u << lane) - 1u;
  const int keep = f.k0 + f.k1;
  int base = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // uint16 widens to a non-negative int, so the shift is logical
    const int bit = (words[lane + 32 * i] >> sh) & 1;
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    const int rank = min(base + __popc(set & below), keep - 1);
    base += __popc(set);
    float x = 0.f;
    if (bit) {
      int at;
      if (rank < f.k0)
        at = (t & ((1 << f.lr0) - 1)) * D + (t >> f.lr0) * f.k0 + rank;
      else
        at = ((1 << f.lr0) + (t & ((1 << f.lr1) - 1))) * D + (t >> f.lr1) * f.k1 +
             (rank - f.k0);
      x = bf16_bits(s[at]);
    }
    v[i] = x;
  }
}

// Starts the copy of `rows` stream rows (rows * 256 bytes, 16-byte aligned)
// from device memory to shared memory, 16 bytes a thread, as one cp.async
// group; cp_async_wait<N>() then waits until at most N groups are pending.
__device__ __forceinline__ void stage_rows_async(int16_t* dst, const int16_t* src,
                                                 int rows, int tid, int nthreads) {
  const int n = rows * (D * 2 / 16);
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  const char* from = reinterpret_cast<const char*>(src);
  for (int i = tid; i < n; i += nthreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(base + 16u * i), "l"(from + 16 * (size_t)i) : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace bitmap
