// A chunk step's share of a bitmap chunk, shared by the uniform decode
// kernels over bitmap chunks (sp_decode.cu's entry sp_decode over the fused
// stream; sp_archive_fused.cu over the archive's split pools): one CTA
// takes one run of STEP = 64 tokens of a chunk (CUT = 4 runs a chunk),
// copies into shared memory only what those tokens need and expands them
// into bf16 K and V tiles of decode_tile.cuh's layout (rows of LD).
//
// What a run of tokens [t0, t0 + 64) needs of one stream (K or V):
//   - the bitmap's word planes, all of them (token t is bit t / 16 of
//     uint16 plane t % 16 in a fused stream, bit t / 8 of uint32 plane t %
//     8 in a split pool: 4 KB either way, 64 tokens touching every plane);
//   - of each value segment of width k (2^lr logical rows), the run of
//     lanes that holds these tokens' values in every row: token t's values
//     lie at lanes (t >> lr) * k .. + k, so the run is 32 lanes, or k at a
//     segment of width k > 32 (share_lanes).
// 18 KB of a 48 KB chunk at sparsity 0.7 and 16 bits.  The two layouts
// differ only in where the pieces lie (Sources) and in the word width
// (WORD_BITS, 16 or 32); the segments' rows are the same.
//
// One warp expands one token row (ballots over the word planes, ranks by
// popcount; bitmap_expand.cuh has the format), 8 K and 8 V rows a warp.

#pragma once

#include <algorithm>

#include "bitmap_expand.cuh"
#include "decode_tile.cuh"

namespace chunk_share {

using bitmap::CHUNK;
using bitmap::Fmt;
using bitmap::WORD_ROWS;
using uniform_decode::D;
using uniform_decode::LD;
using uniform_decode::THREADS;
using uniform_decode::WARPS;

// Three CTAs an SM (at most 85 registers a thread); G = 8, two.
constexpr int min_blocks(int G) { return G <= 4 ? 3 : 2; }

constexpr int CUT = 4;                // steps a chunk
constexpr int STEP = CHUNK / CUT;     // tokens a chunk step
static_assert(STEP % 16 == 0 && STEP <= uniform_decode::MAX_STEP,
              "whole k-steps of the value product");

// The lanes [lo, lo + w) of every row of a value segment of width k (2^lr
// logical rows) that tokens [t0, t0 + STEP) take, in whole 16-byte
// pieces: token t's values lie at lanes (t >> lr) * k .. + k.
__host__ __device__ inline void share_lanes(int k, int lr, int t0, int& lo, int& w) {
  const int a = ((t0 >> lr) * k) & ~7;
  const int b = (((((t0 + STEP - 1) >> lr) + 1) * k + 7) & ~7);
  lo = a;
  w = (b < D ? b : D) - a;
}

// Where one stream's pieces of one chunk lie in device memory: its word
// planes (4 KB) and its value segments' rows [p0 | p1][128] (seg1 unread
// without a second segment).
struct Sources {
  const int16_t* words;
  const int16_t* seg0;
  const int16_t* seg1;
};

// A fused stream's pieces: segment 0's rows, segment 1's, then the words.
template <int QBITS>
__device__ __forceinline__ Sources stream_sources(const int16_t* stream, const Fmt<QBITS>& f) {
  return Sources{stream + (size_t)f.val_rows() * D, stream, stream + (size_t)f.p0() * D};
}

// One stream's staged share: its word planes (4 KB), then each value
// segment's rows [p][w], lanes [lo, lo + w) of the stream's (fields, not
// arrays, so that the expansion indexes no local memory).
struct Share {
  const uint16_t* words;
  const uint16_t *seg0, *seg1;
  int lo0, w0, lo1, w1;
};

// 16-bit elements of a stream's share at the widest lane runs over the
// chunk's steps (the shared-memory size the host reserves).
template <int QBITS>
int share_elems(const Fmt<QBITS>& f) {
  int n = WORD_ROWS * D;
  const int p[2] = {f.p0(), f.p1()}, k[2] = {f.k0, f.k1}, lr[2] = {f.lr0, f.lr1};
  for (int j = 0; j < 2; ++j) {
    if (!k[j]) continue;
    int widest = 0;
    for (int c = 0; c < CUT; ++c) {
      int lo, w;
      share_lanes(k[j], lr[j], c * STEP, lo, w);
      widest = std::max(widest, w);
    }
    n += p[j] * widest;
  }
  return n;
}

// Issues the cp.async copies of the share of tokens [t0, t0 + STEP) of the
// stream whose pieces lie at `src` into `dst`; returns the share and moves
// dst past it.
template <int QBITS>
__device__ Share stage_share(uint16_t*& dst, const Sources& src, const Fmt<QBITS>& f, int t0,
                             int tid) {
  auto copy = [&](const int16_t* from, int rows, int lo, int w) {
    const int per_row = w / 8;
    for (int i = tid; i < rows * per_row; i += THREADS)
      smem::cp_async16(smem::smem_addr(dst + (i / per_row) * w + 8 * (i % per_row)),
                       from + (size_t)(i / per_row) * D + lo + 8 * (i % per_row));
    const uint16_t* at = dst;
    dst += rows * w;
    return at;
  };
  Share sh{};
  sh.words = copy(src.words, WORD_ROWS, 0, D);
  share_lanes(f.k0, f.lr0, t0, sh.lo0, sh.w0);
  sh.seg0 = copy(src.seg0, f.p0(), sh.lo0, sh.w0);
  sh.seg1 = dst;
  if (f.k1) {
    share_lanes(f.k1, f.lr1, t0, sh.lo1, sh.w1);
    sh.seg1 = copy(src.seg1, f.p1(), sh.lo1, sh.w1);
  }
  return sh;
}

// Where token row t's stored values lie in a share: its run of k0 values
// in segment 0 and of k1 in segment 1, each indexed by rank (run1 offset by
// -k0), and at 8 bits the byte of the 16-bit lane that holds each (the
// logical row's half of its stream row).
struct Runs {
  const uint16_t *run0, *run1;
  int byte0, byte1;
};

template <int QBITS>
__device__ __forceinline__ Runs token_runs(const Share& sh, const Fmt<QBITS>& f, int t) {
  auto run = [&](const uint16_t* seg, int k, int lr, int lo, int w, int skip, int& byte) {
    const int row = t & ((1 << lr) - 1);
    int srow = row;
    byte = 0;
    if constexpr (QBITS == 8) {   // logical row `row` in stream row row % (r/2): low, then high
      srow = row & ((1 << (lr - 1)) - 1);
      byte = (row >> (lr - 1)) ? 8 : 0;
    }
    return seg + srow * w + (t >> lr) * k - lo - skip;
  };
  Runs r;
  r.run0 = run(sh.seg0, f.k0, f.lr0, sh.lo0, sh.w0, 0, r.byte0);
  r.run1 = f.k1 ? run(sh.seg1, f.k1, f.lr1, sh.lo1, sh.w1, f.k0, r.byte1) : r.run0;
  if (!f.k1) r.byte1 = r.byte0;
  return r;
}

// Token row t expanded by the calling warp into the bf16 bits of lane's
// channels lane + 32 i (0 where the bit is unset), as bitmap::expand_row
// does from a whole staged stream: a bf16 value's bits, or an int8 code's
// as a bf16 number.  WORD_BITS: 16 (a fused stream's uint16 planes) or 32
// (a split pool's uint32 planes, bf16 values).
template <int QBITS, int WORD_BITS>
__device__ __forceinline__ void expand_share_row(const Share& sh, const Fmt<QBITS>& f, int t,
                                                 int lane, uint16_t (&v)[4]) {
  static_assert(WORD_BITS == 16 || (WORD_BITS == 32 && QBITS == 16),
                "uint16 word planes, or the split pools' uint32 planes (bf16 values)");
  constexpr int PLANES = CHUNK / WORD_BITS;
  const uint16_t* words = sh.words + (t % PLANES) * D;
  const uint32_t* words32 = reinterpret_cast<const uint32_t*>(sh.words) + (t % PLANES) * D;
  const int shift = t / PLANES;
  const Runs runs = token_runs<QBITS>(sh, f, t);
  const unsigned below = (1u << lane) - 1u;
  const int keep = f.k0 + f.k1;
  int base = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int bit;
    if constexpr (WORD_BITS == 16)
      bit = (words[lane + 32 * i] >> shift) & 1;
    else
      bit = (int)((words32[lane + 32 * i] >> shift) & 1u);
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    const int rank = min(base + __popc(set & below), keep - 1);
    base += __popc(set);
    uint16_t x = 0;
    if (bit) {
      const bool first = rank < f.k0;
      x = (first ? runs.run0 : runs.run1)[rank];
      if constexpr (QBITS == 8) {
        const int byte = (x >> (first ? runs.byte0 : runs.byte1)) & 0xff;
        x = (uint16_t)(__float_as_uint(uniform_decode::small_int_f32((byte ^ 0x80) - 0x80)) >>
                       16);
      }
    }
    v[i] = x;
  }
}

// Tokens [t0, t0 + STEP) of a stream's share expanded into the bf16 tile
// `tile` (rows of LD): warp w takes local rows w + 8 j, ROWS_IN_FLIGHT at
// a time.
template <int QBITS, int WORD_BITS>
__device__ __forceinline__ void expand_share(__nv_bfloat16* tile, const Share& sh,
                                             const Fmt<QBITS>& f, int t0, int warp,
                                             int lane) {
  constexpr int NR = bitmap::ROWS_IN_FLIGHT;
  uint16_t* tile16 = reinterpret_cast<uint16_t*>(tile);
  for (int r0 = warp; r0 < STEP; r0 += NR * WARPS) {
    uint16_t v[NR][4];
#pragma unroll
    for (int j = 0; j < NR; ++j)
      expand_share_row<QBITS, WORD_BITS>(sh, f, t0 + r0 + j * WARPS, lane, v[j]);
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) tile16[(r0 + j * WARPS) * LD + lane + 32 * i] = v[j][i];
  }
}
static_assert(STEP % (bitmap::ROWS_IN_FLIGHT * WARPS) == 0, "whole runs of rows a warp");

// Bytes of a chunk CTA's shared region: the K and V tiles of STEP rows,
// then both streams' shares.
template <int QBITS>
int chunk_region_bytes(const Fmt<QBITS>& kf, const Fmt<QBITS>& vf) {
  return 2 * STEP * LD * 2 + 2 * (share_elems(kf) + share_elems(vf));
}

}  // namespace chunk_share
