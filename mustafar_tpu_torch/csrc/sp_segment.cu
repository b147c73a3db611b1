// Bitmap segment attention for Hopper (sm_90a): the chunked-prefill
// partials of one segment of query rows over the packed bitmap pools.
//
// Replaces the TPU kernel mustafar_tpu/ops/kernels/sparse_attention.py
// fused_sparse_segment_attention (Pallas body _fused_seg_kernel) for the
// codecs bitmap (bf16 values, 16 bits) and bitmap-q8 (int8 codes with
// per-channel scales, 8 bits), with its sliding window.  For one
// layer `li` of the stacked cache and each (batch row b, kv head h) it
// attends the QR = T*G query rows of that kv head (segment token t, query
// head h*G + g; row t*G + g) over the first `n_chunks` packed pool chunks
// of 256 tokens: K and V expanded from the bitmap streams
// (bitmap_expand.cuh), one online softmax step per chunk in f32, p rounded
// to bf16 before the value product:
//   16 bits: scores = bf16(q) . K / sqrt(128),
//            acc = acc * corr + bf16(p) . V;
//    8 bits: scores = bf16(bf16(q) * kscale) . codes / sqrt(128),
//            acc = acc * corr + (bf16(p) . vcodes) * vscale,
// the chunk's scales read from the [L, mc, BH, 2, 128] bf16 tensor through
// its strides (the V scale multiplies each 64-token sub-tile's product, an
// f32 rounding away from the whole chunk's).  It writes the unnormalised
// partials acc [B,T,Hq,128] f32, m and l [B,T,Hq,1] f32 (no chunk: acc 0,
// m -1e30, l 0); the caller merges them with the window and causal-self
// partials.  The TPU fetches chunks `fdepth` at a time and masks the ones
// at or past n_chunks in the last fetch; those steps are exactly zero, so
// here they are skipped, and no pool chunk at or past n_chunks is read.
// The TPU kernel takes n_chunks and seg_start by scalar prefetch; here
// every CTA reads them from int32 device memory and clamps them (n_chunks
// into [0, mc], seg_start to 0 up), and the grid depends on T, G and
// B*Hkv alone, so one launch, captured in a CUDA graph, replays at every
// segment.  At n_chunks 0 it still launches and writes what no chunk gives.
//
// The sliding window (window > 0), the TPU's rule: query row t*G + g sits
// at position seg_start + t and sees the pool columns past seg_start + t -
// window.  The CTAs of a cluster share each chunk's expansion, so a
// cluster leaves out the chunks dead for its oldest row (and so for all
// its rows): none of its CTAs copies or expands them.  A warp whose rows'
// edges cut a chunk masks those scores per element, in both passes, to
// -1e30 (never -inf).  A row with no live column keeps m = -1e30 and
// finite l and acc, which the merge weighs 0 (q_segment.cu's note).  The
// mask costs the 8-bit instance its register budget: 255 registers and 52
// bytes spilled (177 without it; every form of the mask tried spilled).
// At q_segment.cu's windowed shape 0.314 ms against 0.598 without the
// window at 16 bits, 0.307 against 0.582 at 8 (NVIDIA H100 80GB HBM3,
// 700.00 W; chip_smoke.py kernel_sp_seg, _q8).
//
// What bounds it on this card: operations.  A segment of a layer does
// 4 * B*Hkv * QR * n_chunks * 256 * 128 multiply-adds' worth of operations
// (scores and values), about n_chunks x 1.07 GFLOP at B=1, Hkv=8, QR=1024:
// some 1.1 us a chunk at the card's bf16 tensor rate, against 0.03 us for
// the chunk's 48 KB (16 bits) or 28 KB (8 bits) of pool rows per head; the
// expansion adds a few integer operations per expanded element.  Every
// product is exact in bf16 x bf16 -> f32 (bf16 values or small integer
// codes, bf16(q * kscale), bf16(p)), so the tensor cores compute what the
// TPU's MXU does.
//
// Design: the TPU runs one program per (b, kv head) over all QR rows;
// here the rows are cut into tiles of 128, one CTA of 8 warps each (grid:
// row tiles x B*Hkv), and each warp owns 16 query rows through mma.sync
// m16n8k16, its bf16 q fragments held in registers (at 8 bits formed anew
// for each chunk from the CTA's q rows and K scale in shared memory).  To
// keep the register budget small (the quant segment kernel holds a whole
// chunk's scores and spills), the scores are taken in sub-tiles of 64
// tokens, twice: a first pass finds the chunk's row max, the second
// recomputes each sub-tile (the same mma, the same values), forms bf16(p)
// in registers as the A operand of the value product, and accumulates.
//
// The expansion is shared: a kv head's row tiles form a thread block
// cluster (Hopper's CTAs on neighbouring SMs that can write each other's
// shared memory; 8 CTAs at T = 256, G = 4, the portable most;
// segment_grid in ops/kernels/sparse_attention.py pads the tiles to a
// multiple of the cluster, and a padding tile expands its share but
// computes and writes nothing).  For each chunk every CTA copies the
// chunk's stream into shared memory (cp.async, 48 KB at 16 bits, 28 KB at
// 8: its peers' copies hit L2; the next chunk's copy runs while the CTA
// computes on this one), expands its 1/cluster share of the K rows and V
// rows with ballots and popcounts, one warp per token row, into bf16 tiles
// in its own shared memory (2 x 68 KB with padded rows: the
// dynamic-shared-memory opt-in above 48 KB, set once an instance), and
// copies each expanded row into every peer's tiles through distributed
// shared memory, 16 bytes a lane.  A cluster.sync() before the passes
// reads the tiles and another before the next chunk's expansion overwrites
// them; every CTA runs the same chunk loop and meets a final one, so no
// CTA leaves while a peer may write to it.  The passes take their B
// fragments from the tiles with ldmatrix (x4; .trans for V): the values
// and the mma order of element-wise loads, so the output is the unshared
// kernel's bit for bit.
//
// Measured for 31 chunks (B=1, T=256, G=4; NVIDIA H100 80GB HBM3, 700.00
// W; tools/kernel_ab.py, PERF.md §6): 0.574 ms at 16 bits and 0.638 at 8,
// where each of the 8 row tiles expanding the whole chunk itself took
// 1.257 / 1.378 (the expansion set the pace: some 40 us a chunk).  Now the
// passes do: without them 0.255, without the copies to the peers 0.490;
// element-wise fragment loads 0.606.  At B=1 the grid is 64 CTAs of
// ~184 KB (one an SM) in 8 clusters, which must each find 8 SMs of one
// GPC; the card holds 15 such clusters at once
// (cudaOccupancyMaxActiveClusters), so splitting the chunks over two
// cluster sets (16 clusters, two waves) took 0.578 before its merge and
// is not done.  A launch the card refuses returns its error.  TMA, wgmma
// and a persistent grid are later work.  One source, templated on the
// value width: an instance each, with its own shared-memory size.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include <cooperative_groups.h>

#include "bitmap_expand.cuh"
#include "mma_bf16.cuh"

namespace {

namespace cg = cooperative_groups;

using bitmap::CHUNK;
using bitmap::D;
using bitmap::Fmt;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCK_ROWS = 16 * WARPS;  // query rows per block, 16 per warp
constexpr int SUB = 64;                 // tokens per score sub-tile
constexpr int LD = D + 8;               // padded shared row: no bank conflicts
constexpr int MAX_CLUSTER = 8;          // the portable thread block cluster size
constexpr float NEG = -1e30f;
constexpr float SM_SCALE = 0.08838834764831845f;   // 1 / sqrt(128)

struct __align__(16) Tiles {
  __nv_bfloat16 k[CHUNK][LD];           // this chunk's expanded K
  __nv_bfloat16 v[CHUNK][LD];           // and V
};
// at 8 bits also the block's query rows (bf16) and the chunk's scales
struct __align__(16) ScaledTiles : Tiles {
  __nv_bfloat16 q[BLOCK_ROWS][LD];
  float ks[D];
  float vs[D];
};
template <int QBITS>
using Smem = std::conditional_t<QBITS == 8, ScaledTiles, Tiles>;
// (then one chunk's stream, KR + VR rows)

// This CTA's share of one stream's 256 rows (rows [rank, rank + 1) * 256 /
// csize of the cluster's csize CTAs), expanded by its warps, ROWS_IN_FLIGHT
// rows back to back, into the tile `dst` of every CTA of the cluster: each
// warp writes its rows into its own tile, then copies them, 16 bytes a
// lane, into each peer's tile through distributed shared memory.
template <int QBITS>
__device__ __forceinline__ void expand_share(const int16_t* __restrict__ stream,
                                             const Fmt<QBITS> f, __nv_bfloat16 (*dst)[LD],
                                             cg::cluster_group& cluster, int csize,
                                             int rank, int warp, int lane) {
  constexpr int NR = bitmap::ROWS_IN_FLIGHT;
  static_assert(NR % 2 == 0, "a 16-byte copy takes two rows a warp");
  const int share = CHUNK / csize;          // a multiple of NR * WARPS = 32
  const int first = rank * share;
  for (int t0 = first + warp; t0 < first + share; t0 += NR * WARPS) {
    float x[NR][4];
#pragma unroll
    for (int j = 0; j < NR; ++j) bitmap::expand_row(stream, f, t0 + j * WARPS, lane, x[j]);
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[t0 + j * WARPS][lane + 32 * i] = __float2bfloat16(x[j][i]);
    if (csize == 1) continue;
    __syncwarp();
    // lanes 0-15 copy one of the rows, lanes 16-31 the next; each peer in
    // turn from this CTA's rank on, so the CTAs write to different peers
#pragma unroll
    for (int p = 0; p < NR / 2; ++p) {
      const int t = t0 + (2 * p + (lane >> 4)) * WARPS;
      __nv_bfloat16* row = &dst[t][(lane & 15) * 8];
      const uint4 v = *reinterpret_cast<const uint4*>(row);
      for (int r = 1; r < csize; ++r) {
        const int peer = rank + r < csize ? rank + r : rank + r - csize;
        *reinterpret_cast<uint4*>(cluster.map_shared_rank(row, peer)) = v;
      }
    }
  }
}

// Scores of the warp's 16 rows against tokens tok0 .. tok0 + 63, scaled.
// Fragment layouts of mma.m16n8k16 (lane = 4 * gid + tig): A holds rows gid
// and gid + 8, columns 2 tig (+1) and 2 tig + 8 (+1); B column gid, rows
// 2 tig (+1) and 2 tig + 8 (+1); the f32 accumulator rows gid (c0, c1) and
// gid + 8 (c2, c3), columns 2 tig and 2 tig + 1.  The B fragments of two
// 8-token tiles (K rows tok .. tok + 15, channels 16 kk .. 16 kk + 15) come
// from one ldmatrix.x4: b[0], b[1] tile nt's, b[2], b[3] tile nt + 1's.
__device__ __forceinline__ void sub_scores(const Tiles& sm, const uint32_t (&qa)[8][4],
                                           int lane, int tok0, float (&s)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4<false>(b, &sm.k[tok0 + 8 * nt + 8 * (lane >> 4) + (lane & 7)]
                                 [16 * kk + 8 * ((lane >> 3) & 1)]);
      mma_bf16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b[0], b[1]);
      mma_bf16(s[nt + 1], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] *= SM_SCALE;
}

// bf16(q * kscale) of two neighbouring channels, packed
__device__ __forceinline__ uint32_t scaled_pair(const __nv_bfloat16* q, const float* ks) {
  return pack_bf16(__bfloat162float(q[0]) * ks[0], __bfloat162float(q[1]) * ks[1]);
}

template <int QBITS>
__global__ void __launch_bounds__(THREADS)
sp_segment_kernel(const __nv_bfloat16* __restrict__ q,   // [B, T, Hq, D]
                  const int16_t* __restrict__ pool,      // [L, mc, BH, KR+VR, D]
                  const __nv_bfloat16* __restrict__ scales,  // [L, mc, BH, 2, D] (8 bits)
                  float* __restrict__ acc_out,           // [B, T, Hq, D]
                  float* __restrict__ m_out,             // [B, T, Hq]
                  float* __restrict__ l_out,             // [B, T, Hq]
                  const int* __restrict__ n_chunks_at,  // [1] int32
                  const int* __restrict__ seg_start_at, // [1] int32
                  int BH, int hkv, int G, int T, int max_chunks, int li, int window,
                  Fmt<QBITS> kf, Fmt<QBITS> vf) {
  // the counts, read on the device as the TPU kernel reads its scalar
  // prefetch, and clamped: every CTA of a cluster reads the same values, so
  // all run the same chunk loop and meet at every cluster.sync()
  const int n_chunks = min(max(*n_chunks_at, 0), max_chunks);
  const int seg_start = max(*seg_start_at, 0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<QBITS>& sm = *reinterpret_cast<Smem<QBITS>*>(smem_raw);
  int16_t* stage = reinterpret_cast<int16_t*>(smem_raw + sizeof(Smem<QBITS>));
  // the cluster: this kv head's row tiles (blockIdx.x), csize of them
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.y;
  const int b = bh / hkv;
  const int h = bh - b * hkv;
  const int Hq = hkv * G;
  const int QR = T * G;
  const int row0 = blockIdx.x * BLOCK_ROWS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wr = warp * 16;          // this warp's first row in the block
  // a warp whose 16 rows all lie past QR (a padding tile's, or the last
  // tile's tail) expands and syncs with the others but computes nothing
  const bool computes = row0 + wr < QR;

  // (b, t, h*G + g) offset of query row r = t*G + g of this kv head
  auto row_off = [&](int r) -> size_t {
    const int t = r / G;
    return (size_t)(b * T + t) * Hq + h * G + (r - t * G);
  };

  // the warp's A fragments of q (rows gid and gid + 8, channels 2 tig (+1)
  // and 2 tig + 8 (+1) of each 16-channel step); rows past QR are 0.  At 8
  // bits the block's rows go to shared memory, and the fragments are
  // bf16(q * kscale), formed for each chunk (scale_q)
  uint32_t qa[8][4];
  if constexpr (QBITS == 8) {
    for (int i = tid; i < BLOCK_ROWS * (D / 8); i += THREADS) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < QR) v = *reinterpret_cast<const uint4*>(q + row_off(row0 + r) * D + c);
      *reinterpret_cast<uint4*>(&sm.q[r][c]) = v;
    }
  } else {
    const int r0 = row0 + wr + gid;
    const int r1 = r0 + 8;
    const __nv_bfloat16* q0 = r0 < QR ? q + row_off(r0) * D : nullptr;
    const __nv_bfloat16* q1 = r1 < QR ? q + row_off(r1) * D : nullptr;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int k0 = 16 * kk + 2 * tig;
      qa[kk][0] = q0 ? ld32(q0 + k0) : 0u;
      qa[kk][1] = q1 ? ld32(q1 + k0) : 0u;
      qa[kk][2] = q0 ? ld32(q0 + k0 + 8) : 0u;
      qa[kk][3] = q1 ? ld32(q1 + k0 + 8) : 0u;
    }
  }

  // the sliding window: the chunks before c_first are dead for the
  // cluster's oldest row (its first tile's first); a chunk at or below
  // lo_w (the warp's newest row's edge) holds a dead column for some of
  // the warp's rows, masked by the edges lo_a, lo_b of rows gid, gid + 8
  int c_first = 0, lo_w = -1, lo_a = -1, lo_b = -1;
  if (window > 0) {
    const int crow0 = (int)(blockIdx.x - rank) * BLOCK_ROWS;
    c_first = min(max(seg_start + crow0 / G - window + 1, 0) / CHUNK, n_chunks);
    lo_w = seg_start + (row0 + wr + 15) / G - window;
    lo_a = seg_start + (row0 + wr + gid) / G - window;
    lo_b = seg_start + (row0 + wr + gid + 8) / G - window;
  }
  // scores s (sub_scores' layout) of tokens tok0 .. tok0 + 63 of chunk ci
  // at or below their row's edge set to -1e30
  auto mask_edge = [&](float (&s)[8][4], int ci, int tok0) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = ci * CHUNK + tok0 + 8 * nt + 2 * tig + (e & 1);
        if (col <= (e >= 2 ? lo_b : lo_a)) s[nt][e] = NEG;
      }
  };

  float o[16][4];                    // acc, d = 8 nt + 2 tig (+1)
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;   // rows gid, gid + 8

  const int rows = kf.rows() + vf.rows();
  auto chunk = [&](int ci) {
    return pool + (((size_t)li * max_chunks + ci) * BH + bh) * rows * D;
  };
  if (c_first < n_chunks) bitmap::stage_rows_async(stage, chunk(c_first), rows, tid, THREADS);
  for (int ci = c_first; ci < n_chunks; ++ci) {
    bitmap::cp_async_wait<0>();
    // chunk ci staged in every CTA; every CTA's tiles free (the last
    // chunk's passes done), and at the first every CTA of the cluster running
    cluster.sync();
    expand_share(stage, kf, sm.k, cluster, csize, rank, warp, lane);
    expand_share(stage + (size_t)kf.rows() * D, vf, sm.v, cluster, csize, rank, warp, lane);
    if constexpr (QBITS == 8) {
      const __nv_bfloat16* sc = scales + (((size_t)li * max_chunks + ci) * BH + bh) * 2 * D;
      for (int i = tid; i < 2 * D; i += THREADS) {
        const float x = __bfloat162float(sc[i]);
        if (i < D)
          sm.ks[i] = x;
        else
          sm.vs[i - D] = x;
      }
    }
    cluster.sync();                  // tiles (and scales) whole in every CTA; the stage free
    if (ci + 1 < n_chunks)
      bitmap::stage_rows_async(stage, chunk(ci + 1), rows, tid, THREADS);
    if (!computes) continue;
    const bool edge = ci * CHUNK <= lo_w;
    if constexpr (QBITS == 8) {      // scale_q: this chunk's bf16(q * kscale)
      const __nv_bfloat16* q0 = &sm.q[wr + gid][0];
      const __nv_bfloat16* q1 = &sm.q[wr + gid + 8][0];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int k0 = 16 * kk + 2 * tig;
        qa[kk][0] = scaled_pair(q0 + k0, sm.ks + k0);
        qa[kk][1] = scaled_pair(q1 + k0, sm.ks + k0);
        qa[kk][2] = scaled_pair(q0 + k0 + 8, sm.ks + k0 + 8);
        qa[kk][3] = scaled_pair(q1 + k0 + 8, sm.ks + k0 + 8);
      }
    }

    // ---- pass 1: the chunk's row max ----------------------------------------
    float mx0 = NEG, mx1 = NEG;
#pragma unroll 1
    for (int tok0 = 0; tok0 < CHUNK; tok0 += SUB) {
      float s[8][4];
      sub_scores(sm, qa, lane, tok0, s);
      if (edge) mask_edge(s, ci, tok0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = expf(m0 - mn0);
    const float c1 = expf(m1 - mn1);
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      o[nt][0] *= c0;
      o[nt][1] *= c0;
      o[nt][2] *= c1;
      o[nt][3] *= c1;
    }

    // ---- pass 2: bf16(p) . V, sub-tile by sub-tile ---------------------------
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll 1
    for (int tok0 = 0; tok0 < CHUNK; tok0 += SUB) {
      float s[8][4];
      sub_scores(sm, qa, lane, tok0, s);
      if (edge) mask_edge(s, ci, tok0);
      uint32_t p[8][2];              // bf16(p) pairs: row gid, row gid + 8
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float e0 = expf(s[nt][0] - mn0);
        const float e1 = expf(s[nt][1] - mn0);
        const float e2 = expf(s[nt][2] - mn1);
        const float e3 = expf(s[nt][3] - mn1);
        sum0 += e0 + e1;
        sum1 += e2 + e3;
        p[nt][0] = pack_bf16(e0, e1);
        p[nt][1] = pack_bf16(e2, e3);
      }
      // the score fragments of tokens 16 j .. 16 j + 15, packed to bf16
      // pairs, are the A fragment of the value product's k-step j; its B
      // fragments (V rows tok0 + 16 j + 2 tig (+1, +8, +9), channel 8 nt +
      // gid) come transposed from ldmatrix.x4.trans, two of them at once
      if constexpr (QBITS == 16) {
#pragma unroll
        for (int j = 0; j < SUB / 16; ++j)
#pragma unroll
          for (int nt = 0; nt < 16; nt += 2) {
            uint32_t b[4];   // tiles nt and nt + 1
            ldmatrix_x4<true>(b, &sm.v[tok0 + 16 * j + (lane & 15)][8 * (nt + (lane >> 4))]);
            mma_bf16(o[nt], p[2 * j][0], p[2 * j][1], p[2 * j + 1][0], p[2 * j + 1][1],
                     b[0], b[1]);
            mma_bf16(o[nt + 1], p[2 * j][0], p[2 * j][1], p[2 * j + 1][0],
                     p[2 * j + 1][1], b[2], b[3]);
          }
      } else {
        // each 8-channel tile's product over the sub-tile is multiplied by
        // its channels' V scales before it joins the accumulator
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < SUB / 16; j += 2) {
            uint32_t b[4];   // k-steps j and j + 1
            ldmatrix_x4<true>(b, &sm.v[tok0 + 16 * j + lane][8 * nt]);
            mma_bf16(pv, p[2 * j][0], p[2 * j][1], p[2 * j + 1][0], p[2 * j + 1][1], b[0],
                     b[1]);
            mma_bf16(pv, p[2 * j + 2][0], p[2 * j + 2][1], p[2 * j + 3][0],
                     p[2 * j + 3][1], b[2], b[3]);
          }
          const float vs0 = sm.vs[8 * nt + 2 * tig];
          const float vs1 = sm.vs[8 * nt + 2 * tig + 1];
          o[nt][0] += pv[0] * vs0;
          o[nt][1] += pv[1] * vs1;
          o[nt][2] += pv[2] * vs0;
          o[nt][3] += pv[3] * vs1;
        }
      }
    }
    l0 = l0 * c0 + quad_sum(sum0);
    l1 = l1 * c1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
  }
  cluster.sync();                    // no CTA leaves while a peer may write to it

  // ---- unnormalised partials out --------------------------------------------
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + wr + gid + 8 * half;
    if (r < QR) {
      const size_t off = row_off(r);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
        *reinterpret_cast<float2*>(acc_out + off * D + 8 * nt + 2 * tig) =
            make_float2(o[nt][2 * half], o[nt][2 * half + 1]);
      if (tig == 0) {
        m_out[off] = half ? m1 : m0;
        l_out[off] = half ? l1 : l0;
      }
    }
  }
}

template <int QBITS>
cudaError_t launch(const void* q, const void* pool, const void* scales, void* acc, void* m,
                   void* l, const void* n_chunks, const void* seg_start, int BH, int hkv,
                   int G, int T, int max_chunks, int li, int window, int k0, int k1,
                   int vk0, int vk1, int cluster, int tiles, int device,
                   cudaStream_t stream) {
  bool k_ok, v_ok;
  const Fmt<QBITS> kf = bitmap::make_fmt<QBITS>(k0, k1, &k_ok);
  const Fmt<QBITS> vf = bitmap::make_fmt<QBITS>(vk0, vk1, &v_ok);
  if (!k_ok || !v_ok || (QBITS == 8) != (scales != nullptr)) return cudaErrorInvalidValue;
  const int smem = (int)(sizeof(Smem<QBITS>) + (size_t)(kf.rows() + vf.rows()) * D * 2);
  cudaError_t err = smem::allow_dynamic_smem<sp_segment_kernel<QBITS>>(smem, device);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, BH);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sp_segment_kernel<QBITS>,
                           static_cast<const __nv_bfloat16*>(q),
                           static_cast<const int16_t*>(pool),
                           static_cast<const __nv_bfloat16*>(scales),
                           static_cast<float*>(acc), static_cast<float*>(m),
                           static_cast<float*>(l), static_cast<const int*>(n_chunks),
                           static_cast<const int*>(seg_start), BH, hkv, G, T, max_chunks, li,
                           window, kf, vf);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of `cluster` CTAs of the instance at `qbits` can be
// resident on the card at once (cudaOccupancyMaxActiveClusters), for the
// formats' shared-memory size.
template <int QBITS>
cudaError_t max_clusters(int k0, int k1, int vk0, int vk1, int cluster, int device,
                         int* out) {
  bool k_ok, v_ok;
  const Fmt<QBITS> kf = bitmap::make_fmt<QBITS>(k0, k1, &k_ok);
  const Fmt<QBITS> vf = bitmap::make_fmt<QBITS>(vk0, vk1, &v_ok);
  if (!k_ok || !v_ok) return cudaErrorInvalidValue;
  const int smem = (int)(sizeof(Smem<QBITS>) + (size_t)(kf.rows() + vf.rows()) * D * 2);
  cudaError_t err = smem::allow_dynamic_smem<sp_segment_kernel<QBITS>>(smem, device);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, sp_segment_kernel<QBITS>, &cfg);
}

}  // namespace

// q [B, T, Hkv*G, 128] bf16; pool [L, mc, B*Hkv, KR+VR, 128] int16; scales
// [L, mc, B*Hkv, 2, 128] bf16 at `qbits` 8, null at 16; acc
// [B, T, Hkv*G, 128] f32; m, l [B, T, Hkv*G, 1] f32.  All contiguous and
// 16-byte aligned; shapes checked by the caller.  `device` is the ordinal
// the tensors and the stream belong to; BH = B * hkv; (k0, k1) and
// (vk0, vk1) the K and V streams' segment widths (k1 = 0: one segment);
// `tiles` row tiles of 128 query rows a kv head in clusters of `cluster`
// (1, 2, 4 or 8; `tiles` a multiple of it), covering the T*G rows with no
// cluster wholly past them.  `n_chunks` and `seg_start` are int32 scalars
// in device memory (the segment's packed chunks and first position), which
// the kernel reads and clamps, so one launch (and a CUDA graph that holds
// it) serves every segment; `window` the sliding window, 0 for none.  A
// cluster launch the card refuses returns its error.
extern "C" int sp_segment(const void* q, const void* pool, const void* scales, void* acc,
                          void* m, void* l, const void* n_chunks, const void* seg_start,
                          int device, int qbits, int BH, int hkv, int G, int T,
                          int max_chunks, int li, int window, int k0, int k1, int vk0,
                          int vk1, int cluster, int tiles, void* stream) {
  if (hkv < 1 || BH % hkv || G < 1 || T < 1 || max_chunks < 1 || n_chunks == nullptr ||
      seg_start == nullptr || li < 0 || window < 0 || cluster < 1 ||
      cluster > MAX_CLUSTER ||
      (cluster & (cluster - 1)) || tiles < cluster || tiles % cluster ||
      (long long)tiles * BLOCK_ROWS < (long long)T * G ||
      (long long)(tiles - cluster) * BLOCK_ROWS >= (long long)T * G)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qbits == 16)
    err = launch<16>(q, pool, scales, acc, m, l, n_chunks, seg_start, BH, hkv, G, T,
                     max_chunks, li, window, k0, k1, vk0, vk1, cluster, tiles, device, s);
  else if (qbits == 8)
    err = launch<8>(q, pool, scales, acc, m, l, n_chunks, seg_start, BH, hkv, G, T,
                    max_chunks, li, window, k0, k1, vk0, vk1, cluster, tiles, device, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// Writes to *out the clusters of `cluster` CTAs of the instance at `qbits`
// for formats (k0, k1), (vk0, vk1) that the card holds at once; returns the
// CUDA error.
extern "C" int sp_segment_max_clusters(void* out, int device, int qbits, int k0, int k1,
                                       int vk0, int vk1, int cluster) {
  if (out == nullptr || cluster < 1 || cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int* n = static_cast<int*>(out);
  if (qbits == 16) return (int)max_clusters<16>(k0, k1, vk0, vk1, cluster, device, n);
  if (qbits == 8) return (int)max_clusters<8>(k0, k1, vk0, vk1, cluster, device, n);
  return (int)cudaErrorInvalidValue;
}
