// Bitmap segment attention for Hopper (sm_90a): the chunked-prefill
// partials of one segment of query rows over the packed bitmap pools.
//
// Replaces the TPU kernel mustafar_tpu/ops/kernels/sparse_attention.py
// fused_sparse_segment_attention (Pallas body _fused_seg_kernel) for the
// codecs bitmap (bf16 values, 16 bits) and bitmap-q8 (int8 codes with
// per-channel scales, 8 bits), without its sliding-window option.  For one
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
// Design (first, simple version): the TPU runs one program per (b, kv
// head) over all QR rows; here the rows are cut into tiles of 128 (grid: row
// tiles x B*Hkv, 64 blocks at B=1, Hkv=8, T=256, G=4).  A block of 8 warps
// copies each chunk's stream into shared memory (cp.async; the next chunk's
// copy runs while the block computes on this one), expands its K and V
// from there into bf16 tiles in shared memory (2 x 68 KB with padded rows,
// plus up to 76 KB of stream: the dynamic-shared-memory opt-in above
// 48 KB), one warp per token row with ballots and popcounts, and each warp
// owns 16 query rows through mma.sync m16n8k16, its bf16 q fragments held
// in registers (at 8 bits formed anew for each chunk from the block's q
// rows and K scale in shared memory).  To keep the register budget small
// (the quant segment kernel holds a whole chunk's scores and spills), the
// scores are taken in sub-tiles of 64 tokens, twice: a first pass finds
// the chunk's row max, the second recomputes each sub-tile (the same mma,
// the same values), forms bf16(p) in registers as the A operand of the
// value product, and accumulates.  Every row tile expands the chunk anew;
// TMA, wgmma, a shared expansion across row tiles and a persistent grid
// are later work.  One source, templated on the value width: an instance
// each, with its own shared-memory size.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bitmap_expand.cuh"
#include "mma_bf16.cuh"

namespace {

using bitmap::CHUNK;
using bitmap::D;
using bitmap::Fmt;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCK_ROWS = 16 * WARPS;  // query rows per block, 16 per warp
constexpr int SUB = 64;                 // tokens per score sub-tile
constexpr int LD = D + 8;               // padded shared row: no bank conflicts
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

// One stream's 256 rows expanded into a shared tile by the block's warps,
// ROWS_IN_FLIGHT rows back to back.
template <int QBITS>
__device__ __forceinline__ void expand_chunk(const int16_t* __restrict__ stream,
                                             const Fmt<QBITS> f, __nv_bfloat16 (*dst)[LD],
                                             int warp, int lane) {
  constexpr int NR = bitmap::ROWS_IN_FLIGHT;
  for (int t0 = warp; t0 < CHUNK; t0 += NR * WARPS) {
    float x[NR][4];
#pragma unroll
    for (int j = 0; j < NR; ++j) bitmap::expand_row(stream, f, t0 + j * WARPS, lane, x[j]);
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[t0 + j * WARPS][lane + 32 * i] = __float2bfloat16(x[j][i]);
  }
}

// Scores of the warp's 16 rows against tokens tok0 .. tok0 + 63, scaled.
// Fragment layouts of mma.m16n8k16 (lane = 4 * gid + tig): A holds rows gid
// and gid + 8, columns 2 tig (+1) and 2 tig + 8 (+1); B column gid, rows
// 2 tig (+1) and 2 tig + 8 (+1); the f32 accumulator rows gid (c0, c1) and
// gid + 8 (c2, c3), columns 2 tig and 2 tig + 1.
__device__ __forceinline__ void sub_scores(const Tiles& sm, const uint32_t (&qa)[8][4],
                                           int gid, int tig, int tok0, float (&s)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int k0 = 16 * kk + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* kr = &sm.k[tok0 + 8 * nt + gid][0];
      mma_bf16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], ld32(kr + k0),
               ld32(kr + k0 + 8));
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] *= SM_SCALE;
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
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
                  int BH, int hkv, int G, int T, int max_chunks, int n_chunks,
                  int li, Fmt<QBITS> kf, Fmt<QBITS> vf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<QBITS>& sm = *reinterpret_cast<Smem<QBITS>*>(smem_raw);
  int16_t* stage = reinterpret_cast<int16_t*>(smem_raw + sizeof(Smem<QBITS>));
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

  float o[16][4];                    // acc, d = 8 nt + 2 tig (+1)
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;   // rows gid, gid + 8

  const int rows = kf.rows() + vf.rows();
  auto chunk = [&](int ci) {
    return pool + (((size_t)li * max_chunks + ci) * BH + bh) * rows * D;
  };
  if (n_chunks > 0) bitmap::stage_rows_async(stage, chunk(0), rows, tid, THREADS);
  for (int ci = 0; ci < n_chunks; ++ci) {
    bitmap::cp_async_wait<0>();
    __syncthreads();                 // chunk ci staged; the last chunk's readers are done
    expand_chunk(stage, kf, sm.k, warp, lane);
    expand_chunk(stage + (size_t)kf.rows() * D, vf, sm.v, warp, lane);
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
    __syncthreads();                 // tiles (and scales) ready, the stage buffer free
    if (ci + 1 < n_chunks)
      bitmap::stage_rows_async(stage, chunk(ci + 1), rows, tid, THREADS);
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
      sub_scores(sm, qa, gid, tig, tok0, s);
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
      sub_scores(sm, qa, gid, tig, tok0, s);
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
      // pairs, are the A fragment of the value product's k-step j (b: the
      // B fragment of k-step j for channel tile nt)
      auto b_frag = [&](int j, int nt, uint32_t& b0, uint32_t& b1) {
        const int tk = tok0 + 16 * j + 2 * tig;
        const int d = 8 * nt + gid;
        b0 = pack_raw(sm.v[tk][d], sm.v[tk + 1][d]);
        b1 = pack_raw(sm.v[tk + 8][d], sm.v[tk + 9][d]);
      };
      if constexpr (QBITS == 16) {
#pragma unroll
        for (int j = 0; j < SUB / 16; ++j)
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            uint32_t b0, b1;
            b_frag(j, nt, b0, b1);
            mma_bf16(o[nt], p[2 * j][0], p[2 * j][1], p[2 * j + 1][0], p[2 * j + 1][1],
                     b0, b1);
          }
      } else {
        // each 8-channel tile's product over the sub-tile is multiplied by
        // its channels' V scales before it joins the accumulator
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < SUB / 16; ++j) {
            uint32_t b0, b1;
            b_frag(j, nt, b0, b1);
            mma_bf16(pv, p[2 * j][0], p[2 * j][1], p[2 * j + 1][0], p[2 * j + 1][1], b0,
                     b1);
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
int launch(const void* q, const void* pool, const void* scales, void* acc, void* m,
           void* l, int BH, int hkv, int G, int T, int max_chunks, int n_chunks, int li,
           int k0, int k1, int vk0, int vk1, cudaStream_t stream) {
  bool k_ok, v_ok;
  const Fmt<QBITS> kf = bitmap::make_fmt<QBITS>(k0, k1, &k_ok);
  const Fmt<QBITS> vf = bitmap::make_fmt<QBITS>(vk0, vk1, &v_ok);
  if (!k_ok || !v_ok || (QBITS == 8) != (scales != nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(Smem<QBITS>) + (size_t)(kf.rows() + vf.rows()) * D * 2);
  const cudaError_t err = cudaFuncSetAttribute(
      sp_segment_kernel<QBITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T * G + BLOCK_ROWS - 1) / BLOCK_ROWS, BH);
  sp_segment_kernel<QBITS><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int16_t*>(pool),
      static_cast<const __nv_bfloat16*>(scales), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), BH, hkv, G, T, max_chunks,
      n_chunks, li, kf, vf);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, Hkv*G, 128] bf16; pool [L, mc, B*Hkv, KR+VR, 128] int16; scales
// [L, mc, B*Hkv, 2, 128] bf16 at `qbits` 8, null at 16; acc
// [B, T, Hkv*G, 128] f32; m, l [B, T, Hkv*G, 1] f32.  All contiguous and
// 16-byte aligned; shapes checked by the caller.  `device` is the ordinal
// the tensors and the stream belong to; BH = B * hkv; (k0, k1) and
// (vk0, vk1) the K and V streams' segment widths (k1 = 0: one segment).
extern "C" int sp_segment(const void* q, const void* pool, const void* scales, void* acc,
                          void* m, void* l, int device, int qbits, int BH, int hkv, int G,
                          int T, int max_chunks, int n_chunks, int li, int k0, int k1,
                          int vk0, int vk1, void* stream) {
  if (hkv < 1 || BH % hkv || G < 1 || T < 1 || n_chunks < 0 ||
      n_chunks > max_chunks || li < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qbits == 16)
    return launch<16>(q, pool, scales, acc, m, l, BH, hkv, G, T, max_chunks, n_chunks,
                      li, k0, k1, vk0, vk1, s);
  if (qbits == 8)
    return launch<8>(q, pool, scales, acc, m, l, BH, hkv, G, T, max_chunks, n_chunks,
                     li, k0, k1, vk0, vk1, s);
  return (int)cudaErrorInvalidValue;
}
