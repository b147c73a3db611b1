// The archive's decode-attention generations v4, v5 and v6 for Hopper
// (sm_90a), over the fused int16 stream pool [mc, B*Hkv, KR + VR, 128]
// (ops/sparse_format.py encode_stream: per chunk and kv head, K's value
// segments and its 16 uint16 word planes, then V's), which is one layer
// kv_pool[li] of the compressed cache's stacked pool.
//
// sp_fused_v4 replaces the TPU kernel
// mustafar_tpu/ops/kernels/sparse_attention_archive.py
// fused_sparse_decode_attention_v4 (Pallas body _fused_v4_kernel): v2's
// function over the fused stream, one copy a chunk, then the whole window
// in one online-softmax step masked at -1e30.  sp_fused_v5 replaces
// fused_sparse_decode_attention_v5 (_fused_v5_kernel), v4's function with
// the heads of a grid step batched into large products, and sp_fused_v6
// replaces fused_sparse_decode_attention_v6 (_fused_v6_kernel), whose
// kernel streams the pools only and returns the flash partials (acc, m, l);
// its window attention and merge are XLA ops in the reference and torch ops
// in the port (ops/kernels/sparse_attention_archive.py).
//
// What bounds them on this card: bytes.  Per call v4 and v5 must read
//   B*Hkv*(n_chunks*2*24,576 + 2*win_len*128*2) bytes (+ q, out)
// at sparsity 0.7 (48 KB of stream a chunk and kv head), v6's kernel the
// pools alone: at B=8, Hkv=8, one chunk and a 288-token window 12.7 MB
// (3.8 us at 3.35 TB/s), the pools 3.1 MB (0.94 us).  The products are a
// few flops a byte.  The expansion's instructions, one block per kv head
// and launch latency bind first, as for v2 and v3 (sp_archive_fused.cu).
//
// Design (first, simple version), one block of 8 warps per (b, kv head):
//   v4: archive_fused.cuh's body over the stream layout: a chunk's whole
//       KR + VR row-block comes in as one cp.async copy, double-buffered,
//       the Hopper form of v4's single make_async_copy per chunk; scalar
//       products, the window in one step.
//   v6: the same body with the PARTIALS option: no window, the partials
//       written unnormalised; with a sliding window the chunks wholly at or
//       below its lower edge are skipped and the straddling chunk's masked
//       columns scored -1e30 (the header says why that is exact).
//   v5: the TPU batches hpb heads into one grid step to replace many small
//       MXU products by few large ones.  On this card fewer blocks would
//       under-fill 132 SMs (64 blocks at B=8 already do), and one group's
//       chunk tile at hpb = 8 (8 x 49 KB) does not fit in a block's 227 KB,
//       so a block keeps one kv head and v5's point is kept in another
//       form: the scores and the p.V products run on the tensor cores
//       (mma.sync m16n8k16 bf16, mma_bf16.cuh), the G query rows padded to
//       the 16 rows of an MMA tile.  Only the diagonal block is computed:
//       v5's masked cross-head columns add exactly 0 once a column is live.
//       Per chunk the K rows are expanded into a bf16 tile of 128 rows in
//       shared memory (one warp a token row), half a chunk at a time, the
//       warps' MMAs write the scaled scores (8-token column tiles split
//       across warps), one online-softmax step over the chunk
//       (softmax_step.cuh) rounds p to bf16, V is expanded into the same
//       tile a half at a time, and each warp accumulates 16 output channels
//       over all tokens in MMA accumulators.  The stream comes in with
//       cp.async into one buffer, the next chunk's copy issued once this
//       one's V is expanded: with a whole-chunk tile and two buffers a
//       block took 177 KB, one block an SM, and at B=32 (256 blocks) v5
//       took 1.6x v4's time; half the tile and one buffer take 93 KB at
//       sparsity 0.7, two blocks an SM (v3's second buffer gains 1-3 %
//       over v2's plain loads).  The window is one step, its rows copied
//       into the tile 128 at a time.  With nothing to attend (n_chunks =
//       win_len = 0) every one of the grid step's hpb*W window columns has
//       p = 1 on the TPU, so the block writes the mean of the hpb heads'
//       window rows (hpb as the wrapper reduces it).
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include "archive_fused.cuh"
#include "mma_bf16.cuh"

namespace {

using archive_fused::Layout;
using archive_fused::NEG;
using archive_fused::NR;
using archive_fused::SM_SCALE;
using archive_fused::SMEM_MAX;
using archive_fused::THREADS;
using archive_fused::WARPS;
using bitmap::CHUNK;
using bitmap::D;
using bitmap::Fmt;

constexpr int LD = D + 8;                 // padded tile row: no bank conflicts
constexpr int TILE = CHUNK / 2;           // rows of v5's tile: half a chunk

archive_fused::Pools stream_pools(const void* pool) {
  return archive_fused::Pools{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              static_cast<const int16_t*>(pool)};
}

// Bytes of v5's tile [TILE][LD] bf16 and its scores [G][ns], m, l, corr,
// rounded to 16; the stage buffer follows.
__host__ __device__ inline size_t v5_head_bytes(int G, int ns) {
  return (size_t)TILE * LD * 2 + ((size_t)G * ns * 4 + 3 * (size_t)G * 4 + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// One stream's token rows r0 .. r0 + TILE - 1 expanded into the bf16 tile
// by the block's warps, ROWS_IN_FLIGHT rows back to back.
__device__ __forceinline__ void expand_tile(const int16_t* __restrict__ stream,
                                            const Fmt<16> f, __nv_bfloat16 (*dst)[LD],
                                            int r0, int warp, int lane) {
  for (int t0 = warp; t0 < TILE; t0 += NR * WARPS) {
    float x[NR][4];
#pragma unroll
    for (int j = 0; j < NR; ++j)
      bitmap::expand_row<16, 16>(stream, f, r0 + t0 + j * WARPS, lane, x[j]);
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[t0 + j * WARPS][lane + 32 * i] = __float2bfloat16(x[j][i]);
  }
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * gid + tig): A holds rows gid
// and gid + 8, columns 2 tig (+1) and 2 tig + 8 (+1); B column gid, rows
// 2 tig (+1) and 2 tig + 8 (+1); the f32 accumulator rows gid (c0, c1) and
// gid + 8 (c2, c3), columns 2 tig and 2 tig + 1.  Query row g < G is A row
// gid = g; rows gid + 8 and g >= G are the padding (0).
template <int G>
__global__ void __launch_bounds__(THREADS)
v5_kernel(const __nv_bfloat16* __restrict__ q,       // [B*Hkv, G, D]
          const int16_t* __restrict__ pool,          // [mc, B*Hkv, KR + VR, D]
          const __nv_bfloat16* __restrict__ k_win,   // [B, W, Hkv, D]
          const __nv_bfloat16* __restrict__ v_win,
          void* __restrict__ out,                    // [B*Hkv, G, D]
          int out_f32, int BH, int Hkv, int W, int n_chunks, int win_len, int hpb, int ns,
          Fmt<16> kf, Fmt<16> vf) {
  static_assert(G <= WARPS && G <= 8, "one warp per query head; rows of one MMA half");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto tile = reinterpret_cast<__nv_bfloat16 (*)[LD]>(smem_raw);
  float* base = reinterpret_cast<float*>(smem_raw + (size_t)TILE * LD * 2);
  archive_fused::Smem sm{archive_fused::Rows{base, ns}, base + (size_t)G * ns, nullptr,
                         nullptr};
  sm.l = sm.m + G;
  sm.corr = sm.l + G;
  int16_t* stage = reinterpret_cast<int16_t*>(smem_raw + v5_head_bytes(G, ns));
  const size_t rows = (size_t)kf.rows() + vf.rows();
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const size_t b = bh / Hkv, h = bh % Hkv;

  // ---- nothing to attend: the mean of the grid step's hpb heads' windows -----
  if (n_chunks == 0 && win_len == 0) {
    float* red = reinterpret_cast<float*>(smem_raw);   // [THREADS]
    const int g0 = bh / hpb * hpb;
    const int d = tid % D;
    float sum = 0.f;
    for (int hh = 0; hh < hpb; ++hh) {
      const size_t b2 = (g0 + hh) / Hkv, h2 = (g0 + hh) % Hkv;
      for (int t = tid / D; t < W; t += THREADS / D)
        sum += __bfloat162float(v_win[((b2 * W + t) * Hkv + h2) * D + d]);
    }
    red[tid] = sum;
    __syncthreads();
    if (tid < D) {
      float o = red[tid];
      for (int j = 1; j < THREADS / D; ++j) o += red[tid + j * D];
      o /= (float)hpb * (float)W;
      for (int g = 0; g < G; ++g) {
        const size_t at = ((size_t)bh * G + g) * D + tid;
        if (out_f32)
          static_cast<float*>(out)[at] = o;
        else
          static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(o);
      }
    }
    return;
  }

  uint32_t qa[D / 16][2];        // A fragments of row gid: channels k0 (+1), k0 + 8 (+1)
  {
    const __nv_bfloat16* qrow = gid < G ? q + ((size_t)bh * G + gid) * D : nullptr;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int k0 = 16 * kk + 2 * tig;
      qa[kk][0] = qrow ? ld32(qrow + k0) : 0u;
      qa[kk][1] = qrow ? ld32(qrow + k0 + 8) : 0u;
    }
  }
  if (tid < G) {
    sm.m[tid] = NEG;
    sm.l[tid] = 0.f;
  }
  float o[2][4];                 // row gid, channels 16 warp + 8 j + 2 tig (+1)
#pragma unroll
  for (int j = 0; j < 2; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  __syncthreads();

  // scaled scores of the tile's first n rows -> sm.s[g][col0 + t]
  auto scores = [&](int n, int col0) {
    for (int nt = warp; nt * 8 < n; nt += WARPS) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* kr = &tile[8 * nt + gid][0];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int k0 = 16 * kk + 2 * tig;
        mma_bf16(c, qa[kk][0], 0u, qa[kk][1], 0u, ld32(kr + k0), ld32(kr + k0 + 8));
      }
      const int t = 8 * nt + 2 * tig;
      if (gid < G) {
        if (t < n) sm.s[gid][col0 + t] = c[0] * SM_SCALE;
        if (t + 1 < n) sm.s[gid][col0 + t + 1] = c[1] * SM_SCALE;
      }
    }
  };
  // the accumulator times this step's corr
  auto rescale = [&]() {
    const float c = gid < G ? sm.corr[gid] : 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      o[j][0] *= c;
      o[j][1] *= c;
    }
  };
  // o += bf16(p) . V over the tile's first n rows (rows up to n rounded to
  // 16 hold finite values), p = sm.s[g][col0 + t]
  auto pv = [&](int n, int col0) {
    auto p = [&](int t) { return gid < G && t < n ? sm.s[gid][col0 + t] : 0.f; };
    for (int k = 0; k * 16 < n; ++k) {
      const int tk = 16 * k + 2 * tig;
      const uint32_t a0 = pack_bf16(p(tk), p(tk + 1));
      const uint32_t a2 = pack_bf16(p(tk + 8), p(tk + 9));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = 16 * warp + 8 * j + gid;
        mma_bf16(o[j], a0, 0u, a2, 0u, pack_raw(tile[tk][d], tile[tk + 1][d]),
                 pack_raw(tile[tk + 8][d], tile[tk + 9][d]));
      }
    }
  };

  // ---- pool chunks: one step each, the tile filled a half chunk at a time --
  auto fetch = [&](int ci) {
    bitmap::stage_rows_async(stage, pool + ((size_t)ci * BH + bh) * rows * D, (int)rows, tid,
                             THREADS);
  };
  if (n_chunks > 0) fetch(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    bitmap::cp_async_wait<0>();      // (the barrier below makes chunk ci visible)
    for (int r0 = 0; r0 < CHUNK; r0 += TILE) {
      __syncthreads();               // the tile's last readers are done
      expand_tile(stage, kf, tile, r0, warp, lane);
      __syncthreads();
      scores(TILE, r0);
    }
    __syncthreads();
    online_softmax::softmax_step<G>(sm, CHUNK, warp, lane);
    rescale();
    for (int r0 = 0; r0 < CHUNK; r0 += TILE) {
      __syncthreads();
      expand_tile(stage + (size_t)kf.rows() * D, vf, tile, r0, warp, lane);
      __syncthreads();
      if (r0 + TILE == CHUNK && ci + 1 < n_chunks) fetch(ci + 1);   // the stage is read
      pv(TILE, r0);
    }
  }

  // ---- the window: its live rows in one step, TILE rows of the tile at a time
  auto load_win = [&](const __nv_bfloat16* win, int p0, int n) {
    const int n16 = (n + 15) / 16 * 16;
    for (int i = tid; i < n16 * (D / 8); i += THREADS) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < n) v = *reinterpret_cast<const uint4*>(win + ((b * W + p0 + r) * Hkv + h) * D + c);
      *reinterpret_cast<uint4*>(&tile[r][c]) = v;
    }
  };
  if (win_len > 0) {
    for (int p0 = 0; p0 < win_len; p0 += TILE) {
      const int n = min(TILE, win_len - p0);
      __syncthreads();
      load_win(k_win, p0, n);
      __syncthreads();
      scores(n, p0);
    }
    __syncthreads();
    online_softmax::softmax_step<G>(sm, win_len, warp, lane);
    rescale();
    for (int p0 = 0; p0 < win_len; p0 += TILE) {
      const int n = min(TILE, win_len - p0);
      __syncthreads();
      load_win(v_win, p0, n);
      __syncthreads();
      pv(n, p0);
    }
  }

  // ---- out = acc / l ----------------------------------------------------------
  if (gid < G) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const size_t at = ((size_t)bh * G + gid) * D + 16 * warp + 8 * j + 2 * tig;
      const float o0 = o[j][0] / sm.l[gid];
      const float o1 = o[j][1] / sm.l[gid];
      if (out_f32) {
        static_cast<float*>(out)[at] = o0;
        static_cast<float*>(out)[at + 1] = o1;
      } else {
        static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(o0);
        static_cast<__nv_bfloat16*>(out)[at + 1] = __float2bfloat16(o1);
      }
    }
  }
}

int launch_v5(const void* q, const void* pool, const void* k_win, const void* v_win,
              void* out, int out_f32, int device, int B, int Hkv, int G, int mc, int W,
              int n_chunks, int win_len, int hpb, int k0, int k1, int vk0, int vk1,
              void* stream) {
  bool k_ok, v_ok;
  const Fmt<16> kf = bitmap::make_fmt<16>(k0, k1, &k_ok);
  const Fmt<16> vf = bitmap::make_fmt<16>(vk0, vk1, &v_ok);
  const int BH = B * Hkv;
  if (!k_ok || !v_ok || B < 1 || Hkv < 1 || mc < 1 || W < 1 || n_chunks < 0 ||
      n_chunks > mc || win_len < 0 || win_len > W || hpb < 1 || BH % hpb)
    return (int)cudaErrorInvalidValue;
  const int ns = ((W > CHUNK ? W : CHUNK) + 3) / 4 * 4;
  const size_t smem = v5_head_bytes(G, ns) + ((size_t)kf.rows() + vf.rows()) * D * 2;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;   // a window too long
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define V5_LAUNCH(g)                                                                  \
  {                                                                                   \
    err = cudaFuncSetAttribute(v5_kernel<g>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               (int)smem);                                            \
    if (err != cudaSuccess) return (int)err;                                          \
    v5_kernel<g><<<BH, THREADS, smem, s>>>(                                           \
        static_cast<const __nv_bfloat16*>(q), static_cast<const int16_t*>(pool),      \
        static_cast<const __nv_bfloat16*>(k_win), static_cast<const __nv_bfloat16*>(v_win), \
        out, out_f32, BH, Hkv, W, n_chunks, win_len, hpb, ns, kf, vf);                \
  }
  switch (G) {
    case 1: V5_LAUNCH(1); break;
    case 2: V5_LAUNCH(2); break;
    case 4: V5_LAUNCH(4); break;
    case 8: V5_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef V5_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, 1, Hkv*G, 128] bf16; pool [mc, B*Hkv, KR + VR, 128] int16 (the fused
// stream, K rows then V rows); k_win / v_win [B, W, Hkv, 128] bf16; out
// [B, 1, Hkv*G, 128], f32 if `out_f32`, else bf16.  All contiguous and
// 16-byte aligned; shapes checked by the caller.  (k0, k1) and (vk0, vk1)
// are the streams' segment widths.  A window whose scores do not fit in
// shared memory beside the chunk buffers is refused (cudaErrorInvalidValue).
extern "C" int sp_fused_v4(const void* q, const void* pool, const void* k_win,
                           const void* v_win, void* out, int out_f32, int device, int B,
                           int Hkv, int G, int mc, int W, int n_chunks, int win_len, int k0,
                           int k1, int vk0, int vk1, void* stream) {
  return archive_fused::launch<Layout::kStream, false>(
      q, stream_pools(pool), k_win, v_win, out, nullptr, nullptr, out_f32, device, B, Hkv,
      G, mc, W, n_chunks, win_len, -1, k0, k1, vk0, vk1, stream);
}

// As sp_fused_v4, on the tensor cores; `hpb` (a divisor of B*Hkv) is the
// TPU grid step's heads, which only the nothing-to-attend case reads.
extern "C" int sp_fused_v5(const void* q, const void* pool, const void* k_win,
                           const void* v_win, void* out, int out_f32, int device, int B,
                           int Hkv, int G, int mc, int W, int n_chunks, int win_len, int hpb,
                           int k0, int k1, int vk0, int vk1, void* stream) {
  return launch_v5(q, pool, k_win, v_win, out, out_f32, device, B, Hkv, G, mc, W, n_chunks,
                   win_len, hpb, k0, k1, vk0, vk1, stream);
}

// The pools' partials of v6: acc [B*Hkv, G, 128], m and l [B*Hkv, G], f32,
// over the first n_chunks chunks with columns at or below `low` masked (-1:
// none).  q and pool as for sp_fused_v4.
extern "C" int sp_fused_v6(const void* q, const void* pool, void* acc, void* m, void* l,
                           int device, int B, int Hkv, int G, int mc, int n_chunks, int low,
                           int k0, int k1, int vk0, int vk1, void* stream) {
  return archive_fused::launch<Layout::kStream, true>(
      q, stream_pools(pool), nullptr, nullptr, acc, static_cast<float*>(m),
      static_cast<float*>(l), 1, device, B, Hkv, G, mc, 1, n_chunks, 0, low, k0, k1, vk0,
      vk1, stream);
}
