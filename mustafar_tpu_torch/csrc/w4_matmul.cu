// W4 decode matmul for Hopper (sm_90a): out [T, DOUT] = x [T, DIN] @ W4.
//
// Replaces the TPU kernel mustafar_tpu/ops/kernels/w4_matmul.py w4_matmul
// (Pallas body _w4_matmul_kernel).  The weight is int4 codes in block-local
// int16 nibble carriers: within 128-row block b of DIN, carrier row b*32 + r
// holds in-rows b*128 + 32 j + r in nibble j (two's complement), with one
// bf16 scale per (block, out channel).  As on the TPU, x is read as bf16,
// each block's bf16 x code product is summed in f32, and the block's scale,
// widened to f32, multiplies that partial; the blocks' sum is rounded to
// the output's type (bf16, or f32 for f32 activations).  T is 1..128 (the
// ragged edge is masked, nothing is padded); DIN and DOUT are multiples of
// 128.
//
// What bounds it on this card: bytes.  The carriers are half a byte a
// weight: 8.4 MB at 4096 x 4096, 29.4 MB at 4096 x 14336, some 2.5 us and
// 8.8 us at 3.35 TB/s, against 2 x T flops a weight; at T <= 128 the
// tensor cores could do ~250 times more work than the bytes allow.
//
// Design: a persistent grid streams the weight through shared memory.
//   * A work unit is one token tile (8, 16 or 32 tokens) x one column tile
//     of 128 out channels x one 128-row scale block: 8 KB of carriers, 256
//     bytes of scales and the x slice.  Units are numbered with the block
//     fastest, and CTA c of `ctas` (at most two an SM) takes units
//     [c * units / ctas, (c + 1) * units / ctas).  The caller picks `ctas`
//     (w4_matmul.partition in ops/kernels/w4_matmul.py): a multiple of the
//     (token tile, column tile) pairs where they fit, so that each pair is
//     split over the same number of CTAs and all CTAs stream the same
//     block rows of the carriers at about the same time (an even split
//     over every SM read them in scattered order and was slower), else
//     two an SM (stream-K).
//   * In each CTA one producer warp keeps a ring of STAGES units in flight:
//     TMA tile loads (128-byte swizzled boxes of 64 columns) of the
//     carriers and of x, a bulk copy of the scales, all completing on the
//     stage's mbarrier.  Four consumer warps, 32 out channels each, take
//     the carriers with ldmatrix.trans: lane (g, q) gets carrier rows 2q
//     and 2q + 1 of channel g of each 8 x 8 tile, so a nibble of each half
//     is one bf16 pair of an mma.sync m16n8k16 A fragment (out channels as
//     M, tokens as N), and the matching x in-rows are two neighbours (one
//     32-bit load).  A nibble becomes bf16 without f32: its sign bit
//     flipped, it is placed in the mantissa of 128.0 (bf16 0x4300), and one
//     bf16x2 subtract of 136 leaves the code, exactly.  No dequantized
//     weight exists anywhere.  The scale multiplies a block's partial,
//     which joins the CTA's running total for the column tile.
//   * The reduction over DIN is fused: a column tile whose blocks one CTA
//     covers alone is rounded and written at once; else each CTA on it
//     leaves its f32 partial in a workspace slot, and the last of them to
//     finish (a per-tile counter, which it resets) sums the partials in
//     CTA order and writes the tile.  One launch a projection, and the
//     same bits from run to run.  The workspace and the counters are the
//     caller's, kept per stream (w4_matmul._workspace); their sizes are
//     checked here.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W, L2 flushed by a 256 MB write;
// tools/kernel_ab.py, PERF.md §6): 0.0248 ms at 4096 x 14336, T=8 (bound
// 0.0091; the first version, a grid of 64-channel blocks and a second
// kernel for the sum over DIN, 0.0332), 0.0141 at 4096 x 4096, 0.0114 at
// 4096 x 1024, 0.0249 at 14336 x 4096, 0.0371 at 4096 x 28672; at T=32
// 0.0294 at 4096 x 14336 (0.0571).  Without the fused reduction 0.0232,
// without the products 0.0224: the ring's streaming binds, some 2 TB/s,
// with a fixed cost of launch, fill and tail that dominates the small
// projections.  Up to 2 CTAs an SM, 93-167 registers, no spill.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "smem_stage.cuh"

namespace {

constexpr int BLOCK = 128;           // in-rows per scale
constexpr int CROWS = BLOCK / 4;     // carrier rows per scale block
constexpr int COLS = 128;            // out channels per column tile
constexpr int CONSUMERS = 4;         // consumer warps, 32 out channels each
constexpr int THREADS = 32 * (CONSUMERS + 1);
constexpr int STAGES = 6;
constexpr int CTAS_PER_SM = 2;
constexpr int SLOTS_PER_CTA = 2;     // a CTA's partial tiles: its first and its last

// One stage: the carriers (two boxes of 64 columns x 32 rows), x (two
// boxes of 64 in-rows x TOK tokens), the scales, 1,024-byte aligned.
template <int TOK>
struct Stage {
  static constexpr unsigned CARRIERS = 0;
  static constexpr unsigned X = 2 * CROWS * 128;
  static constexpr unsigned SCALES = X + 2 * TOK * 128;
  static constexpr unsigned TX = SCALES + COLS * 2;          // bytes a unit brings
  static constexpr unsigned BYTES = (TX + 1023u) & ~1023u;
  static constexpr unsigned SMEM = STAGES * BYTES + 2 * STAGES * 8 + 16 + 1024;
};

// bf16x2 of nibble j of both int16 halves of `w` (module note).
__device__ __forceinline__ uint32_t nibbles2(uint32_t w, int j) {
  uint32_t bits = ((w >> (4 * j)) & 0x000F000Fu) ^ 0x43084308u;     // 136 + code
  uint32_t k136 = 0x43084308u;                                      // {136, 136}
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&bits),
                             *reinterpret_cast<__nv_bfloat162*>(&k136));
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Grid {
  int T, din, dout, tiles, nb, units, ctas;   // units * ctas < 2^32 (checked)
  // the first unit of CTA c; CTA c takes [first(c), first(c + 1))
  __device__ __forceinline__ int first(int c) const {
    return (int)((unsigned)c * (unsigned)units / (unsigned)ctas);
  }
  // the CTA whose range holds unit u
  __device__ __forceinline__ int cta_of(int u) const {
    return (int)(((unsigned)(u + 1) * (unsigned)ctas - 1u) / (unsigned)units);
  }
  // the slot of CTA c's partial of tile `key`: 0 if it is the CTA's first
  // tile, else 1
  __device__ __forceinline__ int slot(int c, int key) const {
    return c * SLOTS_PER_CTA + (first(c) / nb == key ? 0 : 1);
  }
};

template <int NT>   // 8-token tiles of a token tile
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
w4_matmul_kernel(const __grid_constant__ CUtensorMap xmap,   // x [T, din] bf16
                 const __grid_constant__ CUtensorMap cmap,   // carriers [din/4, dout] 16 bits
                 const __nv_bfloat16* __restrict__ scales,  // [din / 128, dout]
                 void* __restrict__ out,                    // [T, dout]
                 float* __restrict__ ws,                    // [ctas * 2][TOK][COLS]
                 int* __restrict__ counters,                // [token tiles * tiles], zeros
                 int out_f32, Grid gr) {
  constexpr int TOK = 8 * NT;
  using S = Stage<TOK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned raw0 = smem::smem_addr(smem_raw);
  const unsigned sb = (raw0 + 1023u) & ~1023u;
  unsigned char* gb = smem_raw + (sb - raw0);
  const unsigned full0 = sb + STAGES * S::BYTES;     // STAGES "full" barriers,
  const unsigned empty0 = full0 + STAGES * 8;        // then STAGES "empty" ones
  int* last_flag = reinterpret_cast<int*>(gb + STAGES * S::BYTES + 2 * STAGES * 8);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cta = blockIdx.x;
  const int u_begin = gr.first(cta);
  const int u_end = gr.first(cta + 1);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      smem::mbar_init(full0 + 8 * s, 1);
      smem::mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    smem::fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // ---- producer: one lane fills the ring ----------------------------------
    if (lane == 0) {
      for (int u = u_begin, it = 0; u < u_end; ++u, ++it) {
        const int s = it % STAGES;
        smem::mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        const int key = u / gr.nb;                  // (token tile, column tile)
        const int blk = u - key * gr.nb;
        const int tt = key / gr.tiles;
        const int col0 = (key - tt * gr.tiles) * COLS;
        const unsigned st = sb + s * S::BYTES;
        const unsigned full = full0 + 8 * s;
        smem::mbar_expect_tx(full, S::TX);
        for (int h = 0; h < 2; ++h) {
          smem::tma_load_2d(st + S::CARRIERS + h * CROWS * 128, &cmap, col0 + 64 * h,
                            blk * CROWS, full);
          smem::tma_load_2d(st + S::X + h * TOK * 128, &xmap, blk * BLOCK + 64 * h, tt * TOK,
                            full);
        }
        smem::bulk_copy(st + S::SCALES, scales + (size_t)blk * gr.dout + col0, COLS * 2, full);
      }
    }
    return;
  }

  // ---- consumers: warp w on out channels 32 w .. 32 w + 31 of the tile ------
  const int g = lane >> 2;    // mma group: M rows g, g + 8; N column (token) g
  const int q = lane & 3;
  const int half = warp >> 1;                     // the carriers' box of this warp
  const int oct0 = 4 * (warp & 1);                // its first 8-channel chunk in the box
  float total[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[mt][n][e] = 0.f;

  for (int u = u_begin, it = 0; u < u_end; ++u, ++it) {
    const int s = it % STAGES;
    const int key = u / gr.nb;                    // (token tile, column tile)
    const unsigned char* st = gb + s * S::BYTES;
    smem::mbar_wait(full0 + 8 * s, (it / STAGES) & 1);

    // carriers: tile i of rows 8 i .. 8 i + 7; matrix m of the x4 is this
    // warp's chunk oct0 + m (channels 8 (oct0 + m) .. + 7 of the box)
    uint32_t cr[4][4];
    {
      const int row_in = lane & 7;
      const int m = lane >> 3;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 8 * i + row_in;
        ldmatrix_x4<true>(cr[i], st + S::CARRIERS + half * CROWS * 128 + r * 128 +
                                     (((oct0 + m) ^ (r & 7)) << 4));
      }
    }
    // scales of this lane's channels: M rows g and g + 8 of tiles mt = 0, 1
    float sc[2][2];
    {
      const __nv_bfloat16* sp = reinterpret_cast<const __nv_bfloat16*>(st + S::SCALES);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        sc[mt][0] = __bfloat162float(sp[32 * warp + 16 * mt + g]);
        sc[mt][1] = __bfloat162float(sp[32 * warp + 16 * mt + 8 + g]);
      }
    }
    float part[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][n][e] = 0.f;
    // k-step (i, jp): k positions 2q, 2q + 1 are nibble 2 jp of carrier rows
    // 8 i + 2q, 8 i + 2q + 1 (in-rows 64 jp + 8 i + 2q, + 1), positions
    // 2q + 8, 2q + 9 nibble 2 jp + 1 (in-rows 64 jp + 32 + 8 i + 2q, + 1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bfr[NT][2];
        const unsigned char* xh = st + S::X + jp * TOK * 128;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int t = 8 * n + g;
          bfr[n][0] = ld32(xh + t * 128 + ((i ^ (t & 7)) << 4) + 4 * q);
          bfr[n][1] = ld32(xh + t * 128 + (((4 + i) ^ (t & 7)) << 4) + 4 * q);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t a0 = nibbles2(cr[i][2 * mt], 2 * jp);
          const uint32_t a1 = nibbles2(cr[i][2 * mt + 1], 2 * jp);
          const uint32_t a2 = nibbles2(cr[i][2 * mt], 2 * jp + 1);
          const uint32_t a3 = nibbles2(cr[i][2 * mt + 1], 2 * jp + 1);
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma_bf16(part[mt][n], a0, a1, a2, a3, bfr[n][0], bfr[n][1]);
        }
      }
    __syncwarp();
    if (lane == 0) smem::mbar_arrive(empty0 + 8 * s);   // the stage is free
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        total[mt][n][0] += __fmul_rn(part[mt][n][0], sc[mt][0]);
        total[mt][n][1] += __fmul_rn(part[mt][n][1], sc[mt][0]);
        total[mt][n][2] += __fmul_rn(part[mt][n][2], sc[mt][1]);
        total[mt][n][3] += __fmul_rn(part[mt][n][3], sc[mt][1]);
      }

    // ---- the end of this CTA's run on the tile ---------------------------------
    const bool ends = u + 1 == u_end || (u + 1) / gr.nb != key;
    if (!ends) continue;
    const int tt = key / gr.tiles;
    const int tok0 = tt * TOK;
    const int col0 = (key - tt * gr.tiles) * COLS;
    const int kfirst = key * gr.nb;               // the tile's first and last units
    const bool alone = kfirst >= u_begin && kfirst + gr.nb <= u_end;
    // accumulator e of (mt, n): channel 32 w + 16 mt + g + 8 (e / 2), token
    // 8 n + 2 q + e % 2
    if (alone) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = tok0 + 8 * n + 2 * q + (e & 1);
            if (t >= gr.T) continue;
            const size_t at = (size_t)t * gr.dout + col0 + 32 * warp + 16 * mt + g + 8 * (e >> 1);
            if (out_f32)
              static_cast<float*>(out)[at] = total[mt][n][e];
            else
              static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(total[mt][n][e]);
          }
    } else {
      float* mine = ws + (size_t)gr.slot(cta, key) * TOK * COLS;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mine[(8 * n + 2 * q + (e & 1)) * COLS + 32 * warp + 16 * mt + g + 8 * (e >> 1)] =
                total[mt][n][e];
      // the consumers' partials, ordered before thread 0's arrival, which
      // releases them at gpu scope and acquires the other CTAs' with the
      // count (one fence a CTA, not one a thread)
      asm volatile("bar.sync 1, %0;\n" :: "n"(32 * CONSUMERS) : "memory");
      if (tid == 0) {
        const int c0 = gr.cta_of(kfirst);
        const int c1 = gr.cta_of(kfirst + gr.nb - 1);
        int done;
        asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                     : "=r"(done) : "l"(counters + key) : "memory");
        *last_flag = done == c1 - c0;
        if (done == c1 - c0) counters[key] = 0;     // for the next launch
      }
      asm volatile("bar.sync 1, %0;\n" :: "n"(32 * CONSUMERS) : "memory");
      if (*last_flag) {                             // every partial is in: sum in CTA order
        constexpr int PER = TOK * COLS / (32 * CONSUMERS);   // elements a thread
        const int c0 = gr.cta_of(kfirst);
        const int c1 = gr.cta_of(kfirst + gr.nb - 1);
        float v[PER];
#pragma unroll
        for (int j = 0; j < PER; ++j) v[j] = 0.f;
        for (int c = c0; c <= c1; ++c) {
          const float* part_c = ws + (size_t)gr.slot(c, key) * TOK * COLS + tid;
#pragma unroll
          for (int j = 0; j < PER; ++j) v[j] += __ldcg(part_c + j * 32 * CONSUMERS);
        }
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int idx = j * 32 * CONSUMERS + tid;
          const int t = tok0 + idx / COLS;
          if (t >= gr.T) continue;
          const size_t at = (size_t)t * gr.dout + col0 + idx % COLS;
          if (out_f32)
            static_cast<float*>(out)[at] = v[j];
          else
            static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(v[j]);
        }
      }
      asm volatile("bar.sync 1, %0;\n" :: "n"(32 * CONSUMERS) : "memory");
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[mt][n][e] = 0.f;
  }
}

// cuTensorMapEncodeTiled from the driver, looked up once (no link to libcuda).
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A 2D map of 16-bit elements [rows, cols] (cols contiguous) in boxes of
// 64 columns x box_rows, 128-byte swizzled; rows past the end read as 0.
bool map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rows,
            int cols, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t one[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT>
int launch(const void* x, const void* carriers, const void* scales, void* out, void* ws,
           void* counters, int out_f32, const Grid& gr, int device, cudaStream_t stream) {
  CUtensorMap xmap, cmap;
  if (!map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, gr.T, gr.din, 8 * NT) ||
      !map_2d(&cmap, CU_TENSOR_MAP_DATA_TYPE_UINT16, carriers, gr.din / 4, gr.dout, CROWS))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)Stage<8 * NT>::SMEM;
  const cudaError_t err = smem::allow_dynamic_smem<w4_matmul_kernel<NT>>(smem, device);
  if (err != cudaSuccess) return (int)err;
  w4_matmul_kernel<NT><<<gr.ctas, THREADS, smem, stream>>>(
      xmap, cmap, static_cast<const __nv_bfloat16*>(scales), out, static_cast<float*>(ws),
      static_cast<int*>(counters), out_f32, gr);
  return (int)cudaGetLastError();
}

}  // namespace

// x [T, din] bf16; carriers [din/4, dout] int16; scales [din/128, dout] bf16;
// out [T, dout] f32 if `out_f32`, else bf16.  All contiguous and 16-byte
// aligned; shapes checked by the caller.  `ctas` CTAs (at most two an SM
// of the device and at most one a unit; w4_matmul.partition); `ws` at
// least ctas * 2 * tok * 128 floats and `counters` at least
// ceil(T / tok) * dout / 128 ints, all zero (each launch leaves them so),
// where tok is the token tile: 8, 16 or 32 as T is at most 8, 16 or more.
// A short workspace or counter array is refused.
extern "C" int w4_matmul(const void* x, const void* carriers, const void* scales,
                         void* out, void* ws, void* counters, int ws_floats,
                         int n_counters, int out_f32, int device, int T, int din,
                         int dout, int ctas, void* stream) {
  if (T < 1 || T > 128 || din < BLOCK || dout < COLS || din % BLOCK || dout % COLS ||
      ctas < 1)
    return (int)cudaErrorInvalidValue;
  const int tok = T <= 8 ? 8 : T <= 16 ? 16 : 32;
  const int ntt = (T + tok - 1) / tok;
  const Grid gr{T, din, dout, dout / COLS, din / BLOCK, ntt * (dout / COLS) * (din / BLOCK),
                ctas};
  int sms = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (ctas > gr.units || ctas > CTAS_PER_SM * sms ||
      (unsigned long long)gr.units * (unsigned)ctas >= (1ull << 32) ||
      ws_floats < (long long)ctas * SLOTS_PER_CTA * tok * COLS ||
      n_counters < ntt * gr.tiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tok == 8) return launch<1>(x, carriers, scales, out, ws, counters, out_f32, gr, device, s);
  if (tok == 16) return launch<2>(x, carriers, scales, out, ws, counters, out_f32, gr, device, s);
  return launch<4>(x, carriers, scales, out, ws, counters, out_f32, gr, device, s);
}
