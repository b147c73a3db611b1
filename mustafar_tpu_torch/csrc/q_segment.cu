// Quant-codec segment attention for Hopper (sm_90a): the chunked-prefill
// partials of one segment of query rows over the packed pools.
//
// Replaces the TPU kernel mustafar_tpu/ops/kernels/quant_attention.py
// fused_q_segment_attention (Pallas body _q_seg_kernel) for the codecs q8,
// q8q4 and q4q4, with its sliding window.  For one layer `li` of the stacked
// cache and each (batch row b, kv head h) it attends the QR = T*G query
// rows of that kv head (segment token t, query head h*G + g; row t*G + g)
// over the first `n_chunks` packed pool chunks of 256 tokens:
//   scores = bf16(bf16(q) * kscale) . codes / sqrt(128),
// K and V as codes of KB and VB bits, 16/bits tokens per int16 row (token
// t + ROWS j in field j of row t: at 8 bits t and t+128 in the low and high
// byte, at 4 bits t + 64 j in nibble j), one online softmax step per chunk
// in f32 (mask value -1e30), p rounded to
// bf16 before the value product, the chunk's V scale applied after it:
//   acc = acc * corr + (bf16(p) . vcodes) * vscale.
// It writes the unnormalised partials acc [B,T,Hq,128] f32, m and l
// [B,T,Hq,1] f32 (no chunk: acc 0, m -1e30, l 0); the caller merges them
// with the window and causal-self partials.  One step per chunk is the TPU
// kernel's: its grouping of chunk DMAs (fdepth) does not change the steps.
// No pool chunk at or past n_chunks is read.
//
// The sliding window (window > 0): query row t*G + g sits at position
// seg_start + t and sees the pool columns past seg_start + t - window, so
// the edge moves along the segment's rows.  The TPU runs every chunk and
// scores the dead columns -1e30; a chunk dead for a row before its first
// live one is wiped by that step's correction exp(-1e30 - m) = 0.  Here a
// CTA leaves out the chunks dead for its oldest row (and so for all of
// them): it never copies or unpacks them.  In the one or two chunks that
// straddle its rows' edges the score accumulator is masked per element, in
// both score passes, to -1e30 (never -inf: -inf - -inf = NaN).  A row with
// no live column keeps m = -1e30, and its l and acc are finite sums over
// masked columns (exp(-1e30 - -1e30) = 1), as the TPU's: the merge with
// the window and self partials weighs it exp(-1e30 - M) = 0.  For a row
// with a live column the steps are the TPU's, bit for bit, but for the
// skipped chunks, which the correction wipes exactly.  At 31 chunks,
// seg_start 7,936 and Mistral's window of 4,096 (chunks 0-14 dead for
// every row) the q8q4 launch took 0.121 ms against 0.224 without the
// window (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py kernel_seg).
//
// What bounds it on this card: operations.  A segment of a layer does
// 4 * B*Hkv * QR * n_chunks * 256 * 128 operations (scores and values,
// multiply and add), about n_chunks x 1.07 GFLOP at B=1, Hkv=8, QR=1024:
// some 1.1 us a chunk at the card's bf16 tensor rate (989 TFLOP/s, NVIDIA
// H100 SXM at 700 W), against 0.12 us for the chunk's 48 KB (q8q4) of
// pool rows per head.  Every product is exact in
// bf16 x bf16 -> f32 (codes are small integers, q*kscale and p are rounded
// to bf16 first), so the tensor cores compute what the TPU's MXU does.
//
// Design: one warpgroup (4 warps, 128 threads) a CTA owns 64 query rows of
// one kv head (grid: row tiles x B*Hkv; 128 CTAs, one an SM, at B=1,
// T=256, G=4, Hkv=8).  For each chunk:
//   * the chunk's raw int16 rows and its two scale rows arrive by bulk
//     copy (cp.async.bulk, one mbarrier); the next chunk's copy is issued
//     as soon as this chunk's rows are unpacked, so it runs under this
//     chunk's products (the raw rows are 64 / 48 / 32 KB at q8 / q8q4 /
//     q4q4, the unpacked K and V tiles 64 KB each: no room for a second
//     set of tiles in 227 KB);
//   * the codes are unpacked once per CTA into bf16 K and V tiles in shared
//     memory (exact: small integers), in the K-major 128-byte-swizzled
//     layout wgmma reads (K by token, V transposed by channel), without
//     f32: a nibble is placed in the mantissa of 128.0 and one bf16x2
//     subtract leaves the code; an 8-bit code is 16 x its high nibble plus
//     its low one, each so placed (two bf16x2 ops and an add, all exact);
//   * bf16(q * kscale) for the CTA's rows is formed in shared memory from
//     the q rows kept there;
//   * the scores are taken in sub-tiles of 64 tokens (wgmma m64n64k16, A
//     and B from shared memory), twice: a first pass finds the chunk's row
//     max, the second recomputes each sub-tile, forms bf16(p) in registers
//     (the score accumulator's layout is the A fragment's) and runs the
//     value product on it (wgmma m64n128k16, A from registers), so one
//     softmax step a chunk and p rounded as in the TPU order, with no more
//     than a sub-tile of scores live;
//   * the chunk's value product accumulates on its own, then takes the V
//     scale and joins the accumulator with the correction factor.
// One source, templated on (KB, VB): three instances, each with its own
// shared-memory size, set once (smem_stage.cuh).
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/kernel_ab.py, PERF.md
// §6): at B=1, T=256, G=4 and 31 chunks 0.218 ms at q8q4, 0.240 at q8 and
// 0.197 at q4q4, where a first version with mma.sync, its codes unpacked
// in registers and a whole chunk's scores held per warp (255 registers,
// spilling) took 1.06 / 1.02 / 1.09; 0.016 ms at 1 chunk.  243 registers,
// no spill.  Without the unpack the 31-chunk q8q4 launch takes 0.146,
// without the score products 0.150, without the value product 0.199: the
// unpack and the two score passes each take a third, at one warpgroup an
// SM.  Unpacking V under the first pass, or issuing the next sub-tile's
// scores behind the value product, each made it slower; one m64n256
// product a k-step for the first pass took 3 % off (not taken: 128 more
// accumulators live for it).
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "smem_stage.cuh"

namespace {

constexpr int D = 128;                  // head_dim == lane width
constexpr int CHUNK = 256;              // tokens per packed chunk
constexpr int THREADS = 128;            // one warpgroup
constexpr int BLOCK_ROWS = 64;          // query rows per CTA, 16 per warp
constexpr int SUB = 64;                 // tokens per score sub-tile
constexpr float NEG = -1e30f;
constexpr float SM_SCALE = 0.08838834764831845f;   // 1 / sqrt(128)

// A chunk at BITS bits a code: 16 / BITS tokens per int16 carrier, so
// CHUNK * BITS / 16 rows; token t lies in row t % ROWS, field t / ROWS.
template <int BITS>
constexpr int ROWS_OF = CHUNK * BITS / 16;

// Shared memory, byte offsets from a 1024-byte-aligned base.  The wgmma
// operands are K-major, 128-byte swizzled: a tile is atoms of 64 K
// elements (128 bytes a row); in an atom, row r's 16-byte chunk c lies at
// r * 128 + ((c ^ (r % 8)) * 16) (the swizzle repeats every 8 rows, 1,024
// bytes).
constexpr unsigned KT = 0;                            // K: 2 atoms (channels) x 256 tokens
constexpr unsigned VT = KT + 2 * CHUNK * 128;         // V^T: 4 atoms (tokens) x 128 channels
constexpr unsigned QK = VT + 4 * D * 128;             // bf16(q * kscale): 2 atoms x 64 rows
constexpr unsigned QT = QK + 2 * BLOCK_ROWS * 128;    // q, the same layout
constexpr unsigned RAW = QT + 2 * BLOCK_ROWS * 128;   // the chunk's int16 rows
template <int ROWS>
struct Tail {                                         // after the raw rows
  static constexpr unsigned RSC = RAW + ROWS * D * 2;  // the chunk's bf16 scales [2][D]
  static constexpr unsigned KS = RSC + 2 * D * 2;      // f32 K scale [D]
  static constexpr unsigned VS = KS + D * 4;           // f32 V scale [D]
  static constexpr unsigned BAR = VS + D * 4;          // the copy's mbarrier
  static constexpr unsigned BYTES = BAR + 16 + 1024;   // + the base's alignment
};

__device__ __forceinline__ unsigned swz(unsigned row, unsigned chunk) {
  return row * 128u + ((chunk ^ (row & 7u)) << 4);
}

// ---- codes to bf16, exactly, two at a time ----------------------------------
__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t bf2_fma(uint32_t a, uint32_t b, uint32_t c) {
  __nv_bfloat162 r = __hfma2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b),
                             *reinterpret_cast<__nv_bfloat162*>(&c));
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hadd2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// The codes in field `f` of both int16 halves of `w`, as bf16x2 (low half
// first).  A nibble n (two's complement) with its sign bit flipped is
// n + 8 in 0..15; in the mantissa of 128.0 (bf16 0x4300) it makes 136 + n,
// and subtracting 136 leaves n.  An 8-bit code is 16 h + l (h its signed
// high nibble, l its unsigned low one): (136 + h) * 16 - 2176 = 16 h and
// (128 + l) - 128 = l, each exact in bf16, and so is their sum.
template <int BITS>
__device__ __forceinline__ uint32_t codes2(uint32_t w, int f) {
  const uint32_t x = w >> (BITS * f);
  if constexpr (BITS == 4) {
    return bf2_sub((x & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);        // - {136, 136}
  } else {
    const uint32_t lo = bf2_sub((x & 0x000F000Fu) | 0x43004300u, 0x43004300u);
    const uint32_t hi = bf2_fma(((x >> 4) & 0x000F000Fu) ^ 0x43084308u,
                                0x41804180u, 0xC508C508u);               // x 16 - 2176
    return bf2_add(hi, lo);
  }
}

// ---- wgmma ---------------------------------------------------------------------
// Descriptor of a K-major, 128-byte-swizzled operand at shared address
// `addr` (its atom 1,024-byte aligned; a k-step of 16 elements is 32 bytes
// into the atom): 8-row groups 1,024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64n64, f32) = [d +] A . B, A and B from shared memory (descriptors).
__device__ __forceinline__ void wgmma_64x64_ss(float (&d)[32], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64n128, f32) = [d +] A . B, A from registers (bf16 pairs in the
// mma.m16n8k16 A-fragment layout, a warp's 16 rows), B from shared memory.
__device__ __forceinline__ void wgmma_64x128_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// Scores of the CTA's 64 rows against tokens tok0 .. tok0 + 63, scaled.
// The accumulator layout (each warp 16 rows; lane = 4 gid + tig): s[4 nt +
// e] is row gid + 8 (e / 2) of the warp, token tok0 + 8 nt + 2 tig + e % 2.
__device__ __forceinline__ void sub_scores(unsigned sb, int tok0, float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t a = sw128_desc(sb + QK + (kk >> 2) * (BLOCK_ROWS * 128) + (kk & 3) * 32);
    const uint64_t b =
        sw128_desc(sb + KT + (kk >> 2) * (CHUNK * 128) + tok0 * 128 + (kk & 3) * 32);
    wgmma_64x64_ss(s, a, b, kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= SM_SCALE;
}

// The V codes of raw rows 8 ro .. 8 ro + 7, channel d (thread tid's items
// `it` of the chunk), as bf16 V^T rows: a field's 8 tokens to one 16-byte
// store at the channel's row.
template <int KB, int VB>
__device__ __forceinline__ void unpack_v(unsigned char* gb, int it, int tid) {
  constexpr int K_ROWS = ROWS_OF<KB>;
  constexpr int V_ROWS = ROWS_OF<VB>;
  const int i = it * THREADS + tid;
  const int ro = i >> 7;
  const int d = i & 127;
  const uint16_t* src =
      reinterpret_cast<const uint16_t*>(gb + RAW + (K_ROWS + 8 * ro) * 256) + d;
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (uint32_t)src[2 * k * D] | ((uint32_t)src[(2 * k + 1) * D] << 16);
#pragma unroll
  for (int f = 0; f < 16 / VB; ++f) {
    const int to = ro + (V_ROWS / 8) * f;        // the tokens' octet
    *reinterpret_cast<uint4*>(gb + VT + (to >> 3) * (D * 128) + swz(d, to & 7)) =
        make_uint4(codes2<VB>(w[0], f), codes2<VB>(w[1], f), codes2<VB>(w[2], f),
                   codes2<VB>(w[3], f));
  }
}

template <int KB, int VB>
__global__ void __launch_bounds__(THREADS, 1)
q_segment_kernel(const __nv_bfloat16* __restrict__ q,      // [B, T, Hq, D]
                 const int16_t* __restrict__ pool,         // [L, mc, BH, ROWS, D]
                 const __nv_bfloat16* __restrict__ scales, // [L, mc, BH, 2, D]
                 float* __restrict__ acc_out,              // [B, T, Hq, D]
                 float* __restrict__ m_out,                // [B, T, Hq]
                 float* __restrict__ l_out,                // [B, T, Hq]
                 int BH, int hkv, int G, int T, int max_chunks, int n_chunks, int li,
                 int seg_start, int window) {
  constexpr int K_ROWS = ROWS_OF<KB>;
  constexpr int V_ROWS = ROWS_OF<VB>;
  constexpr int ROWS = K_ROWS + V_ROWS;
  using L = Tail<ROWS>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned raw0 = smem::smem_addr(smem_raw);
  const unsigned sb = (raw0 + 1023u) & ~1023u;       // the layout's base
  unsigned char* gb = smem_raw + (sb - raw0);         // ... as a generic pointer
  const unsigned bar = sb + L::BAR;
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

  // (b, t, h*G + g) offset of query row r = t*G + g of this kv head
  auto row_off = [&](int r) -> size_t {
    const int t = r / G;
    return (size_t)(b * T + t) * Hq + h * G + (r - t * G);
  };
  auto issue = [&](int ci) {            // one thread: chunk ci's rows and scales
    const size_t slot = ((size_t)li * max_chunks + ci) * BH + bh;
    smem::mbar_expect_tx(bar, ROWS * D * 2 + 2 * D * 2);
    smem::bulk_copy(sb + RAW, pool + slot * ROWS * D, ROWS * D * 2, bar);
    smem::bulk_copy(sb + L::RSC, scales + slot * 2 * D, 2 * D * 2, bar);
  };

  // the sliding window: the chunks before c_first are dead for the CTA's
  // oldest row and so for all its rows; a chunk at or below lo_last (the
  // newest row's edge) holds a dead column for some row, masked per element
  // by the edges lo_a, lo_b of this thread's rows gid and gid + 8
  int c_first = 0, lo_last = -1, lo_a = -1, lo_b = -1;
  if (window > 0) {
    c_first = min(max(seg_start + row0 / G - window + 1, 0) / CHUNK, n_chunks);
    lo_last = seg_start + (min(row0 + BLOCK_ROWS, QR) - 1) / G - window;
    lo_a = seg_start + (row0 + 16 * warp + gid) / G - window;
    lo_b = seg_start + (row0 + 16 * warp + gid + 8) / G - window;
  }
  // scores s (sub_scores' layout) of tokens tok0 .. tok0 + 63 of chunk ci
  // at or below their row's edge set to -1e30
  auto mask_edge = [&](float(&s)[32], int ci, int tok0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = ci * CHUNK + tok0 + 8 * (i >> 2) + 2 * tig + (i & 1);
      if (col <= ((i & 2) ? lo_b : lo_a)) s[i] = NEG;
    }
  };

  if (tid == 0) {
    smem::mbar_init(bar, 1);
    smem::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0 && c_first < n_chunks) issue(c_first);

  // the CTA's q rows (zeros past QR), in the operand layout; thread tid
  // keeps the 16-byte chunk (tid % 16) of rows tid / 16 + 8 i, here and
  // when it forms bf16(q * kscale)
  const int c8 = tid & 15;
#pragma unroll
  for (int i = 0; i < BLOCK_ROWS / 8; ++i) {
    const int r = i * 8 + (tid >> 4);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < QR) v = *reinterpret_cast<const uint4*>(q + row_off(row0 + r) * D + 8 * c8);
    *reinterpret_cast<uint4*>(gb + QT + (c8 >> 3) * (BLOCK_ROWS * 128) + swz(r, c8 & 7)) = v;
  }

  float o[64];                       // acc: o[4 nt + e], row gid + 8 (e / 2), d = 8 nt + 2 tig + e % 2
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;   // rows gid, gid + 8

  for (int ci = c_first; ci < n_chunks; ++ci) {
    smem::mbar_wait(bar, (ci - c_first) & 1);
    const bool edge = ci * CHUNK <= lo_last;

    // ---- unpack the chunk: K [token][channel], V^T [channel][token] --------
    // K: 16 bytes (8 channels) of one row a thread, a field's 8 codes to one
    // 16-byte store at the token's row
#pragma unroll 2
    for (int i = tid; i < K_ROWS * 16; i += THREADS) {
      const int r = i >> 4;
      const int c = i & 15;
      const uint4 w = *reinterpret_cast<const uint4*>(gb + RAW + r * 256 + 16 * c);
#pragma unroll
      for (int f = 0; f < 16 / KB; ++f) {
        const int tok = r + K_ROWS * f;
        *reinterpret_cast<uint4*>(gb + KT + (c >> 3) * (CHUNK * 128) + swz(tok, c & 7)) =
            make_uint4(codes2<KB>(w.x, f), codes2<KB>(w.y, f), codes2<KB>(w.z, f),
                       codes2<KB>(w.w, f));
      }
    }
#pragma unroll 2
    for (int it = 0; it < V_ROWS * 16 / THREADS; ++it) unpack_v<KB, VB>(gb, it, tid);
    {
      const __nv_bfloat16* rsc = reinterpret_cast<const __nv_bfloat16*>(gb + L::RSC);
      reinterpret_cast<float*>(gb + L::KS)[tid] = __bfloat162float(rsc[tid]);
      reinterpret_cast<float*>(gb + L::VS)[tid] = __bfloat162float(rsc[D + tid]);
    }
    __syncthreads();                 // the raw rows are free; the scales are in
    if (tid == 0 && ci + 1 < n_chunks) {
      smem::fence_proxy_async();
      issue(ci + 1);                 // runs under this chunk's products
    }
    {                                // bf16(q * kscale)
      const float4* ksp = reinterpret_cast<const float4*>(gb + L::KS) + 2 * c8;
      const float4 ka = ksp[0];
      const float4 kb = ksp[1];
#pragma unroll
      for (int i = 0; i < BLOCK_ROWS / 8; ++i) {
        const int r = i * 8 + (tid >> 4);
        const unsigned off = (c8 >> 3) * (BLOCK_ROWS * 128) + swz(r, c8 & 7);
        const uint4 v = *reinterpret_cast<const uint4*>(gb + QT + off);
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&v);
        const float2 x0 = __bfloat1622float2(x[0]), x1 = __bfloat1622float2(x[1]);
        const float2 x2 = __bfloat1622float2(x[2]), x3 = __bfloat1622float2(x[3]);
        *reinterpret_cast<uint4*>(gb + QK + off) =
            make_uint4(pack_bf16(x0.x * ka.x, x0.y * ka.y), pack_bf16(x1.x * ka.z, x1.y * ka.w),
                       pack_bf16(x2.x * kb.x, x2.y * kb.y), pack_bf16(x3.x * kb.z, x3.y * kb.w));
      }
    }
    smem::fence_proxy_async();       // the tiles, written here, read by wgmma
    __syncthreads();

    // ---- pass 1: the chunk's row max ------------------------------------------
    float mx0 = NEG, mx1 = NEG;
#pragma unroll 1
    for (int tok0 = 0; tok0 < CHUNK; tok0 += SUB) {
      float s[32];
      sub_scores(sb, tok0, s);
      if (edge) mask_edge(s, ci, tok0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * nt], s[4 * nt + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));

    // ---- pass 2: bf16(p) . V codes, sub-tile by sub-tile ------------------------
    float pv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) pv[i] = 0.f;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll 1
    for (int tok0 = 0; tok0 < CHUNK; tok0 += SUB) {
      float s[32];
      sub_scores(sb, tok0, s);
      if (edge) mask_edge(s, ci, tok0);
      uint32_t p[16];                // bf16(p) pairs: p[2 nt] row gid, p[2 nt + 1] row gid + 8
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float e0 = expf(s[4 * nt] - mn0);
        const float e1 = expf(s[4 * nt + 1] - mn0);
        const float e2 = expf(s[4 * nt + 2] - mn1);
        const float e3 = expf(s[4 * nt + 3] - mn1);
        sum0 += e0 + e1;
        sum1 += e2 + e3;
        p[2 * nt] = pack_bf16(e0, e1);
        p[2 * nt + 1] = pack_bf16(e2, e3);
      }
      // tokens 16 j .. 16 j + 15 are score tiles 2 j and 2 j + 1: packed,
      // exactly the A fragment of the value product's k-step j
      fence_regs(pv);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < SUB / 16; ++j) {
        const int t = tok0 + 16 * j;
        wgmma_64x128_rs(pv, p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3],
                        sw128_desc(sb + VT + (t >> 6) * (D * 128) + ((t & 63) >> 4) * 32), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pv);
    }

    // ---- the online-softmax step ------------------------------------------------
    const float c0 = expf(m0 - mn0);
    const float c1 = expf(m1 - mn1);
    l0 = l0 * c0 + quad_sum(sum0);
    l1 = l1 * c1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
    const float* vs = reinterpret_cast<const float*>(gb + L::VS);
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const float2 v = *reinterpret_cast<const float2*>(vs + 8 * nt + 2 * tig);
      o[4 * nt] = o[4 * nt] * c0 + pv[4 * nt] * v.x;
      o[4 * nt + 1] = o[4 * nt + 1] * c0 + pv[4 * nt + 1] * v.y;
      o[4 * nt + 2] = o[4 * nt + 2] * c1 + pv[4 * nt + 2] * v.x;
      o[4 * nt + 3] = o[4 * nt + 3] * c1 + pv[4 * nt + 3] * v.y;
    }
    __syncthreads();                 // the tiles are free for the next chunk
  }

  // ---- unnormalised partials out --------------------------------------------
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 16 * warp + gid + 8 * half;
    if (r < QR) {
      const size_t off = row_off(r);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
        *reinterpret_cast<float2*>(acc_out + off * D + 8 * nt + 2 * tig) =
            make_float2(o[4 * nt + 2 * half], o[4 * nt + 2 * half + 1]);
      if (tig == 0) {
        m_out[off] = half ? m1 : m0;
        l_out[off] = half ? l1 : l0;
      }
    }
  }
}

template <int KB, int VB>
int launch(const void* q, const void* pool, const void* scales, void* acc, void* m,
           void* l, int BH, int hkv, int G, int T, int max_chunks, int n_chunks,
           int li, int seg_start, int window, int device, cudaStream_t stream) {
  const int smem = (int)Tail<ROWS_OF<KB> + ROWS_OF<VB>>::BYTES;
  const cudaError_t err =
      smem::allow_dynamic_smem<q_segment_kernel<KB, VB>>(smem, device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T * G + BLOCK_ROWS - 1) / BLOCK_ROWS, BH);
  q_segment_kernel<KB, VB><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int16_t*>(pool),
      static_cast<const __nv_bfloat16*>(scales), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), BH, hkv, G, T, max_chunks,
      n_chunks, li, seg_start, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, Hkv*G, 128] bf16; pool [L, mc, B*Hkv, ROWS, 128] int16 (ROWS =
// 256 * (kbits + vbits) / 16; (kbits, vbits) one of (8, 8), (8, 4), (4, 4));
// scales [L, mc, B*Hkv, 2, 128] bf16; acc [B, T, Hkv*G, 128] f32; m, l
// [B, T, Hkv*G, 1] f32.  All contiguous and 16-byte aligned; shapes checked
// by the caller.  `device` is the ordinal the tensors and the stream belong
// to; BH = B * hkv.  `seg_start` the segment's first position; `window`
// the sliding window, 0 for none.
extern "C" int q_segment_attention(const void* q, const void* pool, const void* scales,
                                   void* acc, void* m, void* l, int device, int kbits,
                                   int vbits, int BH, int hkv, int G, int T,
                                   int max_chunks, int n_chunks, int li, int seg_start,
                                   int window, void* stream) {
  if (hkv < 1 || BH % hkv || G < 1 || T < 1 || n_chunks < 0 ||
      n_chunks > max_chunks || li < 0 || seg_start < 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kbits == 8 && vbits == 8)
    return launch<8, 8>(q, pool, scales, acc, m, l, BH, hkv, G, T, max_chunks,
                        n_chunks, li, seg_start, window, device, s);
  if (kbits == 8 && vbits == 4)
    return launch<8, 4>(q, pool, scales, acc, m, l, BH, hkv, G, T, max_chunks,
                        n_chunks, li, seg_start, window, device, s);
  if (kbits == 4 && vbits == 4)
    return launch<4, 4>(q, pool, scales, acc, m, l, BH, hkv, G, T, max_chunks,
                        n_chunks, li, seg_start, window, device, s);
  return (int)cudaErrorInvalidValue;
}
