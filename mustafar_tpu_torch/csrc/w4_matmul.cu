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
// Design (first, simple version):
//   * tensor cores with f32 accumulators: mma.sync m16n8k16 bf16
//     (mma_bf16.cuh), out channels as M and tokens as N.  Any order of the
//     16 k's of one product gives the same sum, so a thread's four A
//     values of a row are the four nibbles of ONE carrier (k positions
//     2q, 2q+1, 2q+8, 2q+9 of lane q in its quad take nibbles 0-3 of
//     carrier row r0 + q), and the B fragment reads x at the four matching
//     in-rows.  M rows g and g+8 of a lane are two neighbouring out
//     channels, so one 32-bit load gives both; a lane loads 16 bytes (eight
//     channels, four M tiles of 16) per carrier row, and a warp's load is
//     four rows of 128 contiguous bytes;
//   * a nibble becomes bf16 in registers without converting through f32:
//     (nibble ^ 8) is placed in the mantissa of 128.0 (bf16 0x4300), and one
//     bf16x2 subtract of 136 leaves the code, exactly.  No dequantized
//     weight exists anywhere;
//   * the scale multiplies a block's partial (16 tokens x 64 channels per
//     warp at most 32 tokens), then adds to the warp's running total;
//   * a CUDA block is 4 warps on the same 64 out channels and 8, 16 or 32
//     tokens, each warp on its own 128-row scale blocks; x for the four
//     blocks of a round is staged in shared memory.  DIN is cut across
//     CUDA blocks so that some 2,048 warps cover the product (DOUT 1,024
//     alone would give 16); the 4 warps' totals are summed in shared
//     memory, and with more than one CUDA block along DIN, each writes f32
//     partials that a second kernel sums in order and rounds.
// TMA, wgmma, a persistent split-K with a fused reduction and CUDA graphs
// are later work.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace w4 {

constexpr int BLOCK = 128;           // in-rows per scale
constexpr int CROWS = BLOCK / 4;     // carrier rows per scale block
constexpr int KSTEPS = CROWS / 4;    // mma k-steps per block (4 carrier rows each)
constexpr int COLS = 64;             // out channels per CUDA block
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int XK = WARPS * BLOCK;    // in-rows of x staged per round
constexpr int XSTRIDE = XK + 8;      // padded row: quads of a warp hit other banks
constexpr uint32_t MANT128 = 0x43004300u;   // bf16x2 {128, 128}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// bf16x2 {u0 - 8, u1 - 8} from bits = 0x43004300 | u0 | u1 << 16, u in 0..15.
__device__ __forceinline__ uint32_t codes2(uint32_t bits) {
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&bits);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16_pair(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  const uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

template <int NT>   // n tiles of 8 tokens
__global__ void __launch_bounds__(THREADS)
w4_matmul_kernel(const __nv_bfloat16* __restrict__ x,       // [T, din]
                 const int16_t* __restrict__ carriers,      // [din / 4, dout]
                 const __nv_bfloat16* __restrict__ scales,  // [din / 128, dout]
                 void* __restrict__ out,                    // [T, dout]
                 float* __restrict__ ws,                    // [nsc, T, dout] or unused
                 int out_f32, int T, int din, int dout, int bpw) {
  constexpr int TOK = 8 * NT;
  constexpr int XS_BYTES = TOK * XSTRIDE * 2;
  constexpr int RED_BYTES = WARPS * TOK * COLS * 4;
  __shared__ __align__(16) unsigned char smem[XS_BYTES > RED_BYTES ? XS_BYTES : RED_BYTES];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);   // [TOK][XSTRIDE]
  float* red = reinterpret_cast<float*>(smem);                  // [WARPS][TOK][COLS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;    // mma group: M rows g, g + 8; N column (token) g
  const int q = lane & 3;     // lane in its quad
  const int col0 = blockIdx.x * COLS;
  const int tok0 = blockIdx.z * TOK;
  const int nb = din / BLOCK;
  const int blk0 = blockIdx.y * WARPS * bpw;

  float total[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[i][n][e] = 0.f;

  for (int it = 0; it < bpw; ++it) {
    const int rb = blk0 + it * WARPS;   // the round's first block (uniform)
    if (rb >= nb) break;
    const int b = rb + warp;            // this warp's block
    const bool live = b < nb;

    // this lane's carriers of block b: rows b*32 + 4 ks + q, channels
    // col0 + 8 g .. + 7, and the block's scales of the same channels
    uint4 cw[KSTEPS];
    uint4 sc = make_uint4(0, 0, 0, 0);
    if (live) {
      const int16_t* cb = carriers + ((size_t)b * CROWS + q) * dout + col0 + 8 * g;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        cw[ks] = __ldg(reinterpret_cast<const uint4*>(cb + (size_t)4 * ks * dout));
      sc = __ldg(reinterpret_cast<const uint4*>(scales + (size_t)b * dout + col0 + 8 * g));
    }

    // stage x[tok0 .. + TOK, rb * 128 .. + XK]: zeros past T and past din
    __syncthreads();                    // the last round's reads of xs are done
    for (int idx = tid; idx < TOK * (XK / 8); idx += THREADS) {
      const int t = idx / (XK / 8);
      const int c8 = idx % (XK / 8);
      const int k = rb * BLOCK + 8 * c8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (tok0 + t < T && k < din)
        v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(tok0 + t) * din + k));
      *reinterpret_cast<uint4*>(xs + t * XSTRIDE + 8 * c8) = v;
    }
    __syncthreads();
    if (!live) continue;

    float part[4][NT][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][n][e] = 0.f;

    const __nv_bfloat16* xw = xs + warp * BLOCK + q;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      // B: token n*8 + g at in-rows 32 j + 4 ks + q of the block (j = 0..3)
      uint32_t bfr[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* xr = xw + (n * 8 + g) * XSTRIDE + 4 * ks;
        bfr[n][0] = bf16_pair(xr, xr + 32);
        bfr[n][1] = bf16_pair(xr + 64, xr + 96);
      }
      const uint32_t words[4] = {cw[ks].x, cw[ks].y, cw[ks].z, cw[ks].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // word i: channel 8g + 2i in the low half (M row g), 8g + 2i + 1 in
        // the high half (M row g + 8); flipping each nibble's sign bit
        // makes it code + 8, unsigned
        const uint32_t w = words[i] ^ 0x88888888u;
        const uint32_t a0 = codes2(MANT128 | (w & 0xfu) | ((w & 0xf0u) << 12));
        const uint32_t a1 = codes2(MANT128 | ((w >> 16) & 0xfu) | ((w >> 4) & 0xf0000u));
        const uint32_t a2 = codes2(MANT128 | ((w >> 8) & 0xfu) | ((w & 0xf000u) << 4));
        const uint32_t a3 = codes2(MANT128 | ((w >> 24) & 0xfu) | ((w >> 12) & 0xf0000u));
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma_bf16(part[i][n], a0, a1, a2, a3, bfr[n][0], bfr[n][1]);
      }
    }
    const uint32_t sw[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s_lo = bf16_lo(sw[i]);   // channel 8g + 2i
      const float s_hi = bf16_hi(sw[i]);   // channel 8g + 2i + 1
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        total[i][n][0] += __fmul_rn(part[i][n][0], s_lo);
        total[i][n][1] += __fmul_rn(part[i][n][1], s_lo);
        total[i][n][2] += __fmul_rn(part[i][n][2], s_hi);
        total[i][n][3] += __fmul_rn(part[i][n][3], s_hi);
      }
    }
  }

  // sum the four warps' totals; accumulator e of M row g (h = 0) or g + 8
  // (h = 1) holds token n*8 + 2q + (e & 1) of channel 8g + 2i + h
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = n * 8 + 2 * q + (e & 1);
        red[(warp * TOK + t) * COLS + 8 * g + 2 * i + (e >> 1)] = total[i][n][e];
      }
  __syncthreads();
  for (int idx = tid; idx < TOK * COLS; idx += THREADS) {
    const int t = idx / COLS;
    const int c = idx % COLS;
    if (tok0 + t >= T) continue;
    float v = red[t * COLS + c];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += red[(w * TOK + t) * COLS + c];
    const size_t at = (size_t)(tok0 + t) * dout + col0 + c;
    if (gridDim.y > 1)
      ws[(size_t)blockIdx.y * T * dout + at] = v;
    else if (out_f32)
      static_cast<float*>(out)[at] = v;
    else
      static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(v);
  }
}

// out = the sum over the nsc CUDA blocks' partials along DIN, in order.
__global__ void w4_reduce_kernel(const float* __restrict__ ws, void* __restrict__ out,
                                 int out_f32, int nsc, size_t n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float v = ws[idx];
  for (int s = 1; s < nsc; ++s) v += ws[(size_t)s * n + idx];
  if (out_f32)
    static_cast<float*>(out)[idx] = v;
  else
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16(v);
}

template <int NT>
void launch(const void* x, const void* carriers, const void* scales, void* out,
            float* ws, int out_f32, int T, int din, int dout, int bpw, int nsc,
            cudaStream_t stream) {
  const dim3 grid(dout / COLS, nsc, (T + 8 * NT - 1) / (8 * NT));
  w4_matmul_kernel<NT><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int16_t*>(carriers),
      static_cast<const __nv_bfloat16*>(scales), out, ws, out_f32, T, din, dout, bpw);
}

}  // namespace w4

// x [T, din] bf16; carriers [din/4, dout] int16; scales [din/128, dout] bf16;
// out [T, dout] f32 if `out_f32`, else bf16; ws [nsc, T, dout] f32 when
// nsc > 1.  All contiguous and 16-byte aligned; shapes checked by the
// caller.  `bpw` scale blocks per warp and `nsc` CUDA blocks along din, as
// w4_matmul.split computes them (nsc = ceil(din / 128 / (4 bpw))).
extern "C" int w4_matmul(const void* x, const void* carriers, const void* scales,
                         void* out, void* ws, int out_f32, int device, int T,
                         int din, int dout, int bpw, int nsc, void* stream) {
  using namespace w4;
  const int nb = din / BLOCK;
  if (T < 1 || T > 128 || din % BLOCK || dout % BLOCK || bpw < 1 ||
      nsc != (nb + WARPS * bpw - 1) / (WARPS * bpw))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  if (T <= 8)
    launch<1>(x, carriers, scales, out, wsf, out_f32, T, din, dout, bpw, nsc, s);
  else if (T <= 16)
    launch<2>(x, carriers, scales, out, wsf, out_f32, T, din, dout, bpw, nsc, s);
  else
    launch<4>(x, carriers, scales, out, wsf, out_f32, T, din, dout, bpw, nsc, s);
  if (nsc > 1) {
    const size_t n = (size_t)T * dout;
    w4_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(wsf, out, out_f32, nsc, n);
  }
  return (int)cudaGetLastError();
}
