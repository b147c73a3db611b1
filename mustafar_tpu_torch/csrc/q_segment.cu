// Quant-codec segment attention for Hopper (sm_90a): the chunked-prefill
// partials of one segment of query rows over the packed pools.
//
// Replaces the TPU kernel mustafar_tpu/ops/kernels/quant_attention.py
// fused_q_segment_attention (Pallas body _q_seg_kernel) for the codecs q8,
// q8q4 and q4q4, without its sliding-window option.  For one layer `li` of the stacked
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
// Design (first, simple version): the TPU runs one program per (b, kv
// head) over all QR rows; at B=1 that is 8 programs, so here the rows are
// cut into tiles of 64 (grid: row tiles x B*Hkv, 128 blocks at B=1,
// Hkv=8, T=256, G=4), with nothing carried between blocks.  A block of 4
// warps loads each chunk's int16 rows (64 / 48 / 32 KB at q8 / q8q4 /
// q4q4) and scales into shared
// memory, forms bf16(q * kscale) for its 64 rows, and each warp owns 16
// rows: the 16 x 256 scores with mma.sync m16n8k16 (bf16 in, f32 out) from
// K codes unpacked in registers, the online softmax on the accumulator
// fragments (a row's four lanes reduce with shuffles), and p, packed to
// bf16 pairs in registers, as the A operand of the value product, V codes
// unpacked in registers too.  Dequantised chunks never exist in memory.
// Double-buffered loads (cp.async or TMA), wgmma and a persistent grid are
// later work; the unpacking in registers costs more instructions than the
// products.  One source, templated on (KB, VB): three instances, each with
// its own shared-memory size.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int D = 128;                  // head_dim == lane width
constexpr int CHUNK = 256;              // tokens per packed chunk
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCK_ROWS = 16 * WARPS;  // query rows per block, 16 per warp
constexpr int LD = D + 8;               // padded shared row: no bank conflicts
constexpr float NEG = -1e30f;
constexpr float SM_SCALE = 0.08838834764831845f;   // 1 / sqrt(128)

// A chunk at BITS bits a code: 16 / BITS tokens per int16 carrier, so
// CHUNK * BITS / 16 rows; token t lies in row t % ROWS, field t / ROWS.
template <int BITS>
constexpr int ROWS_OF = CHUNK * BITS / 16;

template <int KB, int VB>
struct __align__(16) Smem {
  int16_t rows[ROWS_OF<KB> + ROWS_OF<VB>][LD];   // K rows, then V rows
  __nv_bfloat16 q[BLOCK_ROWS][LD];      // the block's query rows (bf16)
  __nv_bfloat16 qk[BLOCK_ROWS][LD];     // bf16(q * kscale) for this chunk
  float ks[D];
  float vs[D];
};

// Two K codes of one token, channels d and d+1, from the int16 pair `w` of
// its row: field `f` of each half, as bf16 (exact).
template <int KB>
__device__ __forceinline__ uint32_t k_pair(uint32_t w, int f) {
  const int lo = (int)((w & 0xffffu) << (32 - KB * (f + 1))) >> (32 - KB);
  const int hi = (int)(w << (16 - KB * (f + 1))) >> (32 - KB);
  return pack_bf16((float)lo, (float)hi);
}

// The V code in field `f` of the int16 carrier `x` (sign-extended).
template <int VB>
__device__ __forceinline__ float v_code(int16_t x, int f) {
  const uint32_t w = (uint32_t)(int)x;
  return (float)((int)(w << (32 - VB * (f + 1))) >> (32 - VB));
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * gid + tig): A holds rows gid
// and gid + 8, columns 2 tig (+1) and 2 tig + 8 (+1); B column gid, rows
// 2 tig (+1) and 2 tig + 8 (+1); the f32 accumulator rows gid (c0, c1) and
// gid + 8 (c2, c3), columns 2 tig and 2 tig + 1.  The score accumulators of
// tokens 16 j .. 16 j + 15 are therefore, packed to bf16 pairs, exactly the
// A fragment of the value product's k-step j.
template <int KB, int VB>
__global__ void __launch_bounds__(THREADS)
q_segment_kernel(const __nv_bfloat16* __restrict__ q,      // [B, T, Hq, D]
                    const int16_t* __restrict__ pool,         // [L, mc, BH, ROWS, D]
                    const __nv_bfloat16* __restrict__ scales, // [L, mc, BH, 2, D]
                    float* __restrict__ acc_out,              // [B, T, Hq, D]
                    float* __restrict__ m_out,                // [B, T, Hq]
                    float* __restrict__ l_out,                // [B, T, Hq]
                    int BH, int hkv, int G, int T, int max_chunks,
                    int n_chunks, int li) {
  constexpr int K_ROWS = ROWS_OF<KB>;
  constexpr int V_ROWS = ROWS_OF<VB>;
  constexpr int ROWS = K_ROWS + V_ROWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<KB, VB>& sm = *reinterpret_cast<Smem<KB, VB>*>(smem_raw);
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

  for (int i = tid; i < BLOCK_ROWS * (D / 8); i += THREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < QR)
      v = *reinterpret_cast<const uint4*>(q + row_off(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(&sm.q[r][c]) = v;
  }

  float o[16][4];                    // acc, d = 8 nt + 2 tig (+1)
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;   // rows gid, gid + 8

  for (int ci = 0; ci < n_chunks; ++ci) {
    const size_t slot = ((size_t)li * max_chunks + ci) * BH + bh;
    const int16_t* rows = pool + slot * ROWS * D;
    const __nv_bfloat16* sc = scales + slot * 2 * D;
    __syncthreads();                 // the last chunk's readers are done
    for (int i = tid; i < ROWS * (D / 8); i += THREADS) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(&sm.rows[r][c]) =
          *reinterpret_cast<const uint4*>(rows + (size_t)r * D + c);
    }
    for (int i = tid; i < 2 * D; i += THREADS) {
      const float v = __bfloat162float(sc[i]);
      if (i < D)
        sm.ks[i] = v;
      else
        sm.vs[i - D] = v;
    }
    __syncthreads();
    for (int i = tid; i < BLOCK_ROWS * D; i += THREADS) {
      const int r = i / D;
      const int d = i % D;
      sm.qk[r][d] = __float2bfloat16(__bfloat162float(sm.q[r][d]) * sm.ks[d]);
    }
    __syncthreads();

    // ---- scores: 16 rows x 256 tokens, 32 tiles of 8 tokens ----------------
    float s[32][4];
#pragma unroll
    for (int nt = 0; nt < 32; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int k0 = 16 * kk + 2 * tig;
      const uint32_t a0 = ld32(&sm.qk[wr + gid][k0]);
      const uint32_t a1 = ld32(&sm.qk[wr + gid + 8][k0]);
      const uint32_t a2 = ld32(&sm.qk[wr + gid][k0 + 8]);
      const uint32_t a3 = ld32(&sm.qk[wr + gid + 8][k0 + 8]);
#pragma unroll
      for (int nt = 0; nt < 32; ++nt) {
        const int tok = 8 * nt + gid;                 // this lane's B column
        const int16_t* kr = &sm.rows[tok % K_ROWS][0];
        const int f = nt / (K_ROWS / 8);              // tok / K_ROWS: its field
        mma_bf16(s[nt], a0, a1, a2, a3, k_pair<KB>(ld32(kr + k0), f),
                 k_pair<KB>(ld32(kr + k0 + 8), f));
      }
    }

    // ---- online softmax step over the chunk --------------------------------
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int nt = 0; nt < 32; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= SM_SCALE;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t p[32][2];               // bf16(p) pairs: row gid, row gid + 8
#pragma unroll
    for (int nt = 0; nt < 32; ++nt) {
      const float e0 = expf(s[nt][0] - mn0);
      const float e1 = expf(s[nt][1] - mn0);
      const float e2 = expf(s[nt][2] - mn1);
      const float e3 = expf(s[nt][3] - mn1);
      sum0 += e0 + e1;
      sum1 += e2 + e3;
      p[nt][0] = pack_bf16(e0, e1);
      p[nt][1] = pack_bf16(e2, e3);
    }
    const float c0 = expf(m0 - mn0);
    const float c1 = expf(m1 - mn1);
    l0 = l0 * c0 + quad_sum(sum0);
    l1 = l1 * c1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;

    // ---- values: bf16(p) . V codes, then the V scale, two halves of d ------
#pragma unroll
    for (int dh = 0; dh < 2; ++dh) {
      float pv[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) pv[nt][0] = pv[nt][1] = pv[nt][2] = pv[nt][3] = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {                  // tokens 16 j .. 16 j + 15
        constexpr int JR = V_ROWS / 16;               // 16-token groups a field
        const int f = j / JR;                         // token / V_ROWS
        const int t0 = K_ROWS + 16 * (j % JR) + 2 * tig;  // V row of token 16 j + 2 tig
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int d = 64 * dh + 8 * nt + gid;
          const uint32_t b0 = pack_bf16(v_code<VB>(sm.rows[t0][d], f),
                                        v_code<VB>(sm.rows[t0 + 1][d], f));
          const uint32_t b1 = pack_bf16(v_code<VB>(sm.rows[t0 + 8][d], f),
                                        v_code<VB>(sm.rows[t0 + 9][d], f));
          mma_bf16(pv[nt], p[2 * j][0], p[2 * j][1], p[2 * j + 1][0],
                   p[2 * j + 1][1], b0, b1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int d = 64 * dh + 8 * nt + 2 * tig;
        const float vs0 = sm.vs[d];
        const float vs1 = sm.vs[d + 1];
        const int on = 8 * dh + nt;
        o[on][0] = o[on][0] * c0 + pv[nt][0] * vs0;
        o[on][1] = o[on][1] * c0 + pv[nt][1] * vs1;
        o[on][2] = o[on][2] * c1 + pv[nt][2] * vs0;
        o[on][3] = o[on][3] * c1 + pv[nt][3] * vs1;
      }
    }
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

template <int KB, int VB>
int launch(const void* q, const void* pool, const void* scales, void* acc, void* m,
           void* l, int BH, int hkv, int G, int T, int max_chunks, int n_chunks,
           int li, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<KB, VB>);
  const cudaError_t err = cudaFuncSetAttribute(
      q_segment_kernel<KB, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T * G + BLOCK_ROWS - 1) / BLOCK_ROWS, BH);
  q_segment_kernel<KB, VB><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int16_t*>(pool),
      static_cast<const __nv_bfloat16*>(scales), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), BH, hkv, G, T, max_chunks,
      n_chunks, li);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, Hkv*G, 128] bf16; pool [L, mc, B*Hkv, ROWS, 128] int16 (ROWS =
// 256 * (kbits + vbits) / 16; (kbits, vbits) one of (8, 8), (8, 4), (4, 4));
// scales [L, mc, B*Hkv, 2, 128] bf16; acc [B, T, Hkv*G, 128] f32; m, l
// [B, T, Hkv*G, 1] f32.  All contiguous and 16-byte aligned; shapes checked
// by the caller.  `device` is the ordinal the tensors and the stream belong
// to; BH = B * hkv.
extern "C" int q_segment_attention(const void* q, const void* pool, const void* scales,
                                   void* acc, void* m, void* l, int device, int kbits,
                                   int vbits, int BH, int hkv, int G, int T,
                                   int max_chunks, int n_chunks, int li, void* stream) {
  if (hkv < 1 || BH % hkv || G < 1 || T < 1 || n_chunks < 0 ||
      n_chunks > max_chunks || li < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kbits == 8 && vbits == 8)
    return launch<8, 8>(q, pool, scales, acc, m, l, BH, hkv, G, T, max_chunks,
                        n_chunks, li, s);
  if (kbits == 8 && vbits == 4)
    return launch<8, 4>(q, pool, scales, acc, m, l, BH, hkv, G, T, max_chunks,
                        n_chunks, li, s);
  if (kbits == 4 && vbits == 4)
    return launch<4, 4>(q, pool, scales, acc, m, l, BH, hkv, G, T, max_chunks,
                        n_chunks, li, s);
  return (int)cudaErrorInvalidValue;
}
