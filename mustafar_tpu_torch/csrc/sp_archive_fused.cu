// The archive's fused decode-attention generations v2 and v3 for Hopper
// (sm_90a), over split pools (ops/sparse_format.py encode_chunk): one
// kernel body over two pool layouts.
//
// sp_fused_v2 replaces the TPU kernel
// mustafar_tpu/ops/kernels/sparse_attention_archive.py
// fused_sparse_decode_attention (v2, Pallas body _fused_decode_kernel), whose
// pools are head-major: segments [B*Hkv, mc*R_i, 128], words
// [B*Hkv, mc*8, 128].  sp_fused_v3 replaces fused_sparse_decode_attention_v3
// (_fused_v3_kernel), the same function over chunk-major pools
// [mc, B*Hkv, R_i, 128] and [mc, B*Hkv, 8, 128].  For each (batch row b, kv
// head h) they attend the G = Hq / Hkv query heads of that kv head over
//   1. `n_chunks` chunks of 256 tokens, K and V expanded from value
//      segments (bf16) and 8 uint32 word planes (bitmap_expand.cuh):
//      scores = bf16(q) . K / sqrt(128) in f32;
//   2. the dense bf16 window [B, W, Hkv, 128], in ONE online-softmax step
//      over its columns, those at or past `win_len` at -1e30,
// p rounded to bf16 before the value product, out = acc / l.  A masked
// column adds exactly 0 once a live column has set the running max (p =
// exp(-1e30 - m) = 0, and no max moves), so the kernel leaves masked
// columns out, reading only `win_len` window rows, except with nothing to
// attend at all (n_chunks = win_len = 0): there every column's p is
// exp(0) = 1, as on the TPU, and the output is the mean of all W rows of V.
//
// What bounds it on this card: bytes.  Per call it must read
//   B*Hkv*(n_chunks*2*24,576 + 2*win_len*128*2) bytes (+ q, out)
// at sparsity 0.7 (keep 40 = 32 + 8: 80 value rows and 16 rows of words a
// stream and chunk).  At B=8, Hkv=8, one chunk and a 288-token window that
// is 12.7 MB, some 3.8 us at 3.35 TB/s; at B=32, three chunks and 132
// window tokens 55.6 MB, 16.6 us.  The products are a few flops a byte.
// As for the production kernel (sp_decode.cu), the expansion's
// instructions, one block per kv head and launch latency bound it first.
//
// Design (first, simple version), one block of 8 warps per (b, kv head):
//   v2: each chunk's pieces (K segments, K words, V segments, V words) are
//       loaded into shared memory in stream order with plain 16-byte loads,
//       then attended: the TPU's grid step per chunk becomes a loop in the
//       block, and a load waits for nothing but itself;
//   v3: the next chunk's pieces are in flight with cp.async while this one
//       is attended (two buffers), the Hopper form of v3's make_async_copy
//       pair over its chunk-major pools.
// Warps own token rows and expand them with warp ballots; a lane keeps its
// four channels of every head's accumulator, rescaled at each step, and
// the warps' accumulators are summed once at the end.  Split-K, wgmma and
// TMA are later work.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include "bitmap_expand.cuh"
#include "softmax_step.cuh"

namespace archive_fused {

using bitmap::CHUNK;
using bitmap::D;
using bitmap::Fmt;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NR = bitmap::ROWS_IN_FLIGHT;
constexpr float NEG = -1e30f;
constexpr float SM_SCALE = 0.08838834764831845f;   // 1 / sqrt(128)
constexpr size_t SMEM_MAX = 232448;                 // a block's shared memory

// The scores of one softmax step, `ns` columns a head, as softmax_step
// (softmax_step.cuh) indexes them: s[g][t].
struct Rows {
  float* p;
  int ns;
  __device__ float* operator[](int g) const { return p + (size_t)g * ns; }
};

struct Smem {
  Rows s;
  float* m;
  float* l;
  float* corr;
};

// Bytes of the scores [G][ns], the warps' sums [G][D] and m, l, corr,
// rounded to 16; the stage buffers follow.
__host__ __device__ inline size_t head_bytes(int G, int ns) {
  return ((size_t)G * ns * 4 + (size_t)G * D * 4 + 3 * (size_t)G * 4 + 15) / 16 * 16;
}

template <int G, bool CHUNK_MAJOR>
__global__ void __launch_bounds__(THREADS)
fused_kernel(const __nv_bfloat16* __restrict__ q,       // [B*Hkv, G, D]
             const int16_t* __restrict__ ks0, const int16_t* __restrict__ ks1,
             const uint32_t* __restrict__ kb,
             const int16_t* __restrict__ vs0, const int16_t* __restrict__ vs1,
             const uint32_t* __restrict__ vb,
             const __nv_bfloat16* __restrict__ k_win,   // [B, W, Hkv, D]
             const __nv_bfloat16* __restrict__ v_win,
             void* __restrict__ out,                    // [B*Hkv, G, D]
             int out_f32, int BH, int Hkv, int mc, int W, int n_chunks, int win_len,
             int ns, Fmt<16> kf, Fmt<16> vf) {
  static_assert(G <= WARPS, "one warp per query head in the softmax step");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw);
  Smem sm{Rows{base, ns}, base + (size_t)G * ns + G * D, nullptr, nullptr};
  sm.l = sm.m + G;
  sm.corr = sm.l + G;
  float (*red)[D] = reinterpret_cast<float (*)[D]>(base + (size_t)G * ns);
  int16_t* stage = reinterpret_cast<int16_t*>(smem_raw + head_bytes(G, ns));
  const size_t rows = (size_t)kf.rows() + vf.rows();
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float qr[G][4];                // bf16 q of this lane's four channels
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qr[g][i] = __bfloat162float(q[((size_t)bh * G + g) * D + lane + 32 * i]);
  if (tid < G) {
    sm.m[tid] = NEG;
    sm.l[tid] = 0.f;
  }
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  __syncthreads();

  auto score_row = [&](const float (&v)[4], int t) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s += qr[g][i] * v[i];
      s = online_softmax::warp_sum(s);
      if (lane == 0) sm.s[g][t] = s * SM_SCALE;
    }
  };
  auto rescale_add = [&](const float (&pv)[G][4]) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = acc[g][i] * sm.corr[g] + pv[g][i];
  };
  // chunk ci of both streams into `dst`: K pieces, then V pieces
  auto fetch = [&](int16_t* dst, int ci) {
    const size_t piece = CHUNK_MAJOR ? (size_t)ci * BH + bh : (size_t)bh * mc + ci;
    bitmap::stage_split<CHUNK_MAJOR>(dst, ks0, ks1, kb, kf, piece, tid, THREADS);
    bitmap::stage_split<CHUNK_MAJOR>(dst + (size_t)kf.rows() * D, vs0, vs1, vb, vf, piece,
                                     tid, THREADS);
    if (CHUNK_MAJOR) bitmap::cp_async_commit();
  };

  // ---- pool chunks ----------------------------------------------------------
  if (CHUNK_MAJOR && n_chunks > 0) fetch(stage, 0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int16_t* kst = stage;
    if (CHUNK_MAJOR) {
      if (ci + 1 < n_chunks) {
        fetch(stage + ((ci + 1) & 1) * rows * D, ci + 1);
        bitmap::cp_async_wait<1>();
      } else {
        bitmap::cp_async_wait<0>();
      }
      kst = stage + (ci & 1) * rows * D;
    } else {
      fetch(stage, ci);
    }
    __syncthreads();   // chunk ci is in shared memory for every thread
    const int16_t* vst = kst + (size_t)kf.rows() * D;
    for (int t0 = warp; t0 < CHUNK; t0 += NR * WARPS) {
      float v[NR][4];
#pragma unroll
      for (int j = 0; j < NR; ++j) bitmap::expand_row<16, 32>(kst, kf, t0 + j * WARPS, lane, v[j]);
#pragma unroll
      for (int j = 0; j < NR; ++j) score_row(v[j], t0 + j * WARPS);
    }
    __syncthreads();
    online_softmax::softmax_step<G>(sm, CHUNK, warp, lane);

    float pv[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g) pv[g][0] = pv[g][1] = pv[g][2] = pv[g][3] = 0.f;
    for (int t0 = warp; t0 < CHUNK; t0 += NR * WARPS) {
      float v[NR][4];
#pragma unroll
      for (int j = 0; j < NR; ++j) bitmap::expand_row<16, 32>(vst, vf, t0 + j * WARPS, lane, v[j]);
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = sm.s[g][t0 + j * WARPS];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[g][i] += p * v[j][i];
        }
    }
    rescale_add(pv);
    __syncthreads();   // the next step overwrites sm.s, sm.corr and this buffer
  }

  // ---- the window, one step -------------------------------------------------
  const int wn = (n_chunks == 0 && win_len == 0) ? W : win_len;
  const size_t b = bh / Hkv, h = bh % Hkv;
  auto win_row = [&](const __nv_bfloat16* win, int t) {
    return win + ((b * W + t) * Hkv + h) * D;
  };
  if (wn > 0) {
    for (int t = warp; t < wn; t += WARPS) {
      if (t < win_len) {
        const __nv_bfloat16* kr = win_row(k_win, t);
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(kr[lane + 32 * i]);
        score_row(v, t);
      } else if (lane == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) sm.s[g][t] = NEG;
      }
    }
    __syncthreads();
    online_softmax::softmax_step<G>(sm, wn, warp, lane);

    float pv[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g) pv[g][0] = pv[g][1] = pv[g][2] = pv[g][3] = 0.f;
    for (int t = warp; t < wn; t += WARPS) {
      const __nv_bfloat16* vr = win_row(v_win, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = __bfloat162float(vr[lane + 32 * i]);
#pragma unroll
        for (int g = 0; g < G; ++g) pv[g][i] += sm.s[g][t] * v;
      }
    }
    rescale_add(pv);
    __syncthreads();
  }

  // ---- sum the warps' accumulators and normalise ------------------------------
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[g][lane + 32 * i] = (w ? red[g][lane + 32 * i] : 0.f) + acc[g][i];
    }
    __syncthreads();
  }
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    const float o = red[g][i % D] / sm.l[g];
    const size_t at = (size_t)bh * G * D + i;
    if (out_f32)
      static_cast<float*>(out)[at] = o;
    else
      static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(o);
  }
}

// Checks the launch, sizes shared memory and launches the instance for G.
template <bool CHUNK_MAJOR>
int launch(const void* q, const void* ks0, const void* ks1, const void* kb,
           const void* vs0, const void* vs1, const void* vb, const void* k_win,
           const void* v_win, void* out, int out_f32, int device, int B, int Hkv, int G,
           int mc, int W, int n_chunks, int win_len, int k0, int k1, int vk0, int vk1,
           void* stream) {
  bool k_ok, v_ok;
  const Fmt<16> kf = bitmap::make_fmt<16>(k0, k1, &k_ok);
  const Fmt<16> vf = bitmap::make_fmt<16>(vk0, vk1, &v_ok);
  if (!k_ok || !v_ok || B < 1 || Hkv < 1 || mc < 1 || W < 1 || n_chunks < 0 ||
      n_chunks > mc || win_len < 0 || win_len > W || (k1 > 0) != (ks1 != nullptr) ||
      (vk1 > 0) != (vs1 != nullptr))
    return (int)cudaErrorInvalidValue;
  const int ns = ((W > CHUNK ? W : CHUNK) + 3) / 4 * 4;
  const size_t nbuf = CHUNK_MAJOR ? 2 : 1;
  const size_t smem = head_bytes(G, ns) + nbuf * ((size_t)kf.rows() + vf.rows()) * D * 2;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;   // a window too long
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * Hkv;
#define FUSED_LAUNCH(g)                                                               \
  {                                                                                   \
    err = cudaFuncSetAttribute(fused_kernel<g, CHUNK_MAJOR>,                          \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
    if (err != cudaSuccess) return (int)err;                                          \
    fused_kernel<g, CHUNK_MAJOR><<<BH, THREADS, smem, s>>>(                           \
        static_cast<const __nv_bfloat16*>(q), static_cast<const int16_t*>(ks0),       \
        static_cast<const int16_t*>(ks1), static_cast<const uint32_t*>(kb),           \
        static_cast<const int16_t*>(vs0), static_cast<const int16_t*>(vs1),           \
        static_cast<const uint32_t*>(vb), static_cast<const __nv_bfloat16*>(k_win),   \
        static_cast<const __nv_bfloat16*>(v_win), out, out_f32, BH, Hkv, mc, W,       \
        n_chunks, win_len, ns, kf, vf);                                               \
  }
  switch (G) {
    case 1: FUSED_LAUNCH(1); break;
    case 2: FUSED_LAUNCH(2); break;
    case 4: FUSED_LAUNCH(4); break;
    case 8: FUSED_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FUSED_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace archive_fused

// q [B, 1, Hkv*G, 128] bf16; the K and V pools' segments (bf16; the second
// null when that stream has one segment) and words (uint32), head-major;
// k_win / v_win [B, W, Hkv, 128] bf16; out [B, 1, Hkv*G, 128], f32 if
// `out_f32`, else bf16.  All contiguous and 16-byte aligned; shapes checked
// by the caller.  (k0, k1) and (vk0, vk1) are the streams' segment widths.
// A window whose scores do not fit in shared memory beside the chunk
// buffers (W past some 1,500 at G=8) is refused (cudaErrorInvalidValue).
extern "C" int sp_fused_v2(const void* q, const void* ks0, const void* ks1, const void* kb,
                           const void* vs0, const void* vs1, const void* vb,
                           const void* k_win, const void* v_win, void* out, int out_f32,
                           int device, int B, int Hkv, int G, int mc, int W, int n_chunks,
                           int win_len, int k0, int k1, int vk0, int vk1, void* stream) {
  return archive_fused::launch<false>(q, ks0, ks1, kb, vs0, vs1, vb, k_win, v_win, out,
                                      out_f32, device, B, Hkv, G, mc, W, n_chunks, win_len,
                                      k0, k1, vk0, vk1, stream);
}

// As sp_fused_v2, over chunk-major pools.
extern "C" int sp_fused_v3(const void* q, const void* ks0, const void* ks1, const void* kb,
                           const void* vs0, const void* vs1, const void* vb,
                           const void* k_win, const void* v_win, void* out, int out_f32,
                           int device, int B, int Hkv, int G, int mc, int W, int n_chunks,
                           int win_len, int k0, int k1, int vk0, int vk1, void* stream) {
  return archive_fused::launch<true>(q, ks0, ks1, kb, vs0, vs1, vb, k_win, v_win, out,
                                     out_f32, device, B, Hkv, G, mc, W, n_chunks, win_len,
                                     k0, k1, vk0, vk1, stream);
}
