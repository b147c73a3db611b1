// The fused body of the archive's decode generations v4 and v6
// (sp_archive_stream.cu): one kernel over the fused stream pool, templated
// on what it returns.
//
// For each (batch row b, kv head h) one block of 8 warps attends the G =
// Hq / Hkv query heads of that kv head over
//   1. `n_chunks` chunks of 256 tokens, K and V expanded from value segments
//      (bf16) and bitmap word planes (bitmap_expand.cuh): scores = bf16(q) .
//      K / sqrt(128) in f32, one online-softmax step a chunk;
//   2. unless PARTIALS, the dense bf16 window [B, W, Hkv, 128], in ONE
//      online-softmax step over its columns, those at or past `win_len` at
//      -1e30,
// p rounded to bf16 before the value product.  It writes out = acc / l or,
// with PARTIALS (v6), the unnormalised acc [B*Hkv, G, 128] f32 and m, l
// [B*Hkv, G] f32 (no chunk: acc 0, m -1e30, l 0).
//
// The pool is the fused int16 stream [mc, B*Hkv, KR + VR, 128]
// (ops/sparse_format.py encode_stream: K's value segments and 16 uint16
// word planes, then V's): a chunk's whole row-block is ONE cp.async copy,
// double-buffered.
//
// A masked column adds exactly 0 once a live column has set the running max
// (p = exp(-1e30 - m) = 0, and no max moves), so the kernel leaves masked
// columns out, reading only `win_len` window rows, except with nothing to
// attend at all (n_chunks = win_len = 0, not PARTIALS): there every
// column's p is exp(0) = 1, as on the TPU, and the output is the mean of all
// W rows of V.  With PARTIALS, chunk columns at or below `low` are masked
// (v6's sliding window: low = n_chunks*256 + win_len - 1 - window, -1 for
// none): a chunk wholly at or below it is skipped, and in the chunk that
// straddles it the masked columns' scores are -1e30.  On the TPU the skipped
// chunks give p = 1 while no live column has been seen, and the first live
// column's corr = exp(-1e30 - m) = 0 wipes them exactly; the caller
// guarantees a live column (window >= 1 keeps column n_chunks*256 - 1
// whenever win_len = 0).
//
// Warps own token rows and expand them with warp ballots; a lane keeps its
// four channels of every head's accumulator, rescaled at each step, and the
// warps' accumulators are summed once at the end.

#pragma once

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

template <int G, bool PARTIALS>
__global__ void __launch_bounds__(THREADS)
fused_kernel(const __nv_bfloat16* __restrict__ q,       // [B*Hkv, G, D]
             const int16_t* __restrict__ pool,          // [mc, B*Hkv, KR + VR, D]
             const __nv_bfloat16* __restrict__ k_win,   // [B, W, Hkv, D] (not PARTIALS)
             const __nv_bfloat16* __restrict__ v_win,
             void* __restrict__ out,                    // [B*Hkv, G, D]; acc f32 if PARTIALS
             float* __restrict__ m_out,                 // [B*Hkv, G] (PARTIALS)
             float* __restrict__ l_out,
             int out_f32, int BH, int Hkv, int mc, int W, int n_chunks, int win_len,
             int low, int ns, Fmt<16> kf, Fmt<16> vf) {
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

  auto score_row = [&](const float (&v)[4], int t, bool live) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s += qr[g][i] * v[i];
      s = online_softmax::warp_sum(s);
      if (lane == 0) sm.s[g][t] = live ? s * SM_SCALE : NEG;
    }
  };
  auto rescale_add = [&](const float (&pv)[G][4]) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = acc[g][i] * sm.corr[g] + pv[g][i];
  };
  // chunk ci of both streams into `dst`: K, then V
  auto fetch = [&](int16_t* dst, int ci) {
    bitmap::stage_rows_async(dst, pool + ((size_t)ci * BH + bh) * rows * D, (int)rows, tid,
                             THREADS);
  };

  // ---- pool chunks (PARTIALS: from the first with a column above `low`) ------
  const int ci0 = PARTIALS ? (low + 1) / CHUNK : 0;
  if (ci0 < n_chunks) fetch(stage + (ci0 & 1) * rows * D, ci0);
  for (int ci = ci0; ci < n_chunks; ++ci) {
    if (ci + 1 < n_chunks) {
      fetch(stage + ((ci + 1) & 1) * rows * D, ci + 1);
      bitmap::cp_async_wait<1>();
    } else {
      bitmap::cp_async_wait<0>();
    }
    const int16_t* kst = stage + (ci & 1) * rows * D;
    __syncthreads();   // chunk ci is in shared memory for every thread
    const int16_t* vst = kst + (size_t)kf.rows() * D;
    for (int t0 = warp; t0 < CHUNK; t0 += NR * WARPS) {
      float v[NR][4];
#pragma unroll
      for (int j = 0; j < NR; ++j)
        bitmap::expand_row<16>(kst, kf, t0 + j * WARPS, lane, v[j]);
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int t = t0 + j * WARPS;
        score_row(v[j], t, !PARTIALS || ci * CHUNK + t > low);
      }
    }
    __syncthreads();
    online_softmax::softmax_step<G>(sm, CHUNK, warp, lane);

    float pv[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g) pv[g][0] = pv[g][1] = pv[g][2] = pv[g][3] = 0.f;
    for (int t0 = warp; t0 < CHUNK; t0 += NR * WARPS) {
      float v[NR][4];
#pragma unroll
      for (int j = 0; j < NR; ++j)
        bitmap::expand_row<16>(vst, vf, t0 + j * WARPS, lane, v[j]);
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
  if constexpr (!PARTIALS) {
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
          score_row(v, t, true);
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
  }

  // ---- sum the warps' accumulators; normalise, or write the partials ----------
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
    const size_t at = (size_t)bh * G * D + i;
    if (PARTIALS) {
      static_cast<float*>(out)[at] = red[g][i % D];
      continue;
    }
    const float o = red[g][i % D] / sm.l[g];
    if (out_f32)
      static_cast<float*>(out)[at] = o;
    else
      static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(o);
  }
  if (PARTIALS && tid < G) {
    m_out[(size_t)bh * G + tid] = sm.m[tid];
    l_out[(size_t)bh * G + tid] = sm.l[tid];
  }
}

// Checks the launch, sizes shared memory and launches the instance for G.
// (k0, k1) and (vk0, vk1) are the streams' segment widths.
template <bool PARTIALS>
int launch(const void* q, const void* pool, const void* k_win, const void* v_win,
           void* out, float* m_out, float* l_out, int out_f32, int device, int B, int Hkv,
           int G, int mc, int W, int n_chunks, int win_len, int low, int k0, int k1,
           int vk0, int vk1, void* stream) {
  bool k_ok, v_ok;
  const Fmt<16> kf = bitmap::make_fmt<16>(k0, k1, &k_ok);
  const Fmt<16> vf = bitmap::make_fmt<16>(vk0, vk1, &v_ok);
  if (!k_ok || !v_ok || B < 1 || Hkv < 1 || mc < 1 || W < 1 || n_chunks < 0 ||
      n_chunks > mc || win_len < 0 || win_len > W || low < -1 ||
      (PARTIALS && (m_out == nullptr || l_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int ns = PARTIALS ? CHUNK : ((W > CHUNK ? W : CHUNK) + 3) / 4 * 4;
  const size_t smem = head_bytes(G, ns) + 2 * ((size_t)kf.rows() + vf.rows()) * D * 2;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;   // a window too long
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * Hkv;
#define FUSED_LAUNCH(g)                                                                 \
  {                                                                                     \
    err = cudaFuncSetAttribute(fused_kernel<g, PARTIALS>,                               \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
    if (err != cudaSuccess) return (int)err;                                            \
    fused_kernel<g, PARTIALS><<<BH, THREADS, smem, s>>>(                                \
        static_cast<const __nv_bfloat16*>(q), static_cast<const int16_t*>(pool),        \
        static_cast<const __nv_bfloat16*>(k_win), static_cast<const __nv_bfloat16*>(v_win), \
        out, m_out, l_out, out_f32, BH, Hkv, mc, W, n_chunks, win_len, low, ns, kf, vf); \
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
