// The archive's two-kernel SpMV pair (generation v1) for Hopper (sm_90a),
// over split pools (ops/sparse_format.py encode_chunk): per (kv head, chunk)
// value segments [R_i, 128] bf16 and a bitmap of 8 uint32 word planes
// [8, 128].  Pools are head-major: piece (bh, ci) is the bh * mc + ci-th
// run of R_i rows (segments) or of 8 planes (words).
//
// sp_key_scores replaces the TPU kernel
// mustafar_tpu/ops/kernels/sparse_attention_archive.py sparse_key_scores
// (Pallas body _key_scores_kernel): scores[bh, g, ci*256 + t] = q[bh, g] .
// K[bh, ci, t] in f32 for the 8 (padded) query rows of each kv head and
// every chunk ci < n_chunks, the keys expanded from the pools; the columns
// of chunks at or past n_chunks are written as exact zeros.  No scale.
//
// sp_value_combine replaces sparse_value_combine (_value_combine_kernel):
// out[bh, g] = sum over ci < n_chunks of w[bh, g, chunk ci] . V[bh, ci] in
// f32, w being bf16 softmax weights; later chunks' weights are not read.
//
// What bounds them on this card: bytes.  Scores read the active chunks'
// K pieces, B*Hkv*n_chunks*24,576 bytes at sparsity 0.7 (keep 40 = 32 + 8:
// 80 value rows of 256 bytes, 4,096 bytes of words), and write the f32
// scores of every chunk, B*Hkv*8*mc*256*4 bytes; at B=8, Hkv=8, mc=5 and
// one chunk that is 1.6 + 2.6 MB, some 1.3 us at 3.35 TB/s.  The combine
// reads the same V bytes and the active chunks' weights (4 KB a chunk and
// head).  Both do 2 flops for each expanded value and query row, 33.5
// MFLOP a chunk at B=8: the f32 units would take 0.5 us.  In practice the
// expansion's instructions bound them: every row costs four ballots,
// popcounts and shared-memory gathers per lane.
//
// Design (first, simple version).  Scores: one block of 8 warps per (kv
// head, chunk), so the grid covers B*Hkv*mc blocks; the chunk's pieces are
// staged into shared memory in stream order with cp.async
// (bitmap_expand.cuh stage_split), each warp expands token rows there
// (expand_row with 32-bit words) and reduces each row against the 8 query
// rows over the warp, and the block writes its 8 x 256 scores coalesced
// from shared memory.  Combine: one block per kv head loops over the
// active chunks, the next chunk's pieces and weights in flight (cp.async,
// two buffers) while this one is expanded; each lane keeps its four
// channels' sums for the 8 rows over its warp's tokens, and the 8 warps'
// sums are added once at the end.  Split-K over chunks for the combine,
// wgmma and TMA are later work.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include "bitmap_expand.cuh"
#include "softmax_step.cuh"

namespace archive_spmv {

using bitmap::CHUNK;
using bitmap::D;
using bitmap::Fmt;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int G8 = 8;                       // query rows a kv head (padded)
constexpr int NR = bitmap::ROWS_IN_FLIGHT;

__global__ void __launch_bounds__(THREADS)
key_scores_kernel(const __nv_bfloat16* __restrict__ q,    // [BH, 8, D]
                  const int16_t* __restrict__ seg0,       // [BH, mc*p0, D]
                  const int16_t* __restrict__ seg1,       // [BH, mc*p1, D] or null
                  const uint32_t* __restrict__ words,     // [BH, mc*8, D]
                  float* __restrict__ out,                // [BH, 8, mc*256]
                  int mc, int n_chunks, Fmt<16> f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float (*s)[CHUNK] = reinterpret_cast<float (*)[CHUNK]>(smem_raw);       // [8][256]
  int16_t* stage = reinterpret_cast<int16_t*>(smem_raw + sizeof(float) * G8 * CHUNK);
  const int bh = blockIdx.x;
  const int ci = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* o = out + (size_t)bh * G8 * mc * CHUNK + (size_t)ci * CHUNK;
  if (ci >= n_chunks) {
    for (int i = tid; i < G8 * CHUNK; i += THREADS) o[(size_t)(i / CHUNK) * mc * CHUNK + i % CHUNK] = 0.f;
    return;
  }
  bitmap::stage_split(stage, seg0, seg1, words, f, (size_t)bh * mc + ci, tid, THREADS);
  bitmap::cp_async_commit();
  float qr[G8][4];
#pragma unroll
  for (int g = 0; g < G8; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qr[g][i] = __bfloat162float(q[((size_t)bh * G8 + g) * D + lane + 32 * i]);
  bitmap::cp_async_wait<0>();
  __syncthreads();

  for (int t0 = warp; t0 < CHUNK; t0 += NR * WARPS) {
    float v[NR][4];
#pragma unroll
    for (int j = 0; j < NR; ++j)
      bitmap::expand_row<16, 32>(stage, f, t0 + j * WARPS, lane, v[j]);
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int g = 0; g < G8; ++g) {
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) x += qr[g][i] * v[j][i];
        x = online_softmax::warp_sum(x);
        if (lane == 0) s[g][t0 + j * WARPS] = x;
      }
  }
  __syncthreads();
  for (int i = tid; i < G8 * CHUNK; i += THREADS)
    o[(size_t)(i / CHUNK) * mc * CHUNK + i % CHUNK] = s[i / CHUNK][i % CHUNK];
}

__global__ void __launch_bounds__(THREADS)
value_combine_kernel(const __nv_bfloat16* __restrict__ w,  // [BH, 8, mc*256]
                     const int16_t* __restrict__ seg0,     // [BH, mc*p0, D]
                     const int16_t* __restrict__ seg1,     // [BH, mc*p1, D] or null
                     const uint32_t* __restrict__ words,   // [BH, mc*8, D]
                     float* __restrict__ out,              // [BH, 8, D]
                     int mc, int n_chunks, Fmt<16> f) {
  // dynamic shared memory: the warps' sums [8][D], then two buffers of one
  // chunk's V pieces (f.rows() rows) and its weights [8][256] bf16
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float (*red)[D] = reinterpret_cast<float (*)[D]>(smem_raw);
  int16_t* stage = reinterpret_cast<int16_t*>(smem_raw + sizeof(float) * G8 * D);
  const size_t buf = (size_t)f.rows() * D + G8 * CHUNK;     // int16 units
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  auto fetch = [&](int16_t* dst, int ci) {
    bitmap::stage_split(dst, seg0, seg1, words, f, (size_t)bh * mc + ci, tid, THREADS);
    int16_t* wdst = dst + (size_t)f.rows() * D;
    for (int g = 0; g < G8; ++g)   // one row's chunk: 512 bytes, two rows of 256
      bitmap::copy_rows_async(wdst + g * CHUNK,
                              w + ((size_t)bh * G8 + g) * mc * CHUNK + (size_t)ci * CHUNK,
                              CHUNK * 2 / (D * 2), tid, THREADS);
    bitmap::cp_async_commit();
  };
  float acc[G8][4];
#pragma unroll
  for (int g = 0; g < G8; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;

  if (n_chunks > 0) fetch(stage, 0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    if (ci + 1 < n_chunks) {
      fetch(stage + ((ci + 1) & 1) * buf, ci + 1);
      bitmap::cp_async_wait<1>();
    } else {
      bitmap::cp_async_wait<0>();
    }
    __syncthreads();   // chunk ci is in shared memory for every thread
    const int16_t* vst = stage + (ci & 1) * buf;
    const __nv_bfloat16* wst =
        reinterpret_cast<const __nv_bfloat16*>(vst + (size_t)f.rows() * D);
    for (int t0 = warp; t0 < CHUNK; t0 += NR * WARPS) {
      float v[NR][4];
#pragma unroll
      for (int j = 0; j < NR; ++j)
        bitmap::expand_row<16, 32>(vst, f, t0 + j * WARPS, lane, v[j]);
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int g = 0; g < G8; ++g) {
          const float p = __bfloat162float(wst[g * CHUNK + t0 + j * WARPS]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[g][i] += p * v[j][i];
        }
    }
    __syncthreads();   // the buffer is refilled two chunks on
  }

  for (int wp = 0; wp < WARPS; ++wp) {
    if (warp == wp) {
#pragma unroll
      for (int g = 0; g < G8; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[g][lane + 32 * i] = (wp ? red[g][lane + 32 * i] : 0.f) + acc[g][i];
    }
    __syncthreads();
  }
  for (int i = tid; i < G8 * D; i += THREADS) out[(size_t)bh * G8 * D + i] = red[i / D][i % D];
}

inline int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace archive_spmv

// q [BH, 8, 128] bf16; seg0 [BH, mc*p0, 128] and seg1 [BH, mc*p1, 128]
// bf16 (seg1 null when k1 = 0), words [BH, mc*8, 128] uint32; out
// [BH, 8, mc*256] f32.  All contiguous and 16-byte aligned; shapes checked
// by the caller.  (k0, k1) are the segment widths.
extern "C" int sp_key_scores(const void* q, const void* seg0, const void* seg1,
                             const void* words, void* out, int device, int BH, int mc,
                             int n_chunks, int k0, int k1, void* stream) {
  using namespace archive_spmv;
  bool ok;
  const Fmt<16> f = bitmap::make_fmt<16>(k0, k1, &ok);
  if (!ok || BH < 1 || mc < 1 || n_chunks < 0 || n_chunks > mc || (k1 > 0) != (seg1 != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * G8 * CHUNK + (size_t)f.rows() * D * 2;
  const int rc = set_smem((const void*)key_scores_kernel, smem);
  if (rc != 0) return rc;
  key_scores_kernel<<<dim3(BH, mc), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int16_t*>(seg0),
      static_cast<const int16_t*>(seg1), static_cast<const uint32_t*>(words),
      static_cast<float*>(out), mc, n_chunks, f);
  return (int)cudaGetLastError();
}

// w [BH, 8, mc*256] bf16; pools as for sp_key_scores; out [BH, 8, 128] f32.
extern "C" int sp_value_combine(const void* w, const void* seg0, const void* seg1,
                                const void* words, void* out, int device, int BH, int mc,
                                int n_chunks, int k0, int k1, void* stream) {
  using namespace archive_spmv;
  bool ok;
  const Fmt<16> f = bitmap::make_fmt<16>(k0, k1, &ok);
  if (!ok || BH < 1 || mc < 1 || n_chunks < 0 || n_chunks > mc || (k1 > 0) != (seg1 != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * G8 * D + 2 * ((size_t)f.rows() * D + G8 * CHUNK) * 2;
  const int rc = set_smem((const void*)value_combine_kernel, smem);
  if (rc != 0) return rc;
  value_combine_kernel<<<BH, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<const int16_t*>(seg0),
      static_cast<const int16_t*>(seg1), static_cast<const uint32_t*>(words),
      static_cast<float*>(out), mc, n_chunks, f);
  return (int)cudaGetLastError();
}
