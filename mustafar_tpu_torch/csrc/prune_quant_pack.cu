// Fused prune + quantize + pack for the quant codecs, for Hopper (sm_90a).
//
// Replaces the TPU kernel mustafar_tpu/ops/kernels/pack_kernel.py
// prune_quant_pack (Pallas body _prune_quant_pack_kernel).  For each
// head-chunk, one [C, 128] bf16 tile of one (b, kv head), it
//   1. keys every entry by its magnitude: the 15-bit pattern of |x|
//      (bf16 bits & 0x7fff), or with a score the 31-bit pattern of the
//      f32 |score|; both order like the values;
//   2. finds each token row's keep-th largest key by a bitwise bisection
//      (15 or 31 rounds: the largest t with count(key >= t) >= keep);
//   3. keeps exactly `keep` entries a row: those above that threshold,
//      then the ties in channel order up to `keep` (keep >= 128 keeps all);
//   4. per channel over the C tokens: amax of the kept values, then
//      scale = max(amax * f32(1/qmax), 1e-8) in f32 (the product, as the
//      jitted JAX chain and the port's quantize_chunk compute it), stored
//      as bf16 rounded to nearest even;
//   5. codes = clamp(rint(x / scale), +-qmax): a correctly rounded f32
//      division, rounding half to even;
//   6. packs token block j (tokens j*R .. j*R + R - 1, R = C*bits/16) into
//      bits [bits*j, bits*(j+1)) of int16 row r, two's complement fields.
// It is bit-exact with the port's plain chain (sparse_format.topk_mask,
// then quant_format.encode_chunk).
//
// What bounds it on this card: bytes.  It reads the chunk once (C*256
// bytes, plus C*512 of score) and writes C*bits*16 bytes of rows and 256 of
// scales: at B*Hkv = 64, C = 256, int8 some 4.2 MB in and 2.1 MB out, under
// 2 us at 3.35 TB/s (NVIDIA H100 SXM at 700 W).  At the serving shapes (64
// or 8 head-chunks, one block each) it is bound in practice by one block's
// latency: the bisection's 15 dependent rounds and the correctly rounded
// divisions of the codes.
//
// Design (first, simple version): one block of 1024 threads (32 warps) per
// head-chunk: with one block on an SM, many warps hide each other's
// latency (256 threads took 1.6x as long on the card).  A warp takes 4 token
// rows at a time (interleaved, so four independent bisections hide each
// other's latency too); lane l holds channels
// 4l .. 4l + 3 of each row from one 8-byte load.  A round's count is the
// popcount of the warp's ballots; the tie rank of channel 4l + i is the
// number of tie ballots of lower lanes (popcount under the lane mask) plus
// this lane's own ties below i: the "ties to the lower channel" rule
// without the TPU's triangular matmul.  Kept values go to a bf16 tile in
// shared memory (C * 256 bytes) and each lane keeps the amax of its four
// channels; the 32 warps' amaxes meet in shared memory.  Then one thread
// per (row, channel) computes the 16/bits codes of its carrier and stores
// it: a warp writes 64 contiguous bytes.  x is read through (b, h, token)
// strides, so windows and prompt slices are packed where they lie, and the
// rows and scales are written through strides into the pool slot.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;                 // head_dim == the row's lanes
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int RG = 4;                  // token rows a warp takes at a time
constexpr int MAX_C = 512;             // tokens of the shared tile
constexpr unsigned FULL = 0xffffffffu;

constexpr int smem_bytes(int C) { return (WARPS + 1) * D * 4 + C * D * 2; }

template <int KEYBITS>
__global__ void __launch_bounds__(THREADS)
prune_quant_pack_kernel(const __nv_bfloat16* __restrict__ x,   // (b, h, t) strided
                        const float* __restrict__ score,       // [BH, C, D] or null
                        int16_t* __restrict__ rows,            // (b, h, r) strided
                        __nv_bfloat16* __restrict__ scales,    // (b, h) strided
                        int H, int C, int keep, int bits, long long xsb,
                        long long xsh, long long xst, long long rsb, long long rsh,
                        long long rsr, long long ssb, long long ssh, float inv_qmax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* amax_w = reinterpret_cast<float*>(smem_raw);                 // [WARPS][D]
  float* scale = amax_w + WARPS * D;                                  // [D]
  uint16_t* tile = reinterpret_cast<uint16_t*>(scale + D);            // [C][D] kept
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const __nv_bfloat16* xb = x + b * xsb + h * xsh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;    // lanes of lower channels

  float am[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = warp * RG; t0 < C; t0 += WARPS * RG) {
    uint32_t v[RG][4];     // bf16 bit patterns of channels 4 lane + i
    uint32_t key[RG][4];
#pragma unroll
    for (int u = 0; u < RG; ++u) {
      const uint2 raw =
          *reinterpret_cast<const uint2*>(xb + (t0 + u) * xst + 4 * lane);
      v[u][0] = raw.x & 0xffffu;
      v[u][1] = raw.x >> 16;
      v[u][2] = raw.y & 0xffffu;
      v[u][3] = raw.y >> 16;
      if constexpr (KEYBITS == 15) {
#pragma unroll
        for (int i = 0; i < 4; ++i) key[u][i] = v[u][i] & 0x7fffu;
      } else {
        const uint4 s4 = *reinterpret_cast<const uint4*>(
            score + ((size_t)bh * C + t0 + u) * D + 4 * lane);
        key[u][0] = s4.x & 0x7fffffffu;
        key[u][1] = s4.y & 0x7fffffffu;
        key[u][2] = s4.z & 0x7fffffffu;
        key[u][3] = s4.w & 0x7fffffffu;
      }
    }
    bool kept[RG][4];
    if (keep >= D) {
#pragma unroll
      for (int u = 0; u < RG; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) kept[u][i] = true;
    } else {
      uint32_t thr[RG];
#pragma unroll
      for (int u = 0; u < RG; ++u) thr[u] = 0u;
      for (int bit = KEYBITS - 1; bit >= 0; --bit) {
#pragma unroll
        for (int u = 0; u < RG; ++u) {
          const uint32_t cand = thr[u] | (1u << bit);
          int cnt = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) cnt += __popc(__ballot_sync(FULL, key[u][i] >= cand));
          if (cnt >= keep) thr[u] = cand;           // the same in every lane
        }
      }
#pragma unroll
      for (int u = 0; u < RG; ++u) {
        int n_above = 0;
        int before = 0;                 // ties in channels below 4 lane + i
        unsigned tie[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          n_above += __popc(__ballot_sync(FULL, key[u][i] > thr[u]));
          tie[i] = __ballot_sync(FULL, key[u][i] == thr[u]);
          before += __popc(tie[i] & below);
        }
        const int room = keep - n_above;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool is_tie = (tie[i] >> lane) & 1u;
          kept[u][i] = key[u][i] > thr[u] || (is_tie && before < room);
          before += is_tie;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < RG; ++u) {
      uint32_t p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = kept[u][i] ? v[u][i] : 0u;
        am[i] = fmaxf(am[i], __uint_as_float((p[i] & 0x7fffu) << 16));
      }
      *reinterpret_cast<uint2*>(tile + (t0 + u) * D + 4 * lane) =
          make_uint2(p[0] | (p[1] << 16), p[2] | (p[3] << 16));
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) amax_w[warp * D + 4 * lane + i] = am[i];
  __syncthreads();
  if (tid < D) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a = fmaxf(a, amax_w[w * D + tid]);
    const float s = fmaxf(__fmul_rn(a, inv_qmax), 1e-8f);
    scale[tid] = s;
    scales[b * ssb + h * ssh + tid] = __float2bfloat16_rn(s);
  }
  __syncthreads();

  const int n = 16 / bits;
  const int R = C / n;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  const uint32_t fmask = (1u << bits) - 1u;
  int16_t* rb = rows + b * rsb + h * rsh;
  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D;
    const int d = i % D;
    const float s = scale[d];
    uint32_t w = 0u;
    for (int j = 0; j < n; ++j) {
      const float xv = __uint_as_float((uint32_t)tile[(j * R + r) * D + d] << 16);
      const float c = fminf(fmaxf(rintf(__fdiv_rn(xv, s)), -qmax), qmax);
      w |= ((uint32_t)(int)c & fmask) << (bits * j);
    }
    rb[r * rsr + d] = (int16_t)(uint16_t)(w & 0xffffu);
  }
}

template <int KEYBITS>
int launch(const void* x, const void* score, void* rows, void* scales, int B, int H,
           int C, int keep, int bits, long long xsb, long long xsh, long long xst,
           long long rsb, long long rsh, long long rsr, long long ssb, long long ssh,
           float inv_qmax, cudaStream_t stream) {
  const int smem = smem_bytes(C);
  const cudaError_t err = cudaFuncSetAttribute(
      prune_quant_pack_kernel<KEYBITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(MAX_C));
  if (err != cudaSuccess) return (int)err;
  prune_quant_pack_kernel<KEYBITS><<<B * H, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(score),
      static_cast<int16_t*>(rows), static_cast<__nv_bfloat16*>(scales), H, C, keep,
      bits, xsb, xsh, xst, rsb, rsh, rsr, ssb, ssh, inv_qmax);
  return (int)cudaGetLastError();
}

}  // namespace

// x: bf16, element (b, h, t, d) at b*xsb + h*xsh + t*xst + d (8-byte
// aligned, strides multiples of 4); score: null, or f32 [B*H, C, 128]
// contiguous and 16-byte aligned; rows: int16, (b, h, r, d) at b*rsb +
// h*rsh + r*rsr + d, R = C*bits/16 rows; scales: bf16, (b, h, d) at b*ssb +
// h*ssh + d.  C a multiple of 128 up to 512; `inv_qmax` is f32(1/qmax).
// `device` is the ordinal the tensors and the stream belong to.
extern "C" int prune_quant_pack(const void* x, const void* score, void* rows,
                                void* scales, int device, int B, int H, int C,
                                int keep, int bits, long long xsb, long long xsh,
                                long long xst, long long rsb, long long rsh,
                                long long rsr, long long ssb, long long ssh,
                                float inv_qmax, void* stream) {
  if (B < 1 || H < 1 || C < WARPS * RG || C % (WARPS * RG) || C > MAX_C || keep < 1 ||
      (bits != 8 && bits != 4))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (score == nullptr)
    return launch<15>(x, score, rows, scales, B, H, C, keep, bits, xsb, xsh, xst, rsb,
                      rsh, rsr, ssb, ssh, inv_qmax, s);
  return launch<31>(x, score, rows, scales, B, H, C, keep, bits, xsb, xsh, xst, rsb,
                    rsh, rsr, ssb, ssh, inv_qmax, s);
}
