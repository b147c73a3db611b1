// The online-softmax step of the decode kernels (quant_decode.cuh for the
// quant codecs, sp_decode.cuh for the bitmap codec) and the warp reductions
// it uses.  The step is the TPU kernels': f32 scores, a running max per
// query head, p = exp(s - m) summed in f32 and rounded to bf16 for the
// value product.

#pragma once

#include <cuda_bf16.h>

namespace online_softmax {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Online-softmax step over the `ntok` scores in sm.s (written and synced by
// the caller).  Warp g owns head g: new running max, p = exp(s - m_new)
// (summed in f32 into l, stored rounded to bf16 for the value product),
// and the correction factor of the old accumulator.  `S` is the kernel's
// shared layout, with members s[G][>= ntok], m[G], l[G] and corr[G].
template <int G, class S>
__device__ __forceinline__ void softmax_step(S& sm, int ntok, int warp, int lane) {
  if (warp < G) {
    const int g = warp;
    float mx = NEG;
    for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, sm.s[g][t]);
    mx = warp_max(mx);
    const float m_old = sm.m[g];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int t = lane; t < ntok; t += 32) {
      const float p = expf(sm.s[g][t] - m_new);
      sm.s[g][t] = round_bf16(p);
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float c = expf(m_old - m_new);
      sm.corr[g] = c;
      sm.l[g] = sm.l[g] * c + sum;
      sm.m[g] = m_new;
    }
  }
  __syncthreads();
}

}  // namespace online_softmax
