// Fused prune + quantize + pack for the quant codecs, for Hopper (sm_90a).
//
// Replaces the TPU kernel mustafar_tpu/ops/kernels/pack_kernel.py
// prune_quant_pack (Pallas body _prune_quant_pack_kernel).  For each
// head-chunk, one [C, 128] bf16 tile of one (job, b, kv head), it
//   1. keys every entry by its magnitude: the 15-bit pattern of |x|
//      (bf16 bits & 0x7fff), or with a score the 31-bit pattern of the
//      f32 |score|; both order like the values.  A launch where one
//      operand has a score takes the score instance; an operand without
//      one is keyed by |x| there too (the Opa policies score K or V, not
//      always both);
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
// One launch takes one or two operands (the cache's K and V, each with its
// own keep and bits: q8q4 packs K at 8 bits and V at 4) over n_hc = J*B*H
// head-chunks each, addressed through (job, b, h, token) strides for x and
// (job, b, h, row) strides for the rows and scales: the job is the prompt's
// chunk in prefill (x a slice of the prompt, the rows a run of pool slots)
// and the layer in a compaction (every layer's window into its pool slot).
//
// What bounds it on this card: at the serving shapes, latency and the
// exact selection's instructions, not bytes.  It reads C*256 bytes a
// head-chunk (plus C*512 of score) and writes C*bits*16 + 256: 6.3 MB at 64
// head-chunks of 256 tokens, 8 bits, 1.9 us at 3.35 TB/s.  The first
// version (one block of 1024 threads a head-chunk, four ballots and
// popcounts a row and round, loads waited for one by one, one 2-byte store
// a carrier) took 0.0391 ms there and filled 64 of the 132 SMs (8 at the
// engine's batch-1 pack); the cache called it twice a chunk (K, V) and a
// layer at a time.
//
// Design:
//   * One launch takes one or two operands over all their head-chunks, so
//     the cache packs K and V of all a prefill's chunks, or of every layer
//     in a compaction, at once.
//   * Thread block clusters cut each head-chunk's token rows: a cluster of
//     S CTAs (pack_kernel.pack_grid: the least power of two that gives
//     every SM a CTA, halved while the clusters would not all be resident;
//     16 CTAs is beyond the portable 8, allowed once an instance and
//     device) per (operand, head-chunk).  CTA p owns carrier rows
//     [p*R/S, (p+1)*R/S) and so the tokens j*R + those rows for every token
//     block j: it prunes, quantizes and packs them alone.  Only the
//     per-channel amax crosses CTAs: each CTA reduces its own, pushes it
//     into a slot of every peer's shared memory (distributed shared memory,
//     after a barrier arrived at on entry and waited on here, so every peer
//     has started), meets them at a second barrier and takes the max of the
//     slots at home (a max of non-negative floats: any order gives the same
//     bits).  Nothing crosses CTAs after that.
//   * Staging: every copy of a warp's row groups is issued with cp.async up
//     front, a copy group a group of four rows, and each group is pruned as
//     it lands.
//   * Selection, 8 lanes a token row, 16 channels a lane: the lane
//     transposes its 16 keys into 15 bit planes (16 x 16 bits, four stages
//     of block swaps), and the bisection narrows two masks a bit at a time
//     (planes_select): a round is an AND, a popcount and one
//     __reduce_add_sync that totals four rows' counts, a byte each.  It ends
//     with each lane's keys above the threshold and at it; only a row with
//     more ties than room ranks them (ties to the lower channel).  The score
//     keys (31 bits) bisect by compares.  Kept magnitudes fold into the
//     channel amaxes as bf16 pairs (__hmax2: fmaxf's NaN rule).
//   * Codes: a thread takes 8 channels of one carrier row, 16 bytes a token
//     block from shared memory and one 16-byte store.  A code is the
//     product with the scale's correctly rounded reciprocal, rounded by a
//     magic add; within 2^-14 of a half step (rare) the correctly rounded
//     division decides, so the codes are __fdiv_rn's bit for bit (the
//     argument is at code_bits).
//   * Host: the dynamic shared-memory limit and the cluster-size opt-in are
//     set once per instance and device.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/kernel_ab.py, parent
// and this kernel in one call, L2 flushed): K alone at 64 head-chunks of
// 256, 8 bits, keep 40, 0.0393 -> 0.0162 ms (byte bound 0.0019); K and V
// of 64 head-chunks in one launch 0.0204 (two launches before: 0.0743);
// the engine's batch-1 K+V 0.0121 (0.0721); a 32-layer compaction's K+V
// in one launch 0.313 (64 launches: 2.256).  At 64 head-chunks (2-CTA
// clusters of 512 threads, one an SM) the time is a chain: ~5.6 us of
// launch, then staging ~2.5, selection ~3.0, the cluster's exchange ~1.0
// and codes ~2.4 (the timing-only variants of kernel_ab.py --variants
// prune_quant_pack); dividing every code would add ~3.8.
//
// Interface: plain C, no PyTorch headers, bound with ctypes.  Launches on
// the caller's stream, synchronises nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cstring>
#include <mutex>

#include <cooperative_groups.h>

#include "smem_stage.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int D = 128;                 // head_dim == the row's lanes
constexpr int RG = 4;                  // token rows a warp takes at a time
constexpr int ROW_LANES = 32 / RG;     // lanes of a token row
constexpr int CH = D / ROW_LANES;      // channels a lane holds
constexpr int MAX_C = 512;
constexpr int MAX_OPS = 2;
constexpr int MAX_CLUSTER = 16;        // non-portable above 8
constexpr int MAX_WARPS = 16;
constexpr int MIN_THREADS = D;         // a thread a channel for the scales
constexpr int MAX_PASSES = 8;          // row groups a warp takes, each its own copy group
constexpr int MAX_SCORE_TOKENS = 256;  // a CTA's token rows with a score
constexpr unsigned FULL = 0xffffffffu;
constexpr float MAGIC = 12582912.f;    // 1.5 * 2^23: v + MAGIC rounds v half to even
constexpr float HALF_STEP_MARGIN = 0x1p-14f;

// One operand: element (job, b, h, token, d) of x at
// job*xs[0] + b*xs[1] + h*xs[2] + token*xs[3] + d; of the rows
// (job, b, h, r, d) at rs[0..3] likewise; scales (job, b, h, d) at ss[0..2];
// score null (keyed by |x|) or f32 [J*B*H, C, 128] contiguous.
struct Op {
  const __nv_bfloat16* x;
  const float* score;
  int16_t* rows;
  __nv_bfloat16* scales;
  long long xs[4];
  long long rs[4];
  long long ss[3];
  int keep;
  int bits;
  float inv_qmax;
  int pad;
};

struct Params {
  Op op[MAX_OPS];
  int B, H, C, n_hc;                   // n_hc = J * B * H head-chunks an operand
};

// tile [tokens][D] bf16, score keys [tokens][D] (with a score), the warps'
// amaxes [warps][D], the cluster's amaxes [cluster][D], scales and their
// reciprocals [D]
__host__ __device__ constexpr int smem_bytes(int tokens, int warps, bool score,
                                             int cluster) {
  return tokens * D * 2 + (score ? tokens * D * 4 : 0) + (warps + cluster + 2) * D * 4;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Waits until at most n (< MAX_PASSES) of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: smem::cp_async_wait<0>(); break;
    case 1: smem::cp_async_wait<1>(); break;
    case 2: smem::cp_async_wait<2>(); break;
    case 3: smem::cp_async_wait<3>(); break;
    case 4: smem::cp_async_wait<4>(); break;
    case 5: smem::cp_async_wait<5>(); break;
    case 6: smem::cp_async_wait<6>(); break;
    case 7: smem::cp_async_wait<7>(); break;
    default: smem::cp_async_wait<0>(); break;
  }
}

// One copy group: this warp's token rows u0 .. u0 + RG - 1 (local token
// u = j*RS + r is token j*R + part*RS + r) and their score rows.
template <int KEYBITS>
__device__ __forceinline__ void stage_rows(uint16_t* tile, uint32_t* stile,
                                           const __nv_bfloat16* xb, long long xst,
                                           const float* sb, int u0, int R, int RS, int part,
                                           int lane) {
#pragma unroll
  for (int c = lane; c < RG * 16; c += 32) {
    const int u = u0 + (c >> 4);
    const int t = (u / RS) * R + part * RS + u % RS;
    smem::cp_async16(smem::smem_addr(tile + u * D + (c & 15) * 8),
                     xb + t * xst + (c & 15) * 8);
  }
  if (KEYBITS == 31 && sb != nullptr) {
#pragma unroll
    for (int c = lane; c < RG * 32; c += 32) {
      const int u = u0 + (c >> 5);
      const int t = (u / RS) * R + part * RS + u % RS;
      smem::cp_async16(smem::smem_addr(stile + u * D + (c & 31) * 4),
                       sb + (size_t)t * D + (c & 31) * 4);
    }
  }
  smem::cp_async_commit();
}

// A warp takes RG token rows at a time, ROW_LANES lanes a row: lane l
// holds channels [CH*(l % 8), CH*(l % 8) + CH) of row l / 8.  The four rows'
// lane counts (at most CH each) go a byte each into one word for one
// __reduce_add_sync; adding 0x80 - keep to every byte then sets its top bit
// where the row's count >= keep (a row's count is at most 128).
struct RowLanes {
  uint32_t sel;                         // byte_perm selector: byte 0 into this row's byte
  uint32_t ge_bit;                      // this row's byte's top bit
  int shift;                            // 8 * row
  __device__ __forceinline__ explicit RowLanes(int lane) {
    const int row = lane / ROW_LANES;
    sel = 0x4444u ^ (0x4u << (4 * row));
    shift = 8 * row;
    ge_bit = 0x80u << shift;
  }
  // The four rows' counts, a byte each (byte 0 of `count` is this lane's).
  __device__ __forceinline__ uint32_t total(uint32_t count) const {
    return __reduce_add_sync(FULL, __byte_perm(count, 0u, sel));
  }
};

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

__device__ __forceinline__ __nv_bfloat162 bf162_bits(uint32_t u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, 4);
  return h;
}

// Swaps the m x m blocks of rows a and b that the transpose exchanges.
__device__ __forceinline__ void block_swap(uint32_t& a, uint32_t& b, int m, uint32_t mask) {
  const uint32_t t = ((a >> m) ^ b) & mask;
  b ^= t;
  a ^= t << m;
}

// Transposes the 16 x 16 bit matrix whose row i (bits 0-15) is key i, two
// rows a word (w[j] = row 2j | row 2j+1 << 16), into its bit planes: after
// it w[j] = plane 2j | plane 2j+1 << 16, bit i of plane b being bit b of
// key i.  Four stages of block swaps (8, 4, 2 and 1 wide).
__device__ __forceinline__ void transpose16(uint32_t (&w)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) block_swap(w[j], w[j + 4], 8, 0x00ff00ffu);
#pragma unroll
  for (int j = 0; j < 8; j += 4) {
    block_swap(w[j], w[j + 2], 4, 0x0f0f0f0fu);
    block_swap(w[j + 1], w[j + 3], 4, 0x0f0f0f0fu);
  }
#pragma unroll
  for (int j = 0; j < 8; j += 2) block_swap(w[j], w[j + 1], 2, 0x33333333u);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t t = ((w[j] >> 1) ^ (w[j] >> 16)) & 0x5555u;
    w[j] ^= (t << 16) | (t << 1);
  }
}

// The 15-bit keys' selection on bit planes: the row's keep-th largest key
// (the threshold) is found bit by bit from the top, and this lane's keys
// end as two masks, those above the threshold and those at it.  e holds
// the keys that still match the threshold's bits so far, a those already
// above it, g how many of this lane's keys are in a.  At bit b the keys of
// e with bit b set, with those of a, are the keys >= threshold | 2^b: if
// the row has at least keep of them the bit is set and e narrows to them,
// else they join a.  A round is an AND, a popcount and the row's
// reduction: no compares and no keys held but the 8 plane words.
__device__ __forceinline__ void planes_select(const uint32_t (&raw)[CH / 2], int keep,
                                              const RowLanes& rl, uint32_t& above,
                                              uint32_t& tie) {
  uint32_t w[CH / 2];
#pragma unroll
  for (int j = 0; j < CH / 2; ++j) w[j] = raw[j] & 0x7fff7fffu;
  transpose16(w);
  const uint32_t bias = (0x80u - (uint32_t)keep) * 0x01010101u;
  uint32_t e = 0xffffu, a = 0u, g = 0u;
#pragma unroll
  for (int bit = 14; bit >= 0; --bit) {
    const uint32_t t = e & (bit & 1 ? w[bit >> 1] >> 16 : w[bit >> 1]);
    const uint32_t c = __popc(t);
    if ((rl.total(c + g) + bias) & rl.ge_bit) {
      e = t;
    } else {
      a |= t;
      e ^= t;
      g += c;
    }
  }
  above = a;
  tie = e;
}

// A lane's CH score keys (31 bits) and their bisection by compares.
struct ScoreKeys {
  uint32_t k[CH];

  __device__ __forceinline__ explicit ScoreKeys(const uint32_t* srow) {
#pragma unroll
    for (int i = 0; i < CH; i += 4) {
      const uint4 s4 = *reinterpret_cast<const uint4*>(srow + i);
      k[i] = s4.x & 0x7fffffffu;
      k[i + 1] = s4.y & 0x7fffffffu;
      k[i + 2] = s4.z & 0x7fffffffu;
      k[i + 3] = s4.w & 0x7fffffffu;
    }
  }

  __device__ __forceinline__ uint32_t count_ge(uint32_t cand) const {
    uint32_t c = 0;
#pragma unroll
    for (int i = 0; i < CH; ++i) c += (uint32_t)(k[i] >= cand);
    return c;
  }

  __device__ __forceinline__ void select(int keep, const RowLanes& rl, uint32_t& above,
                                         uint32_t& tie) const {
    const uint32_t bias = (0x80u - (uint32_t)keep) * 0x01010101u;
    uint32_t thr = 0;
#pragma unroll 1
    for (int bit = 30; bit >= 0; --bit) {
      const uint32_t cand = thr | (1u << bit);
      if ((rl.total(count_ge(cand)) + bias) & rl.ge_bit) thr = cand;
    }
    above = tie = 0u;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      above |= (uint32_t)(k[i] > thr) << i;
      tie |= (uint32_t)(k[i] == thr) << i;
    }
  }
};

// Prunes token rows u0 .. u0 + RG - 1 of the tile in place to `keep`
// entries each (this lane: its CH channels of row u0 + lane / 8) and folds
// the kept magnitudes into this lane's channel amaxes (bf16 pairs).  The
// keys are the score tile's, or |x|'s where `stile` is null.
template <int KEYBITS>
__device__ __forceinline__ void prune_rows(uint16_t* tile, const uint32_t* stile, int u0,
                                           int keep, int lane, uint32_t (&am)[CH / 2]) {
  const int off = (u0 + lane / ROW_LANES) * D + CH * (lane % ROW_LANES);
  uint32_t raw[CH / 2];                 // bf16 pairs: channels 2i, 2i + 1 of the lane's
  const uint4 r0 = *reinterpret_cast<const uint4*>(tile + off);
  const uint4 r1 = *reinterpret_cast<const uint4*>(tile + off + 8);
  raw[0] = r0.x; raw[1] = r0.y; raw[2] = r0.z; raw[3] = r0.w;
  raw[4] = r1.x; raw[5] = r1.y; raw[6] = r1.z; raw[7] = r1.w;
  uint32_t kept = 0xffffu;              // bit i: channel CH * (lane % 8) + i
  if (keep < D) {
    const RowLanes rl(lane);
    uint32_t above, tie;
    if (KEYBITS == 15 || stile == nullptr) planes_select(raw, keep, rl, above, tie);
    else ScoreKeys(stile + off).select(keep, rl, above, tie);
    kept = above | tie;
    const int n_ge = (int)((rl.total(__popc(kept)) >> rl.shift) & 0xffu);
    if (__any_sync(FULL, n_ge > keep)) {
      // a row with more entries at or above the threshold than keep has
      // more ties than room: those of the lower channels are kept, and
      // this lane's ties come after those of the row's lower lanes
      const int room = keep - (int)((rl.total(__popc(above)) >> rl.shift) & 0xffu);
      const int own = __popc(tie);
      int incl = own;
#pragma unroll
      for (int d = 1; d < ROW_LANES; d *= 2) {
        const int o = __shfl_up_sync(FULL, incl, d, ROW_LANES);
        if (lane % ROW_LANES >= d) incl += o;
      }
      int before = incl - own;
      kept = above;
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if ((tie >> i) & 1u) {
          if (before < room) kept |= 1u << i;
          ++before;
        }
    }
  }
  uint32_t p[CH / 2];
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) {
    p[i] = raw[i] & (((kept >> (2 * i)) & 1u ? 0x0000ffffu : 0u) |
                     ((kept >> (2 * i + 1)) & 1u ? 0xffff0000u : 0u));
    am[i] = bits_of(__hmax2(bf162_bits(am[i]), bf162_bits(p[i] & 0x7fff7fffu)));
  }
  *reinterpret_cast<uint4*>(tile + off) = make_uint4(p[0], p[1], p[2], p[3]);
  *reinterpret_cast<uint4*>(tile + off + 8) = make_uint4(p[4], p[5], p[6], p[7]);
}

// One code: clamp(rint(x / s), +-QMAX) + MAGIC, whose low bits are the
// code in two's complement.  With q = RN(1/s), v = RN(x * q) is within
// 3 * 2^-24 * |x/s| <= 2^-15 of RN(x / s) (|x/s| <= qmax * (1 + 2^-22) <=
// 128: s >= RN(amax * RN(1/qmax)) and |x| <= amax); so where v lies more
// than 2^-14 from every half-integer both round to the same integer, and
// |v| < qmax + 1/2 needs no clamp.  Nearer a half step, or for a NaN
// product (x or s not finite), the correctly rounded division and the
// clamp decide, as before.  A pruned zero gives code 0.
template <int BITS>
__device__ __forceinline__ uint32_t code_bits(float x, float s, float q) {
  constexpr float QMAX = (float)((1 << (BITS - 1)) - 1);
  const float v = x * q;
  const float tv = v + MAGIC;
  if (fabsf(v - (tv - MAGIC)) < 0.5f - HALF_STEP_MARGIN) return __float_as_uint(tv);
  return __float_as_uint(fminf(fmaxf(__fdiv_rn(x, s), -QMAX), QMAX) + MAGIC);
}

// Codes of the CTA's RS carrier rows (local token j*RS + r is row r's
// block j), 8 channels a thread, one 16-byte store each.
template <int BITS>
__device__ __forceinline__ void write_codes(const uint16_t* tile, const float* scale,
                                            const float* rcp, int16_t* rows, long long rsr,
                                            int row0, int RS, int tid, int nthreads) {
  constexpr int N = 16 / BITS;
  for (int i = tid; i < RS * 16; i += nthreads) {
    const int r = i >> 4;
    const int d0 = (i & 15) * 8;
    const float4 s0 = *reinterpret_cast<const float4*>(scale + d0);
    const float4 s1 = *reinterpret_cast<const float4*>(scale + d0 + 4);
    const float4 q0 = *reinterpret_cast<const float4*>(rcp + d0);
    const float4 q1 = *reinterpret_cast<const float4*>(rcp + d0 + 4);
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float q[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    uint32_t t[N][8];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint4 raw = *reinterpret_cast<const uint4*>(tile + (j * RS + r) * D + d0);
      const uint32_t h[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int c = 0; c < 8; ++c)
        t[j][c] = code_bits<BITS>(
            __uint_as_float(c & 1 ? h[c >> 1] & 0xffff0000u : h[c >> 1] << 16), s[c], q[c]);
    }
    uint32_t w[4];                      // carriers d0 + 2k (low) and d0 + 2k + 1
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (BITS == 8) {
        w[k] = __byte_perm(__byte_perm(t[0][2 * k], t[1][2 * k], 0x40),
                           __byte_perm(t[0][2 * k + 1], t[1][2 * k + 1], 0x40), 0x5410);
      } else {
        uint32_t c2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * k + e;
          c2[e] = (t[0][c] & 0xfu) | ((t[1][c] & 0xfu) << 4) | ((t[2][c] & 0xfu) << 8) |
                  ((t[3][c] & 0xfu) << 12);
        }
        w[k] = c2[0] | (c2[1] << 16);
      }
    }
    *reinterpret_cast<uint4*>(rows + (row0 + r) * rsr + d0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int KEYBITS>
__global__ void __launch_bounds__(32 * MAX_WARPS, 2)
prune_quant_pack_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  if (S > 1) cluster_arrive_relaxed();  // this CTA has started
  const int part = (int)cluster.block_rank();
  const int cid = blockIdx.x / S;
  const int oi = cid / p.n_hc;
  const int hc = cid - oi * p.n_hc;     // (job * B + b) * H + h
  const int h = hc % p.H;
  const int b = (hc / p.H) % p.B;
  const int job = hc / (p.H * p.B);
  const Op& op = p.op[oi];
  const int C = p.C;
  const int TC = C / S;                 // this CTA's token rows
  const int R = C * op.bits / 16;       // carrier rows of the head-chunk
  const int RS = R / S;                 // this CTA's carrier rows
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warps = nthreads >> 5;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  uint16_t* tile = reinterpret_cast<uint16_t*>(smem_raw);              // [TC][D]
  uint32_t* stile = reinterpret_cast<uint32_t*>(tile + TC * D);        // [TC][D] score
  float* amax_w = reinterpret_cast<float*>(stile + (KEYBITS == 31 ? TC * D : 0));
  float* slots = amax_w + warps * D;                                   // [S][D]
  float* scale = slots + S * D;                                        // [D]
  float* rcp = scale + D;                                              // [D]

  // every copy of this warp's row groups in flight, a group each, then
  // each group pruned as it lands
  const __nv_bfloat16* xb = op.x + job * op.xs[0] + b * op.xs[1] + h * op.xs[2];
  const float* sb = KEYBITS == 31 && op.score != nullptr ? op.score + (size_t)hc * C * D
                                                         : nullptr;
  const int groups = TC / RG;
  const int passes = warp < groups ? (groups - 1 - warp) / warps + 1 : 0;
  for (int pass = 0; pass < passes; ++pass)
    stage_rows<KEYBITS>(tile, stile, xb, op.xs[3], sb, (warp + pass * warps) * RG, R, RS,
                        part, lane);
  uint32_t am[CH / 2] = {};              // bf16 pairs of this lane's channels
  for (int pass = 0; pass < passes; ++pass) {
    cp_async_wait_pending(passes - 1 - pass);
    __syncwarp();
    prune_rows<KEYBITS>(tile, sb != nullptr ? stile : nullptr, (warp + pass * warps) * RG,
                        op.keep, lane, am);
  }
  // the warp's four rows' lanes of a channel range meet; row 0's lanes write
#pragma unroll
  for (int i = 0; i < CH / 2; ++i)
#pragma unroll
    for (int x = ROW_LANES; x < 32; x *= 2)
      am[i] = bits_of(__hmax2(bf162_bits(am[i]), bf162_bits(__shfl_xor_sync(FULL, am[i], x))));
  if (lane < ROW_LANES)
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) {
      amax_w[warp * D + CH * lane + 2 * i] = __uint_as_float(am[i] << 16);
      amax_w[warp * D + CH * lane + 2 * i + 1] = __uint_as_float(am[i] & 0xffff0000u);
    }
  __syncthreads();
  float a = 0.f;
  if (tid < D) {
    float b1 = 0.f, b2 = 0.f, b3 = 0.f;  // four chains of loads in flight
    for (int w = 0; w < warps; w += 4) {
      a = fmaxf(a, amax_w[w * D + tid]);
      if (w + 1 < warps) b1 = fmaxf(b1, amax_w[(w + 1) * D + tid]);
      if (w + 2 < warps) b2 = fmaxf(b2, amax_w[(w + 2) * D + tid]);
      if (w + 3 < warps) b3 = fmaxf(b3, amax_w[(w + 3) * D + tid]);
    }
    a = fmaxf(fmaxf(a, b1), fmaxf(b2, b3));
  }
  if (S > 1) {
    // push this CTA's amaxes into slot `part` of every CTA of the cluster
    // (each has started: the first barrier), then meet again and reduce the
    // slots at home; nothing crosses CTAs after that
    cluster_wait();
    if (tid < D)
      for (int r = 0; r < S; ++r) *cluster.map_shared_rank(slots + part * D + tid, r) = a;
    cluster_arrive();
    cluster_wait();
    if (tid < D) {
      a = 0.f;
      for (int r = 0; r < S; ++r) a = fmaxf(a, slots[r * D + tid]);
    }
  }
  if (tid < D) {
    const float s = fmaxf(__fmul_rn(a, op.inv_qmax), 1e-8f);
    scale[tid] = s;
    rcp[tid] = __frcp_rn(s);
    if (part == 0)
      op.scales[job * op.ss[0] + b * op.ss[1] + h * op.ss[2] + tid] = __float2bfloat16_rn(s);
  }
  __syncthreads();

  int16_t* rb = op.rows + job * op.rs[0] + b * op.rs[1] + h * op.rs[2];
  if (op.bits == 8)
    write_codes<8>(tile, scale, rcp, rb, op.rs[3], part * RS, RS, tid, nthreads);
  else
    write_codes<4>(tile, scale, rcp, rb, op.rs[3], part * RS, RS, tid, nthreads);
}

// The dynamic shared-memory limit (the instance's largest) and the
// non-portable cluster size, set once per instance and device.
template <int KEYBITS>
cudaError_t prepare(int device) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<bool> ready[MAX_DEVICES];
  static std::mutex lock;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (ready[device].load(std::memory_order_acquire)) return cudaSuccess;
  const std::lock_guard<std::mutex> hold(lock);
  if (ready[device].load(std::memory_order_relaxed)) return cudaSuccess;
  constexpr int bytes =
      KEYBITS == 15 ? smem_bytes(MAX_C, MAX_WARPS, false, MAX_CLUSTER)
                    : smem_bytes(MAX_SCORE_TOKENS, MAX_WARPS, true, MAX_CLUSTER);
  cudaError_t err = cudaFuncSetAttribute(prune_quant_pack_kernel<KEYBITS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(prune_quant_pack_kernel<KEYBITS>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) ready[device].store(true, std::memory_order_release);
  return err;
}

cudaLaunchConfig_t config(const Params& p, int cluster, int threads, bool score,
                          cudaLaunchAttribute* attr, cudaStream_t stream, int n_ops) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ops * p.n_hc * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes(p.C / cluster, threads / 32, score, cluster);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The launch's shape, or false if the kernel cannot serve it.
bool valid(const Op* ops, int n_ops, int J, int B, int H, int C, int cluster, int threads) {
  if (n_ops < 1 || n_ops > MAX_OPS || J < 1 || B < 1 || H < 1 || C < 128 || C > MAX_C ||
      C % 128 || cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) ||
      threads < MIN_THREADS || threads > 32 * MAX_WARPS || threads % 32)
    return false;
  const int tokens = C / cluster;
  if (tokens % RG || tokens / RG > MAX_PASSES * (threads / 32)) return false;
  bool score = false;
  for (int i = 0; i < n_ops; ++i) score = score || ops[i].score != nullptr;
  if (score && tokens > MAX_SCORE_TOKENS) return false;
  for (int i = 0; i < n_ops; ++i) {
    const Op& o = ops[i];
    if ((o.bits != 8 && o.bits != 4) || o.keep < 1 ||
        (C * o.bits / 16) % cluster || o.x == nullptr || o.rows == nullptr ||
        o.scales == nullptr || !aligned16(o.x) || !aligned16(o.rows) ||
        (o.score != nullptr && !aligned16(o.score)))
      return false;
    for (int a = 0; a < 4; ++a)
      if (o.xs[a] % 8 || o.rs[a] % 8) return false;
  }
  return true;
}

template <int KEYBITS>
int launch(const Params& p, int n_ops, int cluster, int threads, int device,
           cudaStream_t stream) {
  const cudaError_t err = prepare<KEYBITS>(device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(p, cluster, threads, KEYBITS == 31, &attr, stream, n_ops);
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, prune_quant_pack_kernel<KEYBITS>, p);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

}  // namespace

// `n_ops` (1 or 2) operands `ops` (see Op) over J*B*H head-chunks of C
// tokens each (C a multiple of 128 up to 512), in clusters of `cluster` CTAs
// (a power of two up to 16 that divides every operand's C*bits/16 rows,
// with C/cluster a multiple of 4, at most 256 where an operand has a
// score) of `threads` threads (a multiple of 32 from 128 to 512, a warp to
// at most 8 groups of 4 token rows).  x and the rows 16-byte aligned,
// their strides multiples of 8 elements; a score (on any operand, each
// operand without one keyed by |x|) 16-byte aligned.  `device` is the ordinal the tensors and
// the stream belong to.
extern "C" int prune_quant_pack_ops(const void* ops, int n_ops, int device, int J, int B,
                                    int H, int C, int cluster, int threads, void* stream) {
  const Op* o = static_cast<const Op*>(ops);
  if (o == nullptr || !valid(o, n_ops, J, B, H, C, cluster, threads))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  Params p = {};
  for (int i = 0; i < n_ops; ++i) p.op[i] = o[i];
  p.B = B;
  p.H = H;
  p.C = C;
  p.n_hc = J * B * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool score = false;
  for (int i = 0; i < n_ops; ++i) score = score || o[i].score != nullptr;
  if (!score) return launch<15>(p, n_ops, cluster, threads, device, s);
  return launch<31>(p, n_ops, cluster, threads, device, s);
}

// Writes to *out how many clusters of `cluster` CTAs of `threads` threads
// at C tokens (with a score or not) the card can hold at once
// (cudaOccupancyMaxActiveClusters).
extern "C" int prune_quant_pack_max_clusters(void* out, int device, int C, int cluster,
                                             int threads, int score) {
  if (out == nullptr || cluster < 1 || cluster > MAX_CLUSTER || C < 128 || C > MAX_C ||
      threads < MIN_THREADS || threads > 32 * MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  Params p = {};
  p.C = C;
  p.n_hc = 1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(p, cluster, threads, score != 0, &attr, nullptr, 1);
  int* n = static_cast<int*>(out);
  cudaError_t err;
  if (score) {
    err = prepare<31>(device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(n, prune_quant_pack_kernel<31>, &cfg);
  } else {
    err = prepare<15>(device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(n, prune_quant_pack_kernel<15>, &cfg);
  }
  return (int)err;
}
