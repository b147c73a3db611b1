// Staging device memory in shared memory, shared by the kernels that do it:
// cp.async groups; mbarriers and the bulk copies (cp.async.bulk, TMA tile
// loads) that complete on them; and each kernel instance's dynamic
// shared-memory limit.

#pragma once

#include <atomic>
#include <mutex>

#include <cuda_runtime.h>

namespace smem {

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One 16-byte cp.async copy to the shared-memory address `dst` (16-byte
// aligned, from __cvta_generic_to_shared) from `src` (16-byte aligned).
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// ---- mbarriers and bulk copies (sm_90) ----------------------------------------
// `bar` is the shared-memory address (__cvta_generic_to_shared) of an
// 8-byte-aligned uint64_t.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One thread initialises; then fence_barrier_init() and a block barrier
// before any thread uses it.
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// This thread's arrival, announcing `bytes` of copies that complete on it.
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed (the
// phase before the first completes counts as parity 1).
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (bulk copies, wgmma operand reads), and the reverse.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from global `src` (16-byte aligned) to shared
// `dst` (16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The 2D box of the tensor map `map` (a __grid_constant__ parameter) at
// element coordinates (c0 innermost, c1) to shared `dst` (aligned as the
// map's swizzle needs), completing on `bar`.
__device__ __forceinline__ void tma_load_2d(unsigned dst, const void* map, int c0, int c1,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(map), "r"(bar), "r"(c0), "r"(c1) : "memory");
}

// Lets instance KERNEL take `bytes` of dynamic shared memory on `device`
// (the current device).  The limit set only grows, so the attribute is set
// once per instance and device for each larger size a process asks for,
// not at every launch; a lock orders the sets.
template <auto KERNEL>
inline cudaError_t allow_dynamic_smem(int bytes, int device) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<int> allowed[MAX_DEVICES];   // zero: static storage
  static std::mutex lock;
  if (device < 0 || device >= MAX_DEVICES)
    return cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (allowed[device].load(std::memory_order_acquire) >= bytes) return cudaSuccess;
  const std::lock_guard<std::mutex> hold(lock);
  const int now = allowed[device].load(std::memory_order_relaxed);
  if (now >= bytes) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed[device].store(bytes, std::memory_order_release);
  return err;
}

}  // namespace smem
