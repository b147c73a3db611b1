// Staging device memory in shared memory, shared by the kernels that do it:
// cp.async groups, and each kernel instance's dynamic shared-memory limit.

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
