// PTX helpers shared by the port's sm_90a kernels (included by each
// csrc/*.cu, which the build compiles as a translation unit of its own).
#pragma once

#include <cuda_runtime.h>

namespace sia {

constexpr int kMaxCluster = 8;  // portable thread-block cluster size

// 16 bytes global -> shared, asynchronous, bypassing L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// Wait for every cp.async this thread has issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace sia
