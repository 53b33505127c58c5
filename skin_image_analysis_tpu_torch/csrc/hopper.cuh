// PTX helpers shared by the port's sm_90a kernels (included by each
// csrc/*.cu, which the build compiles as a translation unit of its own).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// Four 8x8 b16 matrices from shared memory into the mma.sync fragment
// layout; lanes 8i .. 8i + 7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

}  // namespace sia
