// cp.async helpers shared by kernels A (conv3d.cu), D (conv3d_dw.cu) and E
// (cvstem_dxy.cu): 4- and 16-byte global -> shared copies that zero-fill
// where the source lies outside the volume, committed in groups and waited
// on group by group.
#pragma once

#include <cuda_runtime.h>

namespace rag {

// Copy one float to shared memory, or write 0 there when !valid (src is
// then not read, but must still be a global address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The same for four floats; dst and src 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every committed group but the newest has landed (this
// thread's copies; a __syncthreads() then publishes all threads' copies).
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Wait until every committed group has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace rag
