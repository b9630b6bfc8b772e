// cp.async helpers shared by kernels A (conv3d.cu), D (conv3d_dw.cu) and E
// (cvstem_dxy.cu): 4- and 16-byte global -> shared copies that zero-fill
// where the source lies outside the volume, committed in groups and waited
// on group by group. And the element rule of the bf16-at-rest policy
// (rag_tpu_torch/ops/precision.py): a kernel's activations are float32 or
// bf16 (Elem); shared memory and every sum are float32, so a bf16 element
// is widened as it is staged (a register load: cp.async copies bytes and
// cannot widen) and rounded to nearest even as an output is stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace rag {

using bf16 = __nv_bfloat16;

// whether Elem is float32 (the cp.async path) rather than bf16
template <class Elem>
constexpr bool kF32 = std::is_same<Elem, float>::value;

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

// One element of a float32 or bf16 source into shared memory as float32,
// or 0 where !valid (src is then not read): a 4-byte cp.async for float32;
// for bf16 a register load and widening store, visible to the block after
// the __syncthreads() that publishes the cp.async copies of the same stage.
__device__ __forceinline__ void stage1(float* dst, const float* src,
                                       bool valid) {
  cp_async4(dst, src, valid);
}
__device__ __forceinline__ void stage1(float* dst, const bf16* src,
                                       bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}

// A float32 result as an output element (bf16: rounded to nearest even).
template <class Elem>
__device__ __forceinline__ Elem to_elem(float v) {
  if constexpr (kF32<Elem>)
    return v;
  else
    return __float2bfloat16_rn(v);
}

}  // namespace rag
