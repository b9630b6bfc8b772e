// cp.async helpers shared by kernels A (conv3d.cu), D (conv3d_dw.cu), E
// (cvstem_dxy.cu), I (resize_taps.cu) and J, K (shear.cu): 4-, 8- and
// 16-byte global -> shared copies that zero-fill where the source lies
// outside the volume, committed in groups and waited on group by group. And
// the element rule of the bf16-at-rest policy (rag_tpu_torch/ops/
// precision.py): a kernel's activations are float32 or bf16 (Elem) and
// every sum is float32. cp.async copies bytes and cannot widen, so a bf16
// row is staged as it is, two bytes an element (A: 8-byte pieces of four;
// D: 16-byte pieces of eight; E, I and K: 16-byte pieces of eight, or
// 8-byte ones of four; J: 8-byte pieces of four), and widened in shared
// memory or as it is read (widen_bits: a bf16 is the top half of its
// float32). An output is rounded to nearest even as it is stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
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

// 8 bytes; dst and src 8-byte aligned. (.cg takes 16 bytes only, so
// these pass through L1.)
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// 16 bytes (four floats); dst and src 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// One float32 element into shared memory, or 0 where !valid (src is then
// not read): a 4-byte cp.async.
__device__ __forceinline__ void stage1(float* dst, const float* src,
                                       bool valid) {
  cp_async4(dst, src, valid);
}
// One bf16 element into a bf16 slab as it is (there is no 2-byte
// cp.async): a register load and store, visible to the block after the
// __syncthreads() that publishes the cp.async copies of the same stage.
// The element path of a bf16 row that does not copy in pieces (E, I, J, K:
// W not a multiple of the piece, or an unaligned operand; A, D: the pieces
// that straddle the cost volume's diagonal or W).
__device__ __forceinline__ void stage1(bf16* dst, const bf16* src,
                                       bool valid) {
  *dst = valid ? *src : __ushort_as_bfloat16(0);
}

// A piece of N elements into a slab of the same type, or zeros where
// !valid: one cp.async of its 8 or 16 bytes (dst and src aligned to the
// piece). Kernel A's engine copies pieces of four elements (16 bytes of
// float32, 8 of bf16), kernel D's pieces of 16 bytes (four floats, eight
// bf16); the bf16 instances of E, I and K pieces of eight bf16 (or four),
// kernel J's pieces of four elements.
template <int N, class Elem>
__device__ __forceinline__ void stage_n(Elem* dst, const Elem* src,
                                        bool valid) {
  constexpr int bytes = N * (int)sizeof(Elem);
  static_assert(bytes == 8 || bytes == 16, "a piece is 8 or 16 bytes");
  if constexpr (bytes == 16)
    cp_async16(dst, src, valid);
  else
    cp_async8(dst, src, valid);
}

// A bf16 as the bits of its float32 (exact: bf16 is float32's top half).
__device__ __forceinline__ uint32_t widen_bits(bf16 h) {
  return (uint32_t)__bfloat16_as_ushort(h) << 16;
}

// A staged element as float32: a float32 as it is, a bf16 widened.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 h) {
  return __uint_as_float(widen_bits(h));
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
