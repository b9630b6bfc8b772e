// The input policies of the two 3x3x3 conv engines, kernel A's
// (conv3d.cuh: kernels A, H and B) and kernel D's (conv3d_dw.cuh: kernels D
// and F). An engine stages rows of its channel-first (B, D, Cin, H, W)
// input volume into shared memory; a policy says where row (b, plane p,
// channel c, row h) comes from:
//   * VolumeSrc, a volume stored in device memory (kernels A, H, D), whose
//     rows the engines stage with their own code, unchanged by the policy;
//   * CostVolumeSrc, the concat cost volume of the matching stem (kernels B
//     and F), never stored: read from the two (B, C, H, W) feature maps,
//       v[d, c,   h, j] = X[c, h, j]      if j >= d else 0     (c < C)
//       v[d, C+c, h, j] = Y[c, h, j - d]  if j >= d else 0
//     (rag_tpu/ops/cost_volume.py::cost_volume_cf). Planes outside [0, D),
//     rows outside [0, H) and columns outside [0, W) are the conv's zero
//     padding. Column j >= W reads zero although Y[j - d] exists there: the
//     reference clips its source column and then masks, so nothing of Y
//     leaks into the W halo.
// Both policies take float32 or bf16 elements (Elem). Rows copy in pieces
// of N elements where the policy's vec(N) holds: kernel A's engine N = 4
// (16 bytes of float32, 8 of bf16), kernel D's 16 bytes (N = 4 floats or
// 8 bf16). A piece copies whole only where its source is aligned to the
// piece, which Y's rows at planes p % N != 0 are not, so a bf16 stage that
// is all Y (kernels B and F: at Cin = 24 a stage is one half) is staged at
// Y's own alignment, col_offset = p % N columns right of where the float32
// one starts, and read at that offset. The Python form of these rules,
// which the CPU tests emulate, is rag_tpu_torch/ops/cvstem.py::
// stage_piece and stage_offset.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace rag {

// One row of the input volume as a source: column j is src[j - shift]
// where lo <= j < hi, and zero elsewhere.
template <class Elem>
struct SrcRow {
  const Elem* src;
  int shift, lo, hi;
};

// whether p is aligned to a piece of N Elem
template <int N, class Elem>
inline bool piece_aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) % (N * sizeof(Elem))) == 0;
}

// A stored (B, D, Cin, H, W) volume of row length W.
template <class Elem>
struct VolumeSrc {
  using T = Elem;
  static constexpr bool kCostVolume = false;
  const Elem* x;
  int W;

  // whether rows may be copied in pieces of N elements
  template <int N>
  bool vec() const {
    return W % N == 0 && piece_aligned<N, Elem>(x);
  }
};

// The concat cost volume of two (B, C, H, W) feature maps, 2C channels
// and D planes. Row (p, c, h) is X's row h of channel c from column p on,
// or Y's shifted right by p: both zero left of the diagonal j = p.
template <class Elem>
struct CostVolumeSrc {
  using T = Elem;
  static constexpr bool kCostVolume = true;
  const Elem* x;
  const Elem* y;
  int D, C, H, W;

  __device__ __forceinline__ SrcRow<Elem> row(int b, int p, int c,
                                              int h) const {
    if (p < 0 || p >= D || c >= 2 * C || h < 0 || h >= H) return {x, 0, 0, 0};
    const bool yh = c >= C;
    const Elem* base =
        (yh ? y : x) + (((size_t)b * C + (yh ? c - C : c)) * H + h) * (size_t)W;
    return {base, yh ? p : 0, p, W};
  }
  // the last plane with a nonzero value in some column <= j: plane p is
  // zero at every column j < p
  __device__ __forceinline__ int last_live_plane(int j) const { return j; }
  template <int N>
  bool vec() const {
    return W % N == 0 && piece_aligned<N, Elem>(x) &&
           piece_aligned<N, Elem>(y);
  }
  // How many columns right of where a float32 stage starts a bf16 stage of
  // plane p in pieces of N, whose channels start at c0, sits: p % N where
  // the stage is all Y (c0 >= C), so that Y's pieces copy whole, else 0. A
  // float32 stage keeps 0 (Y's rows at p % 4 != 0 copy 4 bytes at a time).
  template <int N>
  __device__ __forceinline__ int col_offset(int p, int c0) const {
    return !kF32<Elem> && c0 >= C ? p & (N - 1) : 0;
  }
};

// Columns j0 .. j0+N-1 of a row into dst (aligned to the piece; the
// policy's vec<N>() held): one copy of the piece (stage_n) where all N
// columns are inside and their source is aligned to the piece (Y's rows at
// planes p % N != 0 are not, unless the stage was offset by col_offset),
// one zero fill of it where none is inside, else one element at a time
// (stage1: the diagonal's piece, a bf16 Y row's piece at the right edge,
// unaligned sources). `any` is a global address for the fills.
template <int N, class Elem>
__device__ __forceinline__ void stage_piece(Elem* dst, const SrcRow<Elem>& r,
                                            int j0, const Elem* any) {
  const int s0 = j0 - r.shift;
  if (j0 >= r.lo && j0 + N <= r.hi && (s0 & (N - 1)) == 0) {
    stage_n<N>(dst, r.src + s0, true);
  } else if (j0 + N <= r.lo || j0 >= r.hi) {
    stage_n<N>(dst, any, false);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int j = j0 + e;
      const bool ok = j >= r.lo && j < r.hi;
      stage1(dst + e, ok ? r.src + (j - r.shift) : any, ok);
    }
  }
}

// Column j of a row into dst, one element (stage1).
template <class Elem>
__device__ __forceinline__ void stage_col(Elem* dst, const SrcRow<Elem>& r,
                                          int j, const Elem* any) {
  const bool ok = j >= r.lo && j < r.hi;
  stage1(dst, ok ? r.src + (j - r.shift) : any, ok);
}

}  // namespace rag
