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
// The Python form of these rules, which the CPU tests emulate, is
// rag_tpu_torch/ops/cvstem.py::stage_piece.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace rag {

// One row of the input volume as a source: column j is src[j - shift]
// where lo <= j < hi, and zero elsewhere.
struct SrcRow {
  const float* src;
  int shift, lo, hi;
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A stored (B, D, Cin, H, W) volume of row length W.
struct VolumeSrc {
  static constexpr bool kCostVolume = false;
  const float* x;
  int W;

  // whether rows may be copied in 16-byte pieces
  bool vec() const { return W % 4 == 0 && aligned16(x); }
};

// The concat cost volume of two (B, C, H, W) feature maps, 2C channels
// and D planes. Row (p, c, h) is X's row h of channel c from column p on,
// or Y's shifted right by p: both zero left of the diagonal j = p.
struct CostVolumeSrc {
  static constexpr bool kCostVolume = true;
  const float* x;
  const float* y;
  int D, C, H, W;

  __device__ __forceinline__ SrcRow row(int b, int p, int c, int h) const {
    if (p < 0 || p >= D || c >= 2 * C || h < 0 || h >= H) return {x, 0, 0, 0};
    const bool yh = c >= C;
    const float* base =
        (yh ? y : x) + (((size_t)b * C + (yh ? c - C : c)) * H + h) * (size_t)W;
    return {base, yh ? p : 0, p, W};
  }
  // the last plane with a nonzero value in some column <= j: plane p is
  // zero at every column j < p
  __device__ __forceinline__ int last_live_plane(int j) const { return j; }
  bool vec() const { return W % 4 == 0 && aligned16(x) && aligned16(y); }
};

// Columns j0 .. j0+3 of a row into dst (16-byte aligned; j0 % 4 == 0 and
// the policy's vec() held): one 16-byte copy where all four columns are
// inside and their source is 16-byte aligned (Y's rows at planes p % 4 !=
// 0 are not), one 16-byte zero fill where none is inside, else four 4-byte
// copies or fills (the diagonal's piece, unaligned sources). `any` is a
// global address for the fills.
__device__ __forceinline__ void stage_piece(float* dst, const SrcRow& r,
                                            int j0, const float* any) {
  const int s0 = j0 - r.shift;
  if (j0 >= r.lo && j0 + 4 <= r.hi && (s0 & 3) == 0) {
    cp_async16(dst, r.src + s0, true);
  } else if (j0 + 4 <= r.lo || j0 >= r.hi) {
    cp_async16(dst, any, false);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + e;
      const bool ok = j >= r.lo && j < r.hi;
      cp_async4(dst + e, ok ? r.src + (j - r.shift) : any, ok);
    }
  }
}

// Column j of a row into dst, 4 bytes.
__device__ __forceinline__ void stage_col(float* dst, const SrcRow& r, int j,
                                          const float* any) {
  const bool ok = j >= r.lo && j < r.hi;
  cp_async4(dst, ok ? r.src + (j - r.shift) : any, ok);
}

}  // namespace rag
