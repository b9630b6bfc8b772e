// Kernel B: the concat cost volume fused into the matching stem's 3x3x3
// conv + folded BatchNorm affine + ReLU. The (B, D, 2C, H, W) volume is never
// stored: each block builds its haloed slab of it in shared memory straight
// from the two (B, C, H, W) feature maps (CostVolumeSrc in
// conv3x3x3_tile.cuh).
//
// Replaces the TPU kernel rag_tpu/ops/pallas_cvstem.py::cvstem_forward_cf
// (body _cvstem_kernel) and its H-tiled form cvstem_forward_cf_v3
// (_cvstem_kernel_v3) used at the eval geometry.
//
// Bound: ~51 GFLOP at the eval geometry against ~5 MB of features read and
// 157 MB written, so operations bound it; the 315 MB volume the plain
// version builds (and reads three times through the conv) costs nothing
// here.
#include "conv3x3x3_tile.cuh"

extern "C" int rag_cvstem_brc(const void* x, const void* y, const void* wpk,
                              const void* scale, const void* bias, void* out,
                              int B, int C, int H, int W, int num_disp,
                              int Cout, int co_t, int relu, void* stream) {
  const rag::CostVolumeSrc src{static_cast<const float*>(x),
                               static_cast<const float*>(y), num_disp, C, H,
                               W};
  return rag::launch_conv3x3x3(
      src, static_cast<const float*>(wpk), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(out), B, num_disp,
      2 * C, H, W, Cout, co_t, relu, static_cast<cudaStream_t>(stream));
}
