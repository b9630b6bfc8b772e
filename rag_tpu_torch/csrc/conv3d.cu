// Kernel A: 3x3x3 stride-1 conv + per-channel affine + optional ReLU on a
// channel-first (B, D, Cin, H, W) fp32 volume.
//
// Replaces the TPU kernel rag_tpu/ops/pallas_conv3d.py::_conv3d_pallas_cf
// (bodies _conv3d_kernel through _conv3d_v2_pre, and the H-tiled
// _conv3d_kernel_v3 used at the eval geometry). The two TPU tilings exist
// only for VMEM limits; here one tile engine serves every shape (see
// conv3x3x3_tile.cuh for the design and what bounds it).
#include "conv3x3x3_tile.cuh"

extern "C" int rag_conv3d_brc_cf(const void* x, const void* wpk,
                                 const void* scale, const void* bias,
                                 void* out, int B, int D, int Cin, int H,
                                 int W, int Cout, int co_t, int relu,
                                 void* stream) {
  const rag::VolumeSrc src{static_cast<const float*>(x), D, Cin, H, W};
  return rag::launch_conv3x3x3(
      src, static_cast<const float*>(wpk), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(out), B, D, Cin, H,
      W, Cout, co_t, relu, static_cast<cudaStream_t>(stream));
}
