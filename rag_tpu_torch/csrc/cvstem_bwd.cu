// Kernel F: the matching stem's weight gradient, without the
// (B, D, 2C, H, W) cost volume. (Kernel E, the stem's dX and dY, is
// cvstem_dxy.cu.)
//
// Replaces the TPU kernel rag_tpu/ops/pallas_cvstem.py::cvstem_dw_pallas
// (body _cvstem_dw_kernel): the weight-gradient engine of conv3x3x3_dw.cuh
// with its input slab built from X and Y by the cost-volume load rule
// (CostVolumeSrc), as B builds it from its tile engine. Bound: operations,
// the forward's products that read a voxel of the volume that is not a
// structural zero: 24.0 GFLOP at the train shape, 0.358 ms at 67 TFLOP/s
// (chip_smoke.py::cvstem_dw_bound).
#include "conv3x3x3_dw.cuh"
#include "conv3x3x3_tile.cuh"

extern "C" int rag_cvstem_dw(const void* x, const void* y, const void* dz,
                             void* partial, void* out, int B, int D, int Cin,
                             int Cout, int H, int W, int co_t, void* stream) {
  const rag::CostVolumeSrc src{static_cast<const float*>(x),
                               static_cast<const float*>(y), D, Cin / 2, H, W};
  return rag::launch_dw(src, static_cast<const float*>(dz),
                        static_cast<float*>(partial), static_cast<float*>(out),
                        B, D, Cin, Cout, H, W, co_t,
                        static_cast<cudaStream_t>(stream));
}
