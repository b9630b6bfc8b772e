// Kernel D: the weight gradient of the 3x3x3 stride-1 conv over a stored
// channel-first (B, D, Cin, H, W) fp32 volume,
//   dW[kd, kh, kw, ci, co] = sum_{b,d,h,w} x[b, d+kd-1, ci, h+kh-1, w+kw-1]
//                                          * dz[b, d, co, h, w].
//
// Replaces the TPU kernel rag_tpu/ops/pallas_conv3d.py::conv3d_dw_pallas_pre
// (body _conv3d_dw_kernel), which accumulated over the (B, D) grid into one
// revisited output block. Here every (b, d) plane's block writes a partial
// and a second kernel sums them in a fixed order (see conv3x3x3_dw.cuh for
// the design and what bounds it).
#include "conv3x3x3_dw.cuh"

extern "C" int rag_conv3d_dw_cf(const void* x, const void* dz, void* partial,
                                void* out, int B, int D, int Cin, int Cout,
                                int H, int W, int co_t, void* stream) {
  const rag::VolumeSrc src{static_cast<const float*>(x), D, Cin, H, W};
  return rag::launch_dw(src, static_cast<const float*>(dz),
                        static_cast<float*>(partial), static_cast<float*>(out),
                        B, D, Cin, Cout, H, W, co_t,
                        static_cast<cudaStream_t>(stream));
}
