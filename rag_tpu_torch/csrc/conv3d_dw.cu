// Kernel D: the weight gradient of the 3x3x3 stride-1 conv over a stored
// channel-first (B, D, Cin, H, W) fp32 volume, on the register-blocked
// float32 engine of conv3d_dw.cuh.
//
// Replaces the TPU kernel rag_tpu/ops/pallas_conv3d.py::conv3d_dw_pallas_pre
// (body _conv3d_dw_kernel). Bound on the H100: operations at every train
// shape with Cout >= 4, bytes at the Cout-1 head (conv3d_dw.cuh).
#include "conv3d_dw.cuh"

// x (B, D, Cin, H, W), dz (B, D, Cout, H, W), out (3, 3, 3, Cin, Cout);
// partial and the blocking as dw_run says.
extern "C" int rag_conv3d_dw_cf(const void* x, const void* dz, void* partial,
                                void* out, int B, int D, int Cin, int Cout,
                                int H, int W, int ci, int co_t, int kh_t,
                                int groups, int th, int tw, int db,
                                int passes, void* stream) {
  const rag::VolumeSrc src{static_cast<const float*>(x), W};
  return dw_run(src, static_cast<const float*>(dz),
                static_cast<float*>(partial), static_cast<float*>(out), B, D,
                Cin, Cout, H, W, ci, co_t, kh_t, groups, th, tw, db, passes,
                static_cast<cudaStream_t>(stream));
}
