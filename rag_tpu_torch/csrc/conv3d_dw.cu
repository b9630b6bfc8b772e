// Kernel D: the weight gradient of the 3x3x3 stride-1 conv over a stored
// channel-first (B, D, Cin, H, W) volume, x and dz float32 or bf16 and dW
// float32, on the register-blocked float32 engine of conv3d_dw.cuh.
//
// Replaces the TPU kernel rag_tpu/ops/pallas_conv3d.py::conv3d_dw_pallas_pre
// (body _conv3d_dw_kernel). Bound on the H100: operations at every train
// shape with Cout >= 4, bytes at the Cout-1 head (conv3d_dw.cuh).
#include "conv3d_dw.cuh"

// x (B, D, Cin, H, W), dz (B, D, Cout, H, W), out (3, 3, 3, Cin, Cout);
// partial and the blocking as dw_run says.
namespace {

template <class Elem>
int dw_entry(const void* x, const void* dz, void* partial, void* out, int B,
             int D, int Cin, int Cout, int H, int W, int ci, int co_t,
             int kh_t, int groups, int th, int tw, int db, int passes,
             void* stream) {
  const rag::VolumeSrc<Elem> src{static_cast<const Elem*>(x), W};
  return dw_run(src, static_cast<const Elem*>(dz),
                static_cast<float*>(partial), static_cast<float*>(out), B, D,
                Cin, Cout, H, W, ci, co_t, kh_t, groups, th, tw, db, passes,
                static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int rag_conv3d_dw_cf(const void* x, const void* dz, void* partial,
                                void* out, int B, int D, int Cin, int Cout,
                                int H, int W, int ci, int co_t, int kh_t,
                                int groups, int th, int tw, int db,
                                int passes, void* stream) {
  return dw_entry<float>(x, dz, partial, out, B, D, Cin, Cout, H, W, ci,
                         co_t, kh_t, groups, th, tw, db, passes, stream);
}

// The same with x and dz bf16 (dW float32).
extern "C" int rag_conv3d_dw_cf_bf16(const void* x, const void* dz,
                                     void* partial, void* out, int B, int D,
                                     int Cin, int Cout, int H, int W, int ci,
                                     int co_t, int kh_t, int groups, int th,
                                     int tw, int db, int passes,
                                     void* stream) {
  return dw_entry<rag::bf16>(x, dz, partial, out, B, D, Cin, Cout, H, W, ci,
                             co_t, kh_t, groups, th, tw, db, passes, stream);
}
