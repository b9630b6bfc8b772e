// Kernel F: the matching stem's weight gradient, without the
// (B, D, 2C, H, W) cost volume; features and dz float32 or bf16, dW
// float32. (Kernel E, the stem's dX and dY, is
// cvstem_dxy.cu.)
//
// Replaces the TPU kernel rag_tpu/ops/pallas_cvstem.py::cvstem_dw_pallas
// (body _cvstem_dw_kernel). It runs kernel D's register-blocked float32
// engine (conv3d_dw.cuh) with the cost-volume input policy
// (volume_src.cuh): each block stages plane p of the volume, one half of
// it at Cin = 24, straight from X or Y where kernel D stages plane p of a
// stored x, and stops where its tile lies left of the diagonal.
// Bound: operations, the forward's products that read a voxel of the
// volume that is not a structural zero: 24.0 GFLOP at the train shape,
// 0.358 ms at 67 TFLOP/s (chip_smoke.py::cvstem_dw_bound).
#include "conv3d_dw.cuh"

// x, y (B, C, H, W) features, dz (B, D, Cout, H, W), out (3, 3, 3, 2C,
// Cout); partial and the blocking (ops/cvstem.py::cvstem_dw_plan) as
// dw_run says, at Cin = 2C.
namespace {

template <class Elem>
int cvstem_dw_entry(const void* x, const void* y, const void* dz,
                    void* partial, void* out, int B, int D, int C, int Cout,
                    int H, int W, int ci, int co_t, int kh_t, int groups,
                    int th, int tw, int db, int passes, void* stream) {
  const rag::CostVolumeSrc<Elem> src{static_cast<const Elem*>(x),
                                     static_cast<const Elem*>(y), D, C, H, W};
  return dw_run(src, static_cast<const Elem*>(dz),
                static_cast<float*>(partial), static_cast<float*>(out), B, D,
                2 * C, Cout, H, W, ci, co_t, kh_t, groups, th, tw, db, passes,
                static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int rag_cvstem_dw(const void* x, const void* y, const void* dz,
                             void* partial, void* out, int B, int D, int C,
                             int Cout, int H, int W, int ci, int co_t,
                             int kh_t, int groups, int th, int tw, int db,
                             int passes, void* stream) {
  return cvstem_dw_entry<float>(x, y, dz, partial, out, B, D, C, Cout, H, W,
                                ci, co_t, kh_t, groups, th, tw, db, passes,
                                stream);
}

// The same with x, y and dz bf16 (dW float32).
extern "C" int rag_cvstem_dw_bf16(const void* x, const void* y,
                                  const void* dz, void* partial, void* out,
                                  int B, int D, int C, int Cout, int H, int W,
                                  int ci, int co_t, int kh_t, int groups,
                                  int th, int tw, int db, int passes,
                                  void* stream) {
  return cvstem_dw_entry<rag::bf16>(x, y, dz, partial, out, B, D, C, Cout, H,
                                    W, ci, co_t, kh_t, groups, th, tw, db,
                                    passes, stream);
}
