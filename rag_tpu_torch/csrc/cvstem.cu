// Kernel B: the concat cost volume fused into the matching stem's 3x3x3
// conv + folded BatchNorm affine + ReLU, on kernel A's engine (conv3d.cuh:
// a 3xTF32 implicit GEMM on the tensor cores) with the cost-volume input
// policy (volume_src.cuh). The (B, D, 2C, H, W) volume is never stored:
// each stage's haloed slab of it lands in shared memory straight from the
// two (B, C, H, W) feature maps.
//
// Replaces the TPU kernel rag_tpu/ops/pallas_cvstem.py::cvstem_forward_cf
// (body _cvstem_kernel) and its H-tiled form cvstem_forward_cf_v3
// (_cvstem_kernel_v3) used at the eval geometry.
//
// Bound: operations. At the eval geometry the products that read a voxel
// of the volume that is not a structural zero are 45.2 GFLOP against ~5 MB
// of features read and 157 MB written: 0.675 ms at the float32 peak
// outside the tensor cores (chip_smoke.py::cvstem_bound); the 315 MB
// volume the plain version builds (and reads three times through the
// conv) costs nothing here. At Cin = 24 the plan stages one half of the
// volume (12 channels, K = 108 padded to 112) per stage and pads Cout 12
// to two n-tiles (ops/cvstem.py::cvstem_plan).
#include "conv3d.cuh"

// x, y (B, C, H, W) features, w (3, 3, 3, 2C, Cout), scale and bias
// (Cout,), out (B, num_disp, Cout, H, W); the plan's integers and frag as
// conv_setup says, at Cin = 2C.
extern "C" int rag_cvstem_brc(const void* x, const void* y, const void* w,
                              void* frag, const void* scale, const void* bias,
                              void* out, int B, int C, int H, int W,
                              int num_disp, int Cout, int relu, int mt, int nt,
                              int tw, int n_split, int cc, int db,
                              void* stream) {
  const rag::CostVolumeSrc src{static_cast<const float*>(x),
                               static_cast<const float*>(y), num_disp, C, H,
                               W};
  ConvArgs<rag::CostVolumeSrc> a;
  dim3 grid;
  int smem = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = conv_setup(a, grid, smem, src, w, frag, scale, bias, out, B,
                            num_disp, 2 * C, H, W, Cout, relu, mt, nt, tw,
                            n_split, cc, db, st);
  if (rc != 0) return rc;
  // ops/cvstem.py::CVSTEM_INSTANCES
#define RAG_CONV_CASE(M, N, DB)        \
  if (mt == M && nt == N && db == DB) \
    return launch<M, N, DB>(a, grid, smem, st);
  RAG_CONV_CASE(2, 1, 1)
  RAG_CONV_CASE(2, 2, 1)
  RAG_CONV_CASE(4, 1, 1)
  RAG_CONV_CASE(4, 2, 1)
  RAG_CONV_CASE(2, 1, 4)
  RAG_CONV_CASE(2, 2, 4)
  RAG_CONV_CASE(4, 1, 4)
#undef RAG_CONV_CASE
  return (int)cudaErrorInvalidValue;
}
