// Kernel A: 3x3x3 stride-1 conv + per-channel affine + optional ReLU on a
// stored channel-first (B, D, Cin, H, W) volume, float32 or bf16 (the
// output in the input's type), on the engine of conv3d.cuh (a 3xTF32
// implicit GEMM on the tensor cores), and kernel H, the same engine with
// four output planes a block.
//
// Replaces the TPU kernel rag_tpu/ops/pallas_conv3d.py::_conv3d_pallas_cf
// (bodies _conv3d_kernel through _conv3d_v2_pre, and the H-tiled
// _conv3d_kernel_v3 used at the eval geometry); kernel H replaces its
// D-blocked form _conv3d_kernel_v4. The TPU tilings exist only for VMEM
// limits; here the tile is planned per shape in Python
// (rag_tpu_torch/ops/conv3d.py::conv_plan, conv_plan_dblock).
//
// Bound: operations (conv3d.cuh).
#include "conv3d.cuh"

namespace {

// x (B, D, Cin, H, W) and out (B, D, Cout, H, W) of element type Elem, w
// (3, 3, 3, Cin, Cout), scale and bias (Cout,) float32; the plan's integers
// and frag as conv_setup says.
template <class Elem>
int conv3d_entry(const void* x, const void* w, void* frag, const void* scale,
                 const void* bias, void* out, int B, int D, int Cin, int H,
                 int W, int Cout, int relu, int mt, int nt, int tw,
                 int n_split, int cc, int db, void* stream) {
  const rag::VolumeSrc<Elem> src{static_cast<const Elem*>(x), W};
  ConvArgs<rag::VolumeSrc<Elem>> a;
  dim3 grid;
  int smem = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = conv_setup(a, grid, smem, src, w, frag, scale, bias, out, B,
                            D, Cin, H, W, Cout, relu, mt, nt, tw, n_split, cc,
                            db, st);
  if (rc != 0) return rc;
#define RAG_CONV_CASE(M, N, DB)        \
  if (mt == M && nt == N && db == DB) \
    return launch<M, N, DB>(a, grid, smem, st);
  RAG_CONV_CASE(2, 1, 1)
  RAG_CONV_CASE(2, 2, 1)
  RAG_CONV_CASE(2, 3, 1)
  RAG_CONV_CASE(2, 4, 1)
  RAG_CONV_CASE(2, 6, 1)
  RAG_CONV_CASE(4, 1, 1)
  RAG_CONV_CASE(4, 2, 1)
  RAG_CONV_CASE(4, 3, 1)
  RAG_CONV_CASE(4, 4, 1)
  RAG_CONV_CASE(2, 1, 4)
  RAG_CONV_CASE(2, 2, 4)
  RAG_CONV_CASE(4, 1, 4)
  RAG_CONV_CASE(2, 3, 4)
#undef RAG_CONV_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rag_conv3d_brc_cf(const void* x, const void* w, void* frag,
                                 const void* scale, const void* bias,
                                 void* out, int B, int D, int Cin, int H,
                                 int W, int Cout, int relu, int mt, int nt,
                                 int tw, int n_split, int cc, int db,
                                 void* stream) {
  return conv3d_entry<float>(x, w, frag, scale, bias, out, B, D, Cin, H, W,
                             Cout, relu, mt, nt, tw, n_split, cc, db, stream);
}

// The same with x and out bf16.
extern "C" int rag_conv3d_brc_cf_bf16(const void* x, const void* w,
                                      void* frag, const void* scale,
                                      const void* bias, void* out, int B,
                                      int D, int Cin, int H, int W, int Cout,
                                      int relu, int mt, int nt, int tw,
                                      int n_split, int cc, int db,
                                      void* stream) {
  return conv3d_entry<rag::bf16>(x, w, frag, scale, bias, out, B, D, Cin, H,
                                 W, Cout, relu, mt, nt, tw, n_split, cc, db,
                                 stream);
}

// Kernel A's first pass alone, for holding it against pack_weights_tf32.
extern "C" int rag_conv3d_pack(const void* w, void* frag, int Cin, int Cout,
                               int nt, int n_split, int cc, void* stream) {
  if (Cin <= 0 || Cout <= 0 || nt <= 0 || n_split <= 0 || cc <= 0 ||
      cc > kMaxCC)
    return (int)cudaErrorInvalidValue;
  const int n_cc = (Cin + cc - 1) / cc, ksteps = (9 * cc + 7) / 8;
  return launch_pack(static_cast<const float*>(w), static_cast<float4*>(frag),
                     32LL * n_split * 3 * n_cc * ksteps * nt, Cin, Cout, cc,
                     n_cc, ksteps, nt, static_cast<cudaStream_t>(stream));
}
