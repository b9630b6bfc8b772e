// The matching stem's backward: kernels E (dX, dY) and F (dW). Neither
// stores the (B, D, 2C, H, W) cost volume or its adjoint.
//
// Kernel E replaces the TPU kernel
// rag_tpu/ops/pallas_cvstem.py::cvstem_dxy_pallas (body _cvstem_dxy_kernel).
// With dv = conv3d(dz, W') where W'[kd,kh,kw,co,ci] = w3[2-kd,2-kh,2-kw,ci,co]
// (the forward conv's adjoint), the adjoint of the volume build is
//   dX[b, c, h, j] = sum_d [j >= d]     dv[b, d, c,     h, j]
//   dY[b, c, h, j] = sum_d [j + d < W]  dv[b, d, C + c, h, j + d]
// Bound: operations (2*27*Cout FLOP per unmasked (d, channel, pixel), 32.6
// GFLOP at the train shape, 0.49 ms at 67 TFLOP/s). Design: one block per
// (b, 8x64 pixel tile, 4 channels of dX and dY) loops over d. For dX it
// stages dz planes d-1..d+1 at the tile's columns, for dY at the columns
// shifted by +d, through kernel A's tile engine (stage_slab, fma_slab);
// the column masks zero a pixel's contribution, and each pixel's sum over
// d stays in registers. No block shares an output with another, so there
// is no cross-block sum.
//
// Kernel F replaces rag_tpu/ops/pallas_cvstem.py::cvstem_dw_pallas (body
// _cvstem_dw_kernel): kernel D's weight-gradient engine with its input slab
// built from X and Y by the cost-volume load rule (CostVolumeSrc), as B
// builds it from A's engine. Bound: operations, 32.6 GFLOP at the train
// shape.
#include "conv3x3x3_dw.cuh"
#include "conv3x3x3_tile.cuh"

namespace {

using namespace rag;

constexpr int kCT = 4;  // dX / dY channels per block

// wpk_x / wpk_y: dx-conv weights packed as (n_c, Cout, 27, kCT) for the X
// and Y halves of the volume's channels. Grid: x = n_ht * n_wt,
// y = n_c = ceil(C / kCT), z = B.
__global__ void __launch_bounds__(kThreads)
cvstem_dxy_kernel(const float* __restrict__ dz, const float* __restrict__ wpk_x,
                  const float* __restrict__ wpk_y, float* __restrict__ dX,
                  float* __restrict__ dY, int D, int Cout, int C, int H, int W,
                  int n_wt) {
  __shared__ float s_in[3][kCC][kSH][kSWP];
  __shared__ __align__(16) float s_w[kCC][27][kCT];

  const int wt = blockIdx.x % n_wt;
  const int ht = blockIdx.x / n_wt;
  const int cchunk = blockIdx.y;
  const int b = blockIdx.z;
  const int h0 = ht * kTH;
  const int w0 = wt * kTW;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const VolumeSrc src{dz, D, Cout, H, W};
  const float* wx = wpk_x + (size_t)cchunk * Cout * 27 * kCT;
  const float* wy = wpk_y + (size_t)cchunk * Cout * 27 * kCT;

  float ax[kPX][kCT], ay[kPX][kCT];
#pragma unroll
  for (int p = 0; p < kPX; ++p)
#pragma unroll
    for (int c = 0; c < kCT; ++c) ax[p][c] = ay[p][c] = 0.f;

  for (int d = 0; d < D; ++d) {
    // dX: pixel j takes plane d's value where j >= d
    if (w0 + kTW - 1 >= d) {
      bool keep[kPX];
#pragma unroll
      for (int p = 0; p < kPX; ++p) keep[p] = w0 + tx + p * kTX >= d;
      for (int c0 = 0; c0 < Cout; c0 += kCC) {
        stage_slab(s_in, src, b, d, c0, Cout, h0, w0);
        stage_weights(s_w, wx, c0, Cout);
        __syncthreads();
        fma_slab<kCT, true>(s_in, s_w, ty, tx, ax, keep);
        __syncthreads();
      }
    }
    // dY: pixel j takes plane d's value at column j + d, where j + d < W
    if (w0 + d < W) {
      bool keep[kPX];
#pragma unroll
      for (int p = 0; p < kPX; ++p) keep[p] = w0 + tx + p * kTX + d < W;
      for (int c0 = 0; c0 < Cout; c0 += kCC) {
        stage_slab(s_in, src, b, d, c0, Cout, h0, w0 + d);
        stage_weights(s_w, wy, c0, Cout);
        __syncthreads();
        fma_slab<kCT, true>(s_in, s_w, ty, tx, ay, keep);
        __syncthreads();
      }
    }
  }

  const int h = h0 + ty;
  if (h >= H) return;
#pragma unroll
  for (int c = 0; c < kCT; ++c) {
    const int cg = cchunk * kCT + c;
    if (cg >= C) break;
    const size_t row = (((size_t)b * C + cg) * H + h) * W;
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
      const int j = w0 + tx + p * kTX;
      if (j < W) {
        dX[row + j] = ax[p][c];
        dY[row + j] = ay[p][c];
      }
    }
  }
}

}  // namespace

extern "C" int rag_cvstem_dxy(const void* dz, const void* wpk_x,
                              const void* wpk_y, void* dX, void* dY, int B,
                              int D, int Cout, int C, int H, int W,
                              void* stream) {
  if (B <= 0 || D <= 0 || Cout <= 0 || C <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_c = (C + kCT - 1) / kCT;
  const int n_wt = (W + kTW - 1) / kTW;
  const int n_ht = (H + kTH - 1) / kTH;
  if (B > 65535 || n_c > 65535 || (long long)n_wt * n_ht > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_wt * n_ht, n_c, B);
  cvstem_dxy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dz), static_cast<const float*>(wpk_x),
      static_cast<const float*>(wpk_y), static_cast<float*>(dX),
      static_cast<float*>(dY), D, Cout, C, H, W, n_wt);
  return (int)cudaGetLastError();
}

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
