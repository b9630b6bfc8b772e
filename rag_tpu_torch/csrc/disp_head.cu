// Kernel C: the fused disparity head. For a (B, D, h, w) fp32 matching cost
// it computes, per output pixel (H, W) of the (B, scale*h, scale*w) map,
//   y[k]  = trilinear upsample (align_corners=False) of the cost to
//           (maxdisp, scale*h, scale*w), at disparity level k;
//   p     = softmin over k of y;  out = sum_k k * p[k].
// The (B, maxdisp, scale*h, scale*w) upsampled volume (354 MB at the eval
// geometry) is never stored.
//
// Replaces the TPU kernel rag_tpu/ops/pallas_kernels.py::_disp_pallas_raw
// (body _disp_kernel).
//
// Bound: operations. At the eval geometry ~1 GFLOP of interpolation and
// softmin arithmetic (0.015 ms at the fp32 peak) against 13 MB read and
// 1.8 MB written (0.005 ms), both far below the 354 MB the plain version
// moves per intermediate. Design: one thread per output pixel, 128
// consecutive pixels of one output row per block. Each thread first blends
// its 4 (h, w) source taps for every one of the D cost levels into a column
// of shared memory (the H/W interpolation is separable from the D one),
// then walks the maxdisp levels twice: once for the max of -y (as the
// reference softmax subtracts it), once for sum(e) and sum(k * e). The
// interpolation tables (two taps and two weights per output index, per
// axis) are read from the same float32 matrices the reference contracts
// with, so the weights are bit-identical.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;

// tab_i / tab_w: int32 / fp32 (maxdisp + Ho + Wo, 2) tap tables, rows
// [0, maxdisp) for D, then Ho rows for H, then Wo rows for W.
__global__ void __launch_bounds__(kThreads)
soft_argmin_kernel(const float* __restrict__ x, const int* __restrict__ tab_i,
                   const float* __restrict__ tab_w, float* __restrict__ out,
                   int D, int h, int w, int maxdisp, int Ho, int Wo) {
  extern __shared__ float smem[];
  float* s_y = smem;                                   // (D, kThreads)
  int* s_di = reinterpret_cast<int*>(smem + D * kThreads);  // (maxdisp, 2)
  float* s_dw = reinterpret_cast<float*>(s_di + 2 * maxdisp);

  for (int i = threadIdx.x; i < 2 * maxdisp; i += kThreads) {
    s_di[i] = tab_i[i];
    s_dw[i] = tab_w[i];
  }

  const int b = blockIdx.z;
  const int ho = blockIdx.y;
  const int wo = blockIdx.x * kThreads + threadIdx.x;
  const int wc = wo < Wo ? wo : Wo - 1;  // idle lanes compute a real pixel
  const int hr = 2 * (maxdisp + ho);
  const int wr = 2 * (maxdisp + Ho + wc);
  const int h0 = tab_i[hr], h1 = tab_i[hr + 1];
  const float a0 = tab_w[hr], a1 = tab_w[hr + 1];
  const int w0 = tab_i[wr], w1 = tab_i[wr + 1];
  const float b0 = tab_w[wr], b1 = tab_w[wr + 1];

  const size_t plane = (size_t)h * w;
  const float* xb = x + (size_t)b * D * plane;
  for (int k = 0; k < D; ++k) {
    const float* p = xb + k * plane;
    const float r0 = b0 * __ldg(p + h0 * w + w0) + b1 * __ldg(p + h0 * w + w1);
    const float r1 = b0 * __ldg(p + h1 * w + w0) + b1 * __ldg(p + h1 * w + w1);
    s_y[k * kThreads + threadIdx.x] = a0 * r0 + a1 * r1;
  }
  __syncthreads();

  const float* col = s_y + threadIdx.x;
  float zmax = -CUDART_INF_F;
  for (int k = 0; k < maxdisp; ++k) {
    const float yk = s_dw[2 * k] * col[s_di[2 * k] * kThreads] +
                     s_dw[2 * k + 1] * col[s_di[2 * k + 1] * kThreads];
    zmax = fmaxf(zmax, -yk);
  }
  float se = 0.f, sde = 0.f;
  for (int k = 0; k < maxdisp; ++k) {
    const float yk = s_dw[2 * k] * col[s_di[2 * k] * kThreads] +
                     s_dw[2 * k + 1] * col[s_di[2 * k + 1] * kThreads];
    const float e = expf(-yk - zmax);
    se += e;
    sde = fmaf((float)k, e, sde);
  }
  if (wo < Wo) out[((size_t)b * Ho + ho) * Wo + wo] = sde / se;
}

}  // namespace

extern "C" int rag_soft_argmin(const void* x, const void* tab_i,
                               const void* tab_w, void* out, int B, int D,
                               int h, int w, int maxdisp, int Ho, int Wo,
                               void* stream) {
  if (B <= 0 || D <= 0 || h <= 0 || w <= 0 || maxdisp <= 0 || Ho <= 0 ||
      Wo <= 0 || B > 65535 || Ho > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)D * kThreads * sizeof(float) + 2 * (size_t)maxdisp * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        soft_argmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Wo + kThreads - 1) / kThreads, Ho, B);
  soft_argmin_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(tab_i),
      static_cast<const float*>(tab_w), static_cast<float*>(out), D, h, w,
      maxdisp, Ho, Wo);
  return (int)cudaGetLastError();
}
