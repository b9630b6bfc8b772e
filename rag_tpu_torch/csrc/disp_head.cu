// Kernels C and G: the fused disparity head and its backward.
//
// Kernel C. For a (B, D, h, w) fp32 matching cost
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
//
// Kernel G replaces rag_tpu/ops/pallas_kernels.py::_disp_bwd_pallas (body
// _disp_bwd_kernel): dx = U_d^T U_h^T U_w^T dy with dy_k = -p_k (k - out) g.
// Bound: operations, about the forward's arithmetic again plus the D fold
// (~0.4 GFLOP at the train shape) against 6.7 MB in and 8.4 MB out. Two
// deterministic passes, no atomics: pass 1 is kernel C's thread-per-pixel
// walk once more, with a third walk that folds dy through the D taps into
// a (B, D, Ho, Wo) workspace; pass 2 gives each input voxel one thread that
// gathers the workspace over the output rows and columns whose H/W taps
// read it (inverse tap lists built on the host from the same matrices).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;

// Shared-memory layout of one block of kernels C and G: the D blended cost
// levels of each thread's pixel, column-major by thread, then the D-axis tap
// table. s_extra columns (kernel G's fold) sit between the two.
struct HeadSmem {
  float* s_y;   // (D, kThreads)
  int* s_di;    // (maxdisp, 2)
  float* s_dw;  // (maxdisp, 2)
};

__device__ __forceinline__ HeadSmem head_smem(float* smem, int D, int extra,
                                              int maxdisp) {
  HeadSmem m;
  m.s_y = smem;
  m.s_di = reinterpret_cast<int*>(smem + (D + extra) * kThreads);
  m.s_dw = reinterpret_cast<float*>(m.s_di + 2 * maxdisp);
  return m;
}

// Load the D taps table and blend this thread's pixel's H/W taps for every
// cost level into its s_y column. Returns the clamped output column (idle
// lanes past Wo compute a real pixel and store nothing).
__device__ __forceinline__ void blend_pixel(
    const HeadSmem& m, const float* __restrict__ x,
    const int* __restrict__ tab_i, const float* __restrict__ tab_w, int b,
    int ho, int wo, int D, int h, int w, int maxdisp, int Ho, int Wo) {
  for (int i = threadIdx.x; i < 2 * maxdisp; i += kThreads) {
    m.s_di[i] = tab_i[i];
    m.s_dw[i] = tab_w[i];
  }
  const int wc = wo < Wo ? wo : Wo - 1;
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
    m.s_y[k * kThreads + threadIdx.x] = a0 * r0 + a1 * r1;
  }
  __syncthreads();
}

// The upsampled cost at disparity level k of this thread's pixel.
__device__ __forceinline__ float level(const HeadSmem& m, const float* col,
                                       int k) {
  return m.s_dw[2 * k] * col[m.s_di[2 * k] * kThreads] +
         m.s_dw[2 * k + 1] * col[m.s_di[2 * k + 1] * kThreads];
}

// Softmin statistics over the maxdisp levels: the max of -y (subtracted
// as the reference's softmax does), sum(e) and sum(k * e).
__device__ __forceinline__ void softmin_sums(const HeadSmem& m,
                                             const float* col, int maxdisp,
                                             float& zmax, float& se,
                                             float& sde) {
  zmax = -CUDART_INF_F;
  for (int k = 0; k < maxdisp; ++k) zmax = fmaxf(zmax, -level(m, col, k));
  se = 0.f;
  sde = 0.f;
  for (int k = 0; k < maxdisp; ++k) {
    const float e = expf(-level(m, col, k) - zmax);
    se += e;
    sde = fmaf((float)k, e, sde);
  }
}

// tab_i / tab_w: int32 / fp32 (maxdisp + Ho + Wo, 2) tap tables, rows
// [0, maxdisp) for D, then Ho rows for H, then Wo rows for W.
__global__ void __launch_bounds__(kThreads)
soft_argmin_kernel(const float* __restrict__ x, const int* __restrict__ tab_i,
                   const float* __restrict__ tab_w, float* __restrict__ out,
                   int D, int h, int w, int maxdisp, int Ho, int Wo) {
  extern __shared__ float smem[];
  const HeadSmem m = head_smem(smem, D, 0, maxdisp);
  const int b = blockIdx.z;
  const int ho = blockIdx.y;
  const int wo = blockIdx.x * kThreads + threadIdx.x;
  blend_pixel(m, x, tab_i, tab_w, b, ho, wo, D, h, w, maxdisp, Ho, Wo);
  float zmax, se, sde;
  softmin_sums(m, m.s_y + threadIdx.x, maxdisp, zmax, se, sde);
  if (wo < Wo) out[((size_t)b * Ho + ho) * Wo + wo] = sde / se;
}

// Kernel G, pass 1: per output pixel, recompute the softmin as kernel C
// does, form dy_k = -p_k (k - out) g and fold it through the D taps:
// e[b, d, ho, wo] = sum_k U_d[k, d] dy_k.
__global__ void __launch_bounds__(kThreads)
soft_argmin_fold_kernel(const float* __restrict__ x,
                        const float* __restrict__ g,
                        const int* __restrict__ tab_i,
                        const float* __restrict__ tab_w, float* __restrict__ e,
                        int D, int h, int w, int maxdisp, int Ho, int Wo) {
  extern __shared__ float smem[];
  const HeadSmem m = head_smem(smem, D, D, maxdisp);
  const int b = blockIdx.z;
  const int ho = blockIdx.y;
  const int wo = blockIdx.x * kThreads + threadIdx.x;
  blend_pixel(m, x, tab_i, tab_w, b, ho, wo, D, h, w, maxdisp, Ho, Wo);
  const float* col = m.s_y + threadIdx.x;
  float zmax, se, sde;
  softmin_sums(m, col, maxdisp, zmax, se, sde);
  const float out = sde / se;
  const float gv = wo < Wo ? __ldg(g + ((size_t)b * Ho + ho) * Wo + wo) : 0.f;

  float* ecol = m.s_y + D * kThreads + threadIdx.x;   // (D, kThreads)
  for (int k = 0; k < D; ++k) ecol[k * kThreads] = 0.f;
  for (int k = 0; k < maxdisp; ++k) {
    const float p = expf(-level(m, col, k) - zmax) / se;
    const float dy = -p * ((float)k - out) * gv;
    ecol[m.s_di[2 * k] * kThreads] += m.s_dw[2 * k] * dy;
    ecol[m.s_di[2 * k + 1] * kThreads] += m.s_dw[2 * k + 1] * dy;
  }
  if (wo < Wo)
    for (int k = 0; k < D; ++k)
      e[(((size_t)b * D + k) * Ho + ho) * Wo + wo] = ecol[k * kThreads];
}

// Kernel G, pass 2: per input voxel (b, d, hi, wi), gather e over the
// output rows and columns whose H/W taps read it. ih/wh: (h, KH) output
// rows and weights per input row; iw/ww: (w, KW) the same per column;
// padding entries carry weight 0.
__global__ void __launch_bounds__(kThreads)
soft_argmin_gather_kernel(const float* __restrict__ e,
                          const int* __restrict__ ih,
                          const float* __restrict__ wh,
                          const int* __restrict__ iw,
                          const float* __restrict__ ww, float* __restrict__ dx,
                          int h, int w, int Ho, int Wo, int KH, int KW,
                          long long total) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int wi = (int)(idx % w);
  const int hi = (int)((idx / w) % h);
  const float* eb = e + (size_t)(idx / ((long long)w * h)) * Ho * Wo;
  float acc = 0.f;
  for (int i = 0; i < KH; ++i) {
    const float a = __ldg(wh + hi * KH + i);
    if (a == 0.f) continue;
    const float* row = eb + (size_t)__ldg(ih + hi * KH + i) * Wo;
    float r = 0.f;
    for (int j = 0; j < KW; ++j)
      r = fmaf(__ldg(ww + wi * KW + j), __ldg(row + __ldg(iw + wi * KW + j)),
               r);
    acc = fmaf(a, r, acc);
  }
  dx[idx] = acc;
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  if (const int e = set_smem((const void*)soft_argmin_kernel, smem)) return e;
  const dim3 grid((Wo + kThreads - 1) / kThreads, Ho, B);
  soft_argmin_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(tab_i),
      static_cast<const float*>(tab_w), static_cast<float*>(out), D, h, w,
      maxdisp, Ho, Wo);
  return (int)cudaGetLastError();
}

extern "C" int rag_soft_argmin_bwd(const void* x, const void* g,
                                   const void* tab_i, const void* tab_w,
                                   const void* ih, const void* wh,
                                   const void* iw, const void* ww, void* e,
                                   void* dx, int B, int D, int h, int w,
                                   int maxdisp, int Ho, int Wo, int KH, int KW,
                                   void* stream) {
  if (B <= 0 || D <= 0 || h <= 0 || w <= 0 || maxdisp <= 0 || Ho <= 0 ||
      Wo <= 0 || KH <= 0 || KW <= 0 || B > 65535 || Ho > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      2 * (size_t)D * kThreads * sizeof(float) + 2 * (size_t)maxdisp * 8;
  if (const int err = set_smem((const void*)soft_argmin_fold_kernel, smem))
    return err;
  const dim3 grid((Wo + kThreads - 1) / kThreads, Ho, B);
  soft_argmin_fold_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const int*>(tab_i), static_cast<const float*>(tab_w),
      static_cast<float*>(e), D, h, w, maxdisp, Ho, Wo);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * D * h * w;
  soft_argmin_gather_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                              kThreads, 0, st>>>(
      static_cast<const float*>(e), static_cast<const int*>(ih),
      static_cast<const float*>(wh), static_cast<const int*>(iw),
      static_cast<const float*>(ww), static_cast<float*>(dx), h, w, Ho, Wo, KH,
      KW, total);
  return (int)cudaGetLastError();
}
