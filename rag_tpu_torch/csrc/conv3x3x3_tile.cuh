// Shared tile engine for the two 3x3x3 convolution kernels of the port:
//   kernel A (conv3d.cu): conv over a stored channel-first volume;
//   kernel B (cvstem.cu): conv over the concat cost volume, built on the fly
//                         from the two feature maps (never stored).
//
// Both compute, for a channel-first (B, D, Cin, H, W) input v,
//   out[b, d, co, h, w] = act(scale[co] * sum_{kd,kh,kw,ci}
//        v[b, d+kd-1, ci, h+kh-1, w+kw-1] * W[kd, kh, kw, ci, co] + bias[co])
// with zero padding of 1 on D, H and W (the SAME 3x3x3 stride-1 conv of
// rag_tpu/ops/pallas_conv3d.py and rag_tpu/ops/pallas_cvstem.py). The only
// difference between A and B is where v comes from: a Src policy's load().
//
// Bound: at the eval geometry these convs do 27*2*Cin*Cout FLOP per output
// voxel and move ~4*(Cin+Cout) bytes, so they sit above the fp32 ridge of
// the H100 (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte) and are bound by
// operations. The design therefore keeps every FMA operand on chip:
//   * one block per (b, d, 8x64 output tile, Cout chunk); the haloed input
//     slab for 4 input channels and all three D taps is staged in shared
//     memory (zeros at every D/H/W edge), then reused by 27 taps;
//   * each thread owns 4 output pixels (strided by 16 along W, so a warp's
//     shared-memory reads hit 32 distinct banks) times CO_T output channels,
//     all in registers; the weights of the staged channels sit in shared
//     memory and are read as float4 broadcasts;
//   * the affine (folded frozen BatchNorm) and ReLU run in the epilogue.
// Plain fp32 FMAs (no TF32, no tensor cores): parity with the reference is
// at fp32. A wgmma/TMA design is later work.
#pragma once

#include <cuda_runtime.h>

namespace rag {

constexpr int kTH = 8;              // output rows per block
constexpr int kTW = 64;             // output columns per block
constexpr int kPX = 4;              // output columns per thread
constexpr int kTX = kTW / kPX;      // threads across W (16)
constexpr int kThreads = kTX * kTH; // 128
constexpr int kCC = 4;              // input channels staged per pass
constexpr int kSH = kTH + 2;        // staged rows (1-row halo each side)
constexpr int kSW = kTW + 2;        // staged columns used
constexpr int kSWP = 80;            // row pitch: 80 % 32 == 16 keeps the two
                                    // rows a warp reads on disjoint banks

// Volume source for kernel A: a stored (B, D, C, H, W) tensor.
struct VolumeSrc {
  const float* __restrict__ x;
  int D, C, H, W;
  __device__ __forceinline__ float load(int b, int d, int c, int h,
                                        int w) const {
    if (d < 0 || d >= D || h < 0 || h >= H || w < 0 || w >= W) return 0.f;
    return __ldg(x + ((((size_t)b * D + d) * C + c) * H + h) * W + w);
  }
};

// Cost-volume source for kernel B: the (B, D, 2C, H, W) concat volume of
// rag_tpu/ops/cost_volume.py::cost_volume_cf, read from the two (B, C, H, W)
// feature maps:
//   v[d, c,   h, j] = X[c, h, j]      if j >= d else 0
//   v[d, C+c, h, j] = Y[c, h, j - d]  if j >= d else 0
// Planes d outside [0, D) and positions outside the image are the conv's
// zero padding. Column j - d is read only where j >= d, so the reference's
// clipped (and then masked) source column never leaks into the W halo.
struct CostVolumeSrc {
  const float* __restrict__ x;
  const float* __restrict__ y;
  int D, C, H, W;
  __device__ __forceinline__ float load(int b, int d, int c, int h,
                                        int j) const {
    if (d < 0 || d >= D || h < 0 || h >= H || j < d || j >= W) return 0.f;
    if (c < C) return __ldg(x + (((size_t)b * C + c) * H + h) * W + j);
    return __ldg(y + (((size_t)b * C + (c - C)) * H + h) * W + (j - d));
  }
};

// wpk: packed weights (n_co, Cin, 27, CO_T), zero-padded past Cout.
// scale/bias: (n_co * CO_T,), zero-padded. out: (B, D, Cout, H, W).
// Grid: x = n_ht * n_wt, y = D, z = B * n_co.
template <int CO_T, class Src>
__global__ void __launch_bounds__(kThreads)
conv3x3x3_affine_kernel(Src src, const float* __restrict__ wpk,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int D, int Cin, int H, int W,
                        int Cout, int n_wt, int n_co, int relu) {
  __shared__ float s_in[3][kCC][kSH][kSWP];
  __shared__ __align__(16) float s_w[kCC][27][CO_T];

  const int wt = blockIdx.x % n_wt;
  const int ht = blockIdx.x / n_wt;
  const int d = blockIdx.y;
  const int b = blockIdx.z / n_co;
  const int cchunk = blockIdx.z % n_co;
  const int h0 = ht * kTH;
  const int w0 = wt * kTW;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  float acc[kPX][CO_T];
#pragma unroll
  for (int p = 0; p < kPX; ++p)
#pragma unroll
    for (int co = 0; co < CO_T; ++co) acc[p][co] = 0.f;

  const float* wchunk = wpk + (size_t)cchunk * Cin * 27 * CO_T;
  for (int c0 = 0; c0 < Cin; c0 += kCC) {
    for (int i = threadIdx.x; i < 3 * kCC * kSH * kSW; i += kThreads) {
      const int c = i % kSW;
      const int r = (i / kSW) % kSH;
      const int ci = (i / (kSW * kSH)) % kCC;
      const int dd = i / (kSW * kSH * kCC);
      float v = 0.f;
      if (c0 + ci < Cin)
        v = src.load(b, d + dd - 1, c0 + ci, h0 + r - 1, w0 + c - 1);
      s_in[dd][ci][r][c] = v;
    }
    for (int i = threadIdx.x; i < kCC * 27 * CO_T; i += kThreads) {
      const int ci = i / (27 * CO_T);
      (&s_w[0][0][0])[i] =
          (c0 + ci < Cin) ? __ldg(wchunk + (size_t)c0 * 27 * CO_T + i) : 0.f;
    }
    __syncthreads();

    for (int ci = 0; ci < kCC; ++ci) {
      for (int dd = 0; dd < 3; ++dd) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float* wrow = &s_w[ci][dd * 9 + kh * 3 + kw][0];
            float wv[CO_T];
            if constexpr (CO_T % 4 == 0) {
#pragma unroll
              for (int q = 0; q < CO_T / 4; ++q) {
                const float4 w4 = reinterpret_cast<const float4*>(wrow)[q];
                wv[4 * q] = w4.x;
                wv[4 * q + 1] = w4.y;
                wv[4 * q + 2] = w4.z;
                wv[4 * q + 3] = w4.w;
              }
            } else {
#pragma unroll
              for (int co = 0; co < CO_T; ++co) wv[co] = wrow[co];
            }
            const float* row = &s_in[dd][ci][ty + kh][tx + kw];
#pragma unroll
            for (int p = 0; p < kPX; ++p) {
              const float v = row[p * kTX];
#pragma unroll
              for (int co = 0; co < CO_T; ++co)
                acc[p][co] = fmaf(v, wv[co], acc[p][co]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int h = h0 + ty;
  if (h >= H) return;
#pragma unroll
  for (int co = 0; co < CO_T; ++co) {
    const int cg = cchunk * CO_T + co;
    if (cg >= Cout) break;
    const float a = __ldg(scale + cg);
    const float c = __ldg(bias + cg);
    float* orow = out + ((((size_t)b * D + d) * Cout + cg) * H + h) * W;
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
      const int w = w0 + tx + p * kTX;
      if (w < W) {
        float yv = fmaf(acc[p][co], a, c);
        if (relu) yv = fmaxf(yv, 0.f);
        orow[w] = yv;
      }
    }
  }
}

// Host-side launch shared by both entry points. Returns a cudaError_t.
template <class Src>
int launch_conv3x3x3(const Src& src, const float* wpk, const float* scale,
                     const float* bias, float* out, int B, int D, int Cin,
                     int H, int W, int Cout, int co_t, int relu,
                     cudaStream_t stream) {
  if (B <= 0 || D <= 0 || Cin <= 0 || H <= 0 || W <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_co = (Cout + co_t - 1) / co_t;
  const int n_wt = (W + kTW - 1) / kTW;
  const int n_ht = (H + kTH - 1) / kTH;
  if (D > 65535 || (long long)B * n_co > 65535 ||
      (long long)n_wt * n_ht > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_wt * n_ht, D, B * n_co);
  switch (co_t) {
#define RAG_CONV_CASE(N)                                                    \
  case N:                                                                   \
    conv3x3x3_affine_kernel<N, Src><<<grid, kThreads, 0, stream>>>(         \
        src, wpk, scale, bias, out, D, Cin, H, W, Cout, n_wt, n_co, relu);  \
    break;
    RAG_CONV_CASE(1)
    RAG_CONV_CASE(4)
    RAG_CONV_CASE(8)
    RAG_CONV_CASE(12)
    RAG_CONV_CASE(16)
#undef RAG_CONV_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace rag
