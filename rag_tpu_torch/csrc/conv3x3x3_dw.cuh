// Weight-gradient engine of kernel F (cvstem_bwd.cu): dW of the matching
// stem, whose input is the concat cost volume built on the fly from the two
// feature maps (CostVolumeSrc). It serves F alone: kernel D has its own
// register-blocked engine (conv3d_dw.cu), which F is to move onto.
// For a channel-first (B, D, Cin, H, W) input v and the pre-affine output's
// cotangent dz (B, D, Cout, H, W) it computes
//   dW[kd, kh, kw, ci, co] = sum_{b,d,h,w} v[b, d+kd-1, ci, h+kh-1, w+kw-1]
//                                          * dz[b, d, co, h, w]
// with the forward's zero padding of 1 on D, H and W.
//
// As a matrix product this is (27 Cin) x (B D H W) times (B D H W) x Cout:
// a long reduction into a small output. On the TPU the grid ran in order
// and carried the sum in one revisited output block; here blocks run in
// parallel, so
//   * one block per ((b, d) plane, 4 input channels, CO_T output channels)
//     walks its plane in 8x32 tiles: it stages the haloed input slab
//     (3 planes x 4 channels x 10 x 34) and the dz tile in shared memory,
//     and each of 108 threads owns one (channel, tap) pair and CO_T
//     outputs in registers. All threads of a warp read the same dz
//     position at once (a broadcast), so each FMA costs a quarter of a
//     shared-memory load. Every tile's sum is formed apart and then added,
//     which keeps the float32 error of the 8192-term plane sums small;
//   * the block writes its plane's partial dW to a workspace, and a second
//     kernel sums the B*D partials of every output in plane order.
// No float atomics: the result is the same on every run.
//
// Bound: operations (2*27*Cin*Cout FLOP per position against 4*(Cin+Cout)
// bytes). Plain fp32 FMAs, no tensor cores: parity first.
#pragma once

#include <climits>

#include <cuda_runtime.h>

#include "conv3x3x3_tile.cuh"

namespace rag {

constexpr int kDwTH = 8;                 // tile rows
constexpr int kDwTW = 32;                // tile columns
constexpr int kDwP = kDwTH * kDwTW;      // positions per tile
constexpr int kDwCI = 4;                 // input channels per block
constexpr int kDwThreads = 128;          // 27 * kDwCI = 108 accumulate
constexpr int kDwSH = kDwTH + 2;
constexpr int kDwSW = kDwTW + 2;

// partial: (B*D, 27, Cin, Cout). Grid: x = B*D, y = n_ci, z = n_co.
template <int CO_T, class Src>
__global__ void __launch_bounds__(kDwThreads)
conv3x3x3_dw_partial_kernel(Src src, const float* __restrict__ dz,
                            float* __restrict__ partial, int D, int Cin,
                            int Cout, int H, int W) {
  // dz row pitch: a multiple of 4 (float4 reads) that spreads the
  // staging stores over the banks
  constexpr int P = CO_T % 8 == 0 ? CO_T + 4 : CO_T;
  __shared__ float s_x[3][kDwCI][kDwSH][kDwSW];
  __shared__ __align__(16) float s_dz[kDwP][P];

  const int plane = blockIdx.x;
  const int b = plane / D;
  const int d = plane % D;
  const int ci0 = blockIdx.y * kDwCI;
  const int co0 = blockIdx.z * CO_T;
  const int ci_l = threadIdx.x / 27;
  const int tap = threadIdx.x % 27;
  const bool active = threadIdx.x < 27 * kDwCI;
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  const float* dzp = dz + (size_t)plane * Cout * H * W;

  float acc[CO_T];
#pragma unroll
  for (int co = 0; co < CO_T; ++co) acc[co] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kDwTH) {
    for (int w0 = 0; w0 < W; w0 += kDwTW) {
      for (int i = threadIdx.x; i < 3 * kDwCI * kDwSH * kDwSW;
           i += kDwThreads) {
        const int c = i % kDwSW;
        const int r = (i / kDwSW) % kDwSH;
        const int ci = (i / (kDwSW * kDwSH)) % kDwCI;
        const int dd = i / (kDwSW * kDwSH * kDwCI);
        float v = 0.f;
        if (ci0 + ci < Cin)
          v = src.load(b, d + dd - 1, ci0 + ci, h0 + r - 1, w0 + c - 1);
        s_x[dd][ci][r][c] = v;
      }
      for (int i = threadIdx.x; i < CO_T * kDwP; i += kDwThreads) {
        const int p = i % kDwP;
        const int co = i / kDwP;
        const int h = h0 + p / kDwTW;
        const int w = w0 + p % kDwTW;
        float v = 0.f;
        if (co0 + co < Cout && h < H && w < W)
          v = __ldg(dzp + ((size_t)(co0 + co) * H + h) * W + w);
        s_dz[p][co] = v;
      }
      __syncthreads();

      if (active) {
        float tile[CO_T];
#pragma unroll
        for (int co = 0; co < CO_T; ++co) tile[co] = 0.f;
        const float* xs = &s_x[kd][ci_l][kh][kw];
        for (int r = 0; r < kDwTH; ++r) {
#pragma unroll 4
          for (int c = 0; c < kDwTW; ++c) {
            const float xv = xs[r * kDwSW + c];
            const float* g = &s_dz[r * kDwTW + c][0];
            if constexpr (CO_T % 4 == 0) {
#pragma unroll
              for (int q = 0; q < CO_T / 4; ++q) {
                const float4 g4 = reinterpret_cast<const float4*>(g)[q];
                tile[4 * q] = fmaf(xv, g4.x, tile[4 * q]);
                tile[4 * q + 1] = fmaf(xv, g4.y, tile[4 * q + 1]);
                tile[4 * q + 2] = fmaf(xv, g4.z, tile[4 * q + 2]);
                tile[4 * q + 3] = fmaf(xv, g4.w, tile[4 * q + 3]);
              }
            } else {
#pragma unroll
              for (int co = 0; co < CO_T; ++co)
                tile[co] = fmaf(xv, g[co], tile[co]);
            }
          }
        }
#pragma unroll
        for (int co = 0; co < CO_T; ++co) acc[co] += tile[co];
      }
      __syncthreads();
    }
  }

  if (active && ci0 + ci_l < Cin) {
    float* out = partial + ((size_t)plane * 27 + tap) * Cin * Cout +
                 (size_t)(ci0 + ci_l) * Cout + co0;
#pragma unroll
    for (int co = 0; co < CO_T; ++co)
      if (co0 + co < Cout) out[co] = acc[co];
  }
}

// out[i] = sum over planes, in plane order, of partial[plane][i].
template <int kBlock>
__global__ void __launch_bounds__(kBlock)
dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                 int n_planes, int n_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_out) return;
  float s = 0.f;
  for (int p = 0; p < n_planes; ++p) s += __ldg(partial + (size_t)p * n_out + i);
  out[i] = s;
}

// Host-side launch of both passes on one stream. out: (3,3,3,Cin,Cout);
// partial: B*D*27*Cin*Cout floats of workspace. Returns a cudaError_t.
template <class Src>
int launch_dw(const Src& src, const float* dz, float* partial, float* out,
              int B, int D, int Cin, int Cout, int H, int W, int co_t,
              cudaStream_t stream) {
  if (B <= 0 || D <= 0 || Cin <= 0 || Cout <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_ci = (Cin + kDwCI - 1) / kDwCI;
  const int n_co = (Cout + co_t - 1) / co_t;
  const long long n_out = 27LL * Cin * Cout;
  if ((long long)B * D > INT_MAX || n_ci > 65535 || n_co > 65535 ||
      n_out > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * D, n_ci, n_co);
  switch (co_t) {
#define RAG_DW_CASE(N)                                                      \
  case N:                                                                   \
    conv3x3x3_dw_partial_kernel<N, Src><<<grid, kDwThreads, 0, stream>>>(   \
        src, dz, partial, D, Cin, Cout, H, W);                              \
    break;
    RAG_DW_CASE(1)
    RAG_DW_CASE(4)
    RAG_DW_CASE(8)
    RAG_DW_CASE(12)
    RAG_DW_CASE(16)
#undef RAG_DW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int kBlock = 256;
  dw_reduce_kernel<kBlock><<<(int)((n_out + kBlock - 1) / kBlock), kBlock, 0,
                             stream>>>(partial, out, B * D, (int)n_out);
  return (int)cudaGetLastError();
}

}  // namespace rag
