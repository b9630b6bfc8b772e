// Kernel H: the D-blocked 3x3x3 stride-1 conv + per-channel affine +
// optional ReLU on a channel-first (B, D, Cin, H, W) fp32 volume. The same
// function as kernel A (conv3d.cu), chosen by KernelVariants.conv3d_dblock.
//
// Replaces the TPU kernel rag_tpu/ops/pallas_conv3d.py::_conv3d_pallas_cf in
// its D-blocked form (body _conv3d_kernel_v4, gate RAG_TPU_CONV3D_V4): one
// (db+2)-plane input window serves db output planes, so each input plane is
// staged (db+2)/db times instead of the 3 times of the per-plane tiling.
//
// Bound: operations, as kernel A (2*27*Cin*Cout FLOP per output voxel
// against 4*(Cin+Cout) bytes). Design: one block per (b, kDB = 4 output
// planes, 8x32 output tile, Cout chunk) stages the zero-padded
// (kDB+2, 4 channels, 10, 34) input window once per channel pass in dynamic
// shared memory (46 KB of slab plus the weights: past the 48 KB static
// limit), and each thread keeps kDB planes x 2 pixels x CO_T output channels
// in registers. Every weight read from shared memory then feeds 8 pixels
// (kernel A: 4), and every staged voxel serves up to 3 of the block's output
// planes. The tile engine of kernels A, B and E (conv3x3x3_tile.cuh) is not
// touched: this is a kernel of its own.
//
// Tail planes: D need not divide by kDB. Planes past D stage as zeros (the
// conv's padding) and their outputs are not written. The TPU kernel instead
// required d % db == 0 and a 12 MB VMEM budget; this kernel takes every shape.
#include <cuda_runtime.h>

namespace {

constexpr int kDB = 4;               // output planes per block
constexpr int kTH = 8;               // output rows per block
constexpr int kTW = 32;              // output columns per block
constexpr int kPX = 2;               // output columns per thread, kTX apart
constexpr int kTX = kTW / kPX;       // threads across W (16)
constexpr int kThreads = kTX * kTH;  // 128
constexpr int kCC = 4;               // input channels staged per pass
constexpr int kPL = kDB + 2;         // staged planes (1-plane halo each side)
constexpr int kSH = kTH + 2;         // staged rows
constexpr int kSW = kTW + 2;         // staged columns used
constexpr int kSWP = 48;             // row pitch: 48 % 32 == 16 keeps the two
                                     // rows a warp reads on disjoint banks
constexpr int kSlab = kPL * kCC * kSH * kSWP;  // floats

template <int CO_T>
constexpr int smem_bytes() {
  return (kCC * 27 * CO_T + kSlab) * (int)sizeof(float);
}

// wpk: packed weights (n_co, Cin, 27, CO_T), zero-padded past Cout (the
// layout of kernel A). scale/bias: (n_co * CO_T,). out: (B, D, Cout, H, W).
// Grid: x = n_ht * n_wt, y = ceil(D / kDB), z = B * n_co.
template <int CO_T>
__global__ void __launch_bounds__(kThreads)
conv3x3x3_dblock_kernel(const float* __restrict__ x,
                        const float* __restrict__ wpk,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int D, int Cin, int H, int W,
                        int Cout, int n_wt, int n_co, int relu) {
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                     // [kCC][27][CO_T]
  float* s_in = smem + kCC * 27 * CO_T;  // [kPL][kCC][kSH][kSWP]

  const int wt = blockIdx.x % n_wt;
  const int ht = blockIdx.x / n_wt;
  const int d0 = blockIdx.y * kDB;
  const int b = blockIdx.z / n_co;
  const int cchunk = blockIdx.z % n_co;
  const int h0 = ht * kTH;
  const int w0 = wt * kTW;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  float acc[kDB][kPX][CO_T];
#pragma unroll
  for (int di = 0; di < kDB; ++di)
#pragma unroll
    for (int p = 0; p < kPX; ++p)
#pragma unroll
      for (int co = 0; co < CO_T; ++co) acc[di][p][co] = 0.f;

  const float* wchunk = wpk + (size_t)cchunk * Cin * 27 * CO_T;
  for (int c0 = 0; c0 < Cin; c0 += kCC) {
    // planes d0-1 .. d0+kDB, channels c0.., rows h0-1.., columns w0-1..;
    // zeros outside the volume and past Cin
    for (int i = threadIdx.x; i < kPL * kCC * kSH * kSW; i += kThreads) {
      const int c = i % kSW;
      const int r = (i / kSW) % kSH;
      const int ci = (i / (kSW * kSH)) % kCC;
      const int pl = i / (kSW * kSH * kCC);
      const int d = d0 + pl - 1, h = h0 + r - 1, w = w0 + c - 1;
      const int cc = c0 + ci;
      float v = 0.f;
      if (cc < Cin && d >= 0 && d < D && h >= 0 && h < H && w >= 0 && w < W)
        v = __ldg(x + ((((size_t)b * D + d) * Cin + cc) * H + h) * W + w);
      s_in[((pl * kCC + ci) * kSH + r) * kSWP + c] = v;
    }
    for (int i = threadIdx.x; i < kCC * 27 * CO_T; i += kThreads) {
      const int ci = i / (27 * CO_T);
      s_w[i] = (c0 + ci < Cin) ? __ldg(wchunk + (size_t)c0 * 27 * CO_T + i)
                               : 0.f;
    }
    __syncthreads();
    for (int ci = 0; ci < kCC; ++ci) {
      for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float* wrow = s_w + (ci * 27 + kd * 9 + kh * 3 + kw) * CO_T;
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
#pragma unroll
            for (int di = 0; di < kDB; ++di) {
              // output plane d0+di reads staged plane di+kd (= input d+kd-1)
              const float* row =
                  s_in + (((di + kd) * kCC + ci) * kSH + ty + kh) * kSWP + tx +
                  kw;
#pragma unroll
              for (int p = 0; p < kPX; ++p) {
                const float v = row[p * kTX];
#pragma unroll
                for (int co = 0; co < CO_T; ++co)
                  acc[di][p][co] = fmaf(v, wv[co], acc[di][p][co]);
              }
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
  for (int di = 0; di < kDB; ++di) {
    const int d = d0 + di;
    if (d >= D) break;
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
          float yv = fmaf(acc[di][p][co], a, c);
          if (relu) yv = fmaxf(yv, 0.f);
          orow[w] = yv;
        }
      }
    }
  }
}

template <int CO_T>
int launch(const float* x, const float* wpk, const float* scale,
           const float* bias, float* out, dim3 grid, int D, int Cin, int H,
           int W, int Cout, int n_wt, int n_co, int relu,
           cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3x3_dblock_kernel<CO_T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<CO_T>());
  if (e != cudaSuccess) return (int)e;
  conv3x3x3_dblock_kernel<CO_T><<<grid, kThreads, smem_bytes<CO_T>(), stream>>>(
      x, wpk, scale, bias, out, D, Cin, H, W, Cout, n_wt, n_co, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rag_conv3d_dblock_cf(const void* x, const void* wpk,
                                    const void* scale, const void* bias,
                                    void* out, int B, int D, int Cin, int H,
                                    int W, int Cout, int co_t, int relu,
                                    void* stream) {
  if (B <= 0 || D <= 0 || Cin <= 0 || H <= 0 || W <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_co = (Cout + co_t - 1) / co_t;
  const int n_wt = (W + kTW - 1) / kTW;
  const int n_ht = (H + kTH - 1) / kTH;
  const int n_db = (D + kDB - 1) / kDB;
  if (n_db > 65535 || (long long)B * n_co > 65535 ||
      (long long)n_wt * n_ht > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_wt * n_ht, n_db, B * n_co);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(wpk);
  const float* sf = static_cast<const float*>(scale);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (co_t) {
#define RAG_DBLOCK_CASE(N)                                                   \
  case N:                                                                    \
    return launch<N>(xf, wf, sf, bf, of, grid, D, Cin, H, W, Cout, n_wt,     \
                     n_co, relu, st);
    RAG_DBLOCK_CASE(1)
    RAG_DBLOCK_CASE(4)
    RAG_DBLOCK_CASE(8)
    RAG_DBLOCK_CASE(12)
    RAG_DBLOCK_CASE(16)
#undef RAG_DBLOCK_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
