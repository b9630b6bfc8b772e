// Kernel E: dX, dY of the matching stem (the concat cost volume fused into
// its 3x3x3 conv), without the (B, D, 2C, H, W) volume or its adjoint.
//
// Replaces the TPU kernel rag_tpu/ops/pallas_cvstem.py::cvstem_dxy_pallas
// (body _cvstem_dxy_kernel). With dv = conv3d(dz, W') where
// W'[kd,kh,kw,co,ch] = w3[2-kd,2-kh,2-kw,ch,co] (the forward conv's adjoint):
//   dX[b, c, h, j] = sum_d [j >= d]     dv[b, d, c,     h, j]
//   dY[b, c, h, j] = sum_d [j + d < W]  dv[b, d, C + c, h, j + d]
//
// Bound: operations. 2*27*Cout FLOP per (d, channel, pixel) the adjoint
// keeps and whose conv reads dz inside the planes: 24.0 GFLOP at the train
// shape dz (4, 64, 12, 64, 128), 0.358 ms at the float32 peak of 67 TFLOP/s
// (chip_smoke.py::cvstem_dxy_bound; 32.6 GFLOP if every product counted).
//
// Design (plain float32 FMAs):
//   * one block per (8x64 pixel tile, chunk of planes d, half, batch, up to
//     12 channels of the half): the dX and dY halves run in separate
//     blocks, and each thread keeps 4 pixels x all 12 channels of its half
//     in registers (48 accumulators), so a staged dz value feeds 12 FMAs
//     per pixel. Splitting d into chunks (16 planes at the train shape)
//     gives 16 tiles x 4 chunks x 2 halves x 4 = 512 blocks, against 192
//     when each block walked all 64 planes for 4 channels of both halves;
//   * each block walks the dz planes q = d0-1 .. d_end of its chunk in
//     order and stages each plane ONCE, all dz channels together, into a
//     two-slot ring in dynamic shared memory: while plane q feeds the three
//     outputs d = q+1, q, q-1 that read it (taps kd = 0, 1, 2), plane q+1
//     streams into the other slot with cp.async (zero-filled at every edge).
//     dv is linear, so adding plane q's three contributions into the same
//     accumulators (each under its own output plane's mask) sums the same
//     products as walking d. The dY half stages plane q at columns
//     w0+q-2 .. w0+q+65, two columns wider than the conv's halo, so one
//     copy serves the three shifts +d of the outputs d = q-1, q, q+1;
//   * the half's 27 x Cout x 12 weights are staged once per block;
//   * blocks whose tile the masks leave empty stop early; every block
//     writes its partial dX or dY to a workspace (n_chunks, B, C, H, W) per
//     half, and a second kernel sums the partials in ascending chunk order:
//     no float atomics, the same bits on every run.
// Shared memory at the train shape: 2 slots x 12 x 10 x 80 floats (76.8 KB)
// plus 15.5 KB of weights, so two blocks (8 warps) per SM; a ring of the
// three planes an output reads plus a prefetch slot would take 169 KB and
// one block. Chunks of 16 planes, chosen by measurement (chip_smoke.py,
// NVIDIA H100 80GB HBM3 at 700 W, train shape, two runs): 1.134 and 1.097
// ms, against 1.136 and 1.147 with chunks of 8 and 1.226 and 1.209 with 4
// (the staged halo planes weigh more); the workspace is then 12.6 MB.
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

using rag::cp_async4;
using rag::cp_async_commit;
using rag::cp_async_wait_all_but_one;

constexpr int kTX = 16;              // threads across W
constexpr int kTY = 8;               // threads (= pixel rows) across H
constexpr int kPX = 4;               // pixels per thread along W, kTX apart
constexpr int kTW = kTX * kPX;       // tile columns (64)
constexpr int kThreads = kTX * kTY;  // 128
constexpr int kSH = kTY + 2;         // staged rows (1-row halo each side)
constexpr int kSW = kTW + 4;         // staged columns: w0-2 .. w0+kTW+1
constexpr int kPitch = 80;           // row pitch: 80 % 32 == 16 keeps the
                                     // two rows a warp reads on other banks

// Issue the copies of dz plane q, channels c0 .. c0+kc-1, rows h0-1 ..
// h0+kTY, columns col0 .. col0+kSW-1 into one ring slot [kc][kSH][kPitch];
// what lies outside the volume is zero-filled. Plane q must be in [0, D).
__device__ __forceinline__ void stage_plane(float* slot,
                                            const float* __restrict__ dz,
                                            int b, int q, int c0, int kc,
                                            int D, int Cout, int H, int W,
                                            int h0, int col0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = warp; row < kc * kSH; row += kThreads / 32) {
    const int co = row / kSH, r = row % kSH;
    const int h = h0 - 1 + r;
    const bool h_ok = h >= 0 && h < H;
    const float* src_row =
        dz + ((((size_t)b * D + q) * Cout + c0 + co) * H + (h_ok ? h : 0)) *
                 (size_t)W;
    float* dst_row = slot + (co * kSH + r) * kPitch;
    for (int col = lane; col < kSW; col += 32) {
      const int j = col0 + col;
      const bool ok = h_ok && j >= 0 && j < W;
      cp_async4(dst_row + col, ok ? src_row + j : dz, ok);
    }
  }
}

// wpk: (2, n_cc, 27, Cout, CT) weights of the X and Y halves, channel chunk
// cc of each zero-padded to CT. partial: (2, n_chunks, B, C, H, W).
// Grid: x = n_ht * n_wt, y = n_chunks, z = B * 2 * n_cc.
template <int CT>
__global__ void __launch_bounds__(kThreads)
cvstem_dxy_partial_kernel(const float* __restrict__ dz,
                          const float* __restrict__ wpk,
                          float* __restrict__ partial, int B, int D, int Cout,
                          int C, int H, int W, int n_wt, int chunk,
                          int n_chunks, int n_cc, int kc_max) {
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                         // [27][kc][CT]
  float* s_ring = smem + 27 * kc_max * CT;   // [2][kc][kSH][kPitch]
  const int slot_floats = kc_max * kSH * kPitch;

  const int wt = blockIdx.x % n_wt;
  const int ht = blockIdx.x / n_wt;
  const int ck = blockIdx.y;
  int z = blockIdx.z;
  const int cc = z % n_cc;
  z /= n_cc;
  const int half = z % 2;
  const int b = z / 2;
  const int h0 = ht * kTY, w0 = wt * kTW;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int d0 = ck * chunk;
  // outputs d of the chunk that reach a pixel of this tile: dX needs
  // j >= d for some j < w0 + kTW, dY needs j + d < W for some j >= w0
  const int d_end = min(min(D, d0 + chunk), half == 0 ? w0 + kTW : W - w0);
  const float* wh = wpk + (size_t)(half * n_cc + cc) * 27 * Cout * CT;

  float acc[kPX][CT];
#pragma unroll
  for (int p = 0; p < kPX; ++p)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[p][c] = 0.f;

  for (int c0 = 0; c0 < Cout && d0 < d_end; c0 += kc_max) {
    const int kc = min(kc_max, Cout - c0);
    __syncthreads();  // the previous channel pass is done with s_w and s_ring
    for (int i = threadIdx.x; i < 27 * kc * CT; i += kThreads) {
      const int tap = i / (kc * CT), rest = i % (kc * CT);
      s_w[i] = __ldg(wh + ((size_t)tap * Cout + c0) * CT + rest);
    }
    // dz planes d0-1 .. d_end feed the outputs d0 .. d_end-1
    const int q_lo = max(d0 - 1, 0), q_hi = min(d_end, D - 1);
    if (q_lo <= q_hi)
      stage_plane(s_ring + (q_lo & 1) * slot_floats, dz, b, q_lo, c0, kc, D,
                  Cout, H, W, h0, w0 - 2 + (half ? q_lo : 0));
    cp_async_commit();
    for (int q = q_lo; q <= q_hi; ++q) {
      if (q + 1 <= q_hi)
        stage_plane(s_ring + ((q + 1) & 1) * slot_floats, dz, b, q + 1, c0,
                    kc, D, Cout, H, W, h0, w0 - 2 + (half ? q + 1 : 0));
      cp_async_commit();
      cp_async_wait_all_but_one();
      __syncthreads();  // plane q (and the weights) visible to every thread
      const float* slab = s_ring + (q & 1) * slot_floats;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const int d = q + 1 - kd;  // the output plane that reads q at tap kd
        if (d < d0 || d >= d_end) continue;
        // staged column of pixel x at tap kw: x + coff + kw
        const int coff = half == 0 ? 1 : 2 - kd;
        bool keep[kPX];
#pragma unroll
        for (int p = 0; p < kPX; ++p) {
          const int j = w0 + tx + p * kTX;
          keep[p] = half == 0 ? j >= d : j + d < W;
        }
        for (int co = 0; co < kc; ++co) {
#pragma unroll
          for (int kh = 0; kh < 3; ++kh) {
            const float* row = slab + (co * kSH + ty + kh) * kPitch + tx + coff;
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
              const float4* w4 = reinterpret_cast<const float4*>(
                  s_w + ((kd * 9 + kh * 3 + kw) * kc + co) * CT);
              float wv[CT];
#pragma unroll
              for (int q4 = 0; q4 < CT / 4; ++q4) {
                const float4 f = w4[q4];
                wv[4 * q4] = f.x;
                wv[4 * q4 + 1] = f.y;
                wv[4 * q4 + 2] = f.z;
                wv[4 * q4 + 3] = f.w;
              }
#pragma unroll
              for (int p = 0; p < kPX; ++p) {
                const float v = keep[p] ? row[kw + p * kTX] : 0.f;
#pragma unroll
                for (int c = 0; c < CT; ++c)
                  acc[p][c] = fmaf(v, wv[c], acc[p][c]);
              }
            }
          }
        }
      }
      __syncthreads();  // done reading plane q's slot before it is refilled
    }
  }

  const int h = h0 + ty;
  if (h >= H) return;
  const size_t n_half = (size_t)B * C * H * W;
  float* part = partial + (size_t)(half * n_chunks + ck) * n_half;
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    const int cg = cc * CT + c;
    if (cg >= C) break;
    float* orow = part + (((size_t)b * C + cg) * H + h) * W;
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
      const int j = w0 + tx + p * kTX;
      if (j < W) orow[j] = acc[p][c];
    }
  }
}

// dX[i] (i < n) and dY[i - n]: the sum of the half's partials over the
// chunks, in ascending chunk order.
__global__ void __launch_bounds__(256)
cvstem_dxy_reduce_kernel(const float* __restrict__ partial,
                         float* __restrict__ dX, float* __restrict__ dY,
                         long long n, int n_chunks) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= 2 * n) return;
  const int half = i >= n;
  const long long k = i - half * n;
  const float* p = partial + (size_t)half * n_chunks * n + k;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += __ldg(p + (size_t)c * n);
  (half ? dY : dX)[k] = s;
}

template <int CT>
int launch(const float* dz, const float* wpk, float* partial, float* dX,
           float* dY, dim3 grid, int B, int D, int Cout, int C, int H, int W,
           int n_wt, int chunk, int n_chunks, int n_cc, int kc,
           cudaStream_t stream) {
  const int smem =
      (27 * kc * CT + 2 * kc * kSH * kPitch) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      cvstem_dxy_partial_kernel<CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cvstem_dxy_partial_kernel<CT><<<grid, kThreads, smem, stream>>>(
      dz, wpk, partial, B, D, Cout, C, H, W, n_wt, chunk, n_chunks, n_cc, kc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)B * C * H * W;
  cvstem_dxy_reduce_kernel<<<(unsigned)((2 * n + 255) / 256), 256, 0,
                             stream>>>(partial, dX, dY, n, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan's integers (rag_tpu_torch/ops/cvstem.py::dxy_plan): ct channels
// of the half per block (n_cc blocks cover C), chunk planes per block
// (n_chunks cover D), kc dz channels staged per pass. partial:
// 2 * n_chunks * B * C * H * W floats of workspace.
extern "C" int rag_cvstem_dxy(const void* dz, const void* wpk, void* partial,
                              void* dX, void* dY, int B, int D, int Cout,
                              int C, int H, int W, int ct, int n_cc,
                              int chunk, int n_chunks, int kc, void* stream) {
  if (B <= 0 || D <= 0 || Cout <= 0 || C <= 0 || H <= 0 || W <= 0 ||
      chunk <= 0 || n_chunks <= 0 || kc <= 0 || n_cc <= 0 ||
      (long long)chunk * n_chunks < D || n_cc * ct < C)
    return (int)cudaErrorInvalidValue;
  const int n_wt = (W + kTW - 1) / kTW;
  const int n_ht = (H + kTY - 1) / kTY;
  if (n_chunks > 65535 || 2LL * B * n_cc > 65535 ||
      (long long)n_wt * n_ht > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_wt * n_ht, n_chunks, 2 * B * n_cc);
  const float* zf = static_cast<const float*>(dz);
  const float* wf = static_cast<const float*>(wpk);
  float* pf = static_cast<float*>(partial);
  float* xf = static_cast<float*>(dX);
  float* yf = static_cast<float*>(dY);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ct) {
#define RAG_DXY_CASE(N)                                                     \
  case N:                                                                   \
    return launch<N>(zf, wf, pf, xf, yf, grid, B, D, Cout, C, H, W, n_wt,   \
                     chunk, n_chunks, n_cc, kc, st);
    RAG_DXY_CASE(4)
    RAG_DXY_CASE(8)
    RAG_DXY_CASE(12)
#undef RAG_DXY_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
