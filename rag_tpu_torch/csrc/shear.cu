// The shear-collapsed matching stem: kernel J (forward assembly) and kernel K
// (its adjoint). Together with eighteen (3,1) convs on the feature maps
// (PyTorch, outside the kernels) they compute the same stem_3d0 output as
// kernel B, conv3d(cost_volume(X, Y, D), w3), without the volume.
//
// The tap maps, t = 3*dd + dw (dd the conv's D tap, dw its W tap):
//   px[b, t, co, h, j] = conv31(X shifted by dw-1 along W, Wx[dd, :, dw])
//   py[b, t, co, h, j] = conv31(Y, Wy[dd, :, dw])
// With s = d + dd - dw and the D-pad gate g(v) = [0 <= v < D]:
//   z[b,d,co,h,j] = sum_{dd,dw} g(d+dd-1) [j >= s]
//                   (px[b,t,co,h,j] + [j <= W-dw] py[b,t,co,h,j-s])
// s ranges over d-2 .. d+2 and may be negative or past W. Where the gate
// holds, d+dd >= 1, so j - s lies in [0, W) whenever both masks hold: every
// index is direct, nothing wraps (the TPU kernel pads W to 128 lanes so that
// its rolls wrap into zeros).
//
// Kernel J replaces rag_tpu/ops/pallas_shear.py::shear_forward (body
// _shear_kernel, gate RAG_TPU_CVSTEM_SHEAR), with its per-channel affine and
// optional ReLU epilogue (frozen BatchNorm folds into it when serving).
// Bound: bytes. At the eval geometry it reads the two 9-map stacks (44 MB)
// and writes the 157 MB output, ~0.06 ms at 3.35 TB/s, for at most 18 adds
// per output. Design: one thread per (b, co, h, j) walks the D output planes
// of its pixel: its nine px values stay in registers, and its py reads at
// j - s slide by one column per plane, so a warp's window stays in L1; every
// tap map is read from device memory about once. (The first version, one
// thread per output element, re-read the maps from device memory for each
// of the D planes, since the streaming output evicts them from L2, and took
// 16x its bound.) The writes are coalesced along W. The terms are added in
// the TPU kernel's order (t ascending, px then py).
//
// Kernel K replaces rag_tpu/ops/pallas_shear.py::shear_adjoint (body
// _shear_adj_kernel): dz (B, D, co, H, W) -> dpx, dpy (B, 9, co, H, W),
//   dpx[t, j] = sum_d g(d+dd-1) [j >= s] dz[d, j]
//   dpy[t, i] = sum_d g(d+dd-1) [0 <= i+s < W] [i+s <= W-dw] dz[d, i+s]
// The TPU kernel accumulates over its sequential d grid into revisited output
// blocks; here blocks run in parallel, so each thread owns the 18 outputs of
// one (b, co, h, j) and loops over d inside, in ascending order: no float
// atomics, the same result on every run. Bound: bytes, dz read once (101 MB
// at the train shape) and 18 maps written (28 MB), ~0.04 ms.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
shear_fwd_kernel(const float* __restrict__ px, const float* __restrict__ py,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int B, int D, int Co, int H, int W, int relu) {
  const int hw = blockIdx.x * kThreads + threadIdx.x;
  if (hw >= H * W) return;
  const int h = hw / W;
  const int j = hw - h * W;
  const size_t plane = (size_t)Co * H * W;  // one tap map, one output plane
  // one (b, co) per grid row; the thread walks the D output planes of its
  // pixel, its nine px values in registers
  for (int p = blockIdx.y; p < B * Co; p += gridDim.y) {
    const int co = p % Co;
    const int b = p / Co;
    const size_t pix = (size_t)b * 9 * plane + (size_t)co * H * W + hw;
    const float* pyrow = py + pix - j;  // tap 0's row of py
    float xv[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) xv[t] = __ldg(px + pix + t * plane);
    const float a = __ldg(scale + co);
    const float c = __ldg(bias + co);
    float* o = out + (size_t)b * D * plane + (size_t)co * H * W + hw;
    for (int d = 0; d < D; ++d) {
      float acc = 0.f;
#pragma unroll
      for (int dd = 0; dd < 3; ++dd) {
        const int dv = d + dd - 1;
        if (dv < 0 || dv > D - 1) continue;
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const int s = d + dd - dw;
          if (j < s) continue;
          const int t = 3 * dd + dw;
          acc += xv[t];
          if (j <= W - dw) acc += __ldg(pyrow + t * plane + (j - s));
        }
      }
      float y = acc * a + c;
      if (relu) y = fmaxf(y, 0.f);
      o[(size_t)d * plane] = y;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
shear_adj_kernel(const float* __restrict__ dz, float* __restrict__ dpx,
                 float* __restrict__ dpy, int B, int D, int Co, int H,
                 int W) {
  const int hw = blockIdx.x * kThreads + threadIdx.x;
  if (hw >= H * W) return;
  const int h = hw / W;
  const int j = hw - h * W;
  const size_t plane = (size_t)Co * H * W;  // one d plane of dz, one tap map
  // one (b, co) per grid row; the thread owns its 18 outputs
  for (int p = blockIdx.y; p < B * Co; p += gridDim.y) {
    const int co = p % Co;
    const int b = p / Co;
    float ax[9], ay[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) ax[t] = ay[t] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float* zrow =
          dz + ((size_t)b * D + d) * plane + ((size_t)co * H + h) * W;
      const float g = __ldg(zrow + j);
#pragma unroll
      for (int dd = 0; dd < 3; ++dd) {
        const int dv = d + dd - 1;
        if (dv < 0 || dv > D - 1) continue;
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const int s = d + dd - dw;
          if (j >= s) ax[3 * dd + dw] += g;
          const int jj = j + s;  // the output column that read py at j
          if (jj >= 0 && jj < W && jj <= W - dw)
            ay[3 * dd + dw] += __ldg(zrow + jj);
        }
      }
    }
    const size_t out0 = (size_t)b * 9 * plane + (size_t)co * H * W + hw;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      dpx[out0 + t * plane] = ax[t];
      dpy[out0 + t * plane] = ay[t];
    }
  }
}

// x: the (H*W) pixels of a plane, kThreads a block; y: the planes, looped
// past the grid's limit
dim3 plane_grid(int H, int W, int planes) {
  return dim3((unsigned)((H * W + kThreads - 1) / kThreads),
              (unsigned)(planes < 65535 ? planes : 65535));
}

bool bad_shape(int B, int D, int Co, int H, int W) {
  return B <= 0 || D <= 0 || Co <= 0 || H <= 0 || W <= 0 ||
         (long long)H * W > 2147483647LL ||
         (long long)B * D * Co > 2147483647LL;
}

}  // namespace

// px, py: (B, 9, Co, H, W); scale, bias: (Co,); out: (B, D, Co, H, W).
extern "C" int rag_shear_fwd(const void* px, const void* py,
                             const void* scale, const void* bias, void* out,
                             int B, int D, int Co, int H, int W, int relu,
                             void* stream) {
  if (bad_shape(B, D, Co, H, W)) return (int)cudaErrorInvalidValue;
  shear_fwd_kernel<<<plane_grid(H, W, B * Co), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), B, D, Co, H, W, relu);
  return (int)cudaGetLastError();
}

// dz: (B, D, Co, H, W); dpx, dpy: (B, 9, Co, H, W).
extern "C" int rag_shear_adj(const void* dz, void* dpx, void* dpy, int B,
                             int D, int Co, int H, int W, void* stream) {
  if (bad_shape(B, D, Co, H, W)) return (int)cudaErrorInvalidValue;
  shear_adj_kernel<<<plane_grid(H, W, B * Co), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dz), static_cast<float*>(dpx),
      static_cast<float*>(dpy), B, D, Co, H, W);
  return (int)cudaGetLastError();
}
