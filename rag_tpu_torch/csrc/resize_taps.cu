// Kernel I: trilinear resize of a channel-first (B, D, C, H, W) fp32 volume
// to (B, D2, C, H2, W2) from per-axis tap tables, for the forward resize and
// for its adjoint (the same kernel on the transposed tables).
//
// Replaces the TPU kernel rag_tpu/ops/pallas_resize.py::_resize_cf_pallas
// (body _resize_kernel, gate RAG_TPU_RESIZE_KERNEL). That kernel blends K
// source D-slabs by tap and contracts H and W with dense interpolation
// matrices in VMEM; here every axis is a gather over its taps:
//   out[b, o_d, c, o_h, o_w] = sum_a wd[o_d, a] * sum_q wh[o_h, q]
//        * sum_k ww[o_w, k] * x[b, id[o_d, a], c, ih[o_h, q], iw[o_w, k]]
// with (n_out, K) index and weight tables per axis, built on the host from
// the same float32 interpolation matrices the plain version contracts with
// (rag_tpu/ops/pallas_resize.py::_taps_np). K is 2 for a linear resize; the
// adjoint tables of the model's resizes have up to 4 (a 2x upsample's; 3
// for an odd-size upsample, 1 for a 2x downsample). Padded taps have
// weight 0 and index 0. An axis whose size does not change has the one-tap identity
// table (weight 1), so it passes through exactly, as the TPU kernel's skip
// does. Only the order of the float32 sums differs from the matrix form.
//
// Bound: bytes (at most 2*27 FLOP per output against 4 bytes written; at
// the head's last up-resize at the eval geometry it reads 19.7 MB and
// writes 157 MB, ~0.053 ms at 3.35 TB/s). Design: one thread per output
// pixel (b, c, oh, ow) keeps its H and W taps in registers and walks the D2
// output planes; the D taps are the same for the whole block. Along W the
// writes are coalesced and a warp's gathers fall on a few neighbouring
// input rows, which successive planes read again from L1, so the input is
// read from device memory about once. (The first version, one thread per
// output element, re-read it for every output plane and took 13x its bound
// on a 2x upsample.) Nothing is staged in shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 4;  // taps per output on one axis

__global__ void __launch_bounds__(kThreads)
resize_taps_kernel(const float* __restrict__ x, const int* __restrict__ id,
                   const float* __restrict__ wd, const int* __restrict__ ih,
                   const float* __restrict__ wh, const int* __restrict__ iw,
                   const float* __restrict__ ww, float* __restrict__ out,
                   int B, int D, int C, int H, int W, int D2, int H2, int W2,
                   int kd, int kh, int kw) {
  const int hw = blockIdx.x * kThreads + threadIdx.x;
  if (hw >= H2 * W2) return;
  const int oh = hw / W2;
  const int ow = hw - oh * W2;
  // this pixel's H and W taps, in registers for every output plane
  int rows[kMaxK], cols[kMaxK];
  float wrow[kMaxK], wcol[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    rows[k] = k < kh ? __ldg(ih + oh * kh + k) : 0;
    wrow[k] = k < kh ? __ldg(wh + oh * kh + k) : 0.f;
    cols[k] = k < kw ? __ldg(iw + ow * kw + k) : 0;
    wcol[k] = k < kw ? __ldg(ww + ow * kw + k) : 0.f;
  }
  const size_t in_plane = (size_t)H * W;
  const size_t out_plane = (size_t)H2 * W2;
  // one (b, c) per grid row; the thread walks the D2 output planes
  for (int p = blockIdx.y; p < B * C; p += gridDim.y) {
    const int c = p % C;
    const int b = p / C;
    const float* xc = x + ((size_t)b * D * C + c) * in_plane;
    float* o = out + ((size_t)b * D2 * C + c) * out_plane + hw;
    for (int od = 0; od < D2; ++od) {
      float acc = 0.f;
      for (int a = 0; a < kd; ++a) {
        const float* xp = xc + (size_t)__ldg(id + od * kd + a) * C * in_plane;
        float acc_h = 0.f;
#pragma unroll
        for (int q = 0; q < kMaxK; ++q) {
          if (q >= kh) break;
          const float* row = xp + (size_t)rows[q] * W;
          float acc_w = 0.f;
#pragma unroll
          for (int k = 0; k < kMaxK; ++k)
            if (k < kw) acc_w = fmaf(wcol[k], __ldg(row + cols[k]), acc_w);
          acc_h = fmaf(wrow[q], acc_w, acc_h);
        }
        acc = fmaf(__ldg(wd + od * kd + a), acc_h, acc);
      }
      o[(size_t)od * C * out_plane] = acc;
    }
  }
}

}  // namespace

// Tables: (D2, kd), (H2, kh), (W2, kw) int32 indices into the input axis
// and float32 weights. Returns a cudaError_t.
extern "C" int rag_resize_taps_cf(const void* x, const void* id,
                                  const void* wd, const void* ih,
                                  const void* wh, const void* iw,
                                  const void* ww, void* out, int B, int D,
                                  int C, int H, int W, int D2, int H2, int W2,
                                  int kd, int kh, int kw, void* stream) {
  if (B <= 0 || D <= 0 || C <= 0 || H <= 0 || W <= 0 || D2 <= 0 || H2 <= 0 ||
      W2 <= 0 || kd < 1 || kh < 1 || kw < 1 || kh > kMaxK || kw > kMaxK ||
      (long long)H2 * W2 > 2147483647LL || (long long)B * C > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int planes = B * C;
  const dim3 grid((unsigned)((H2 * W2 + kThreads - 1) / kThreads),
                  (unsigned)(planes < 65535 ? planes : 65535));
  resize_taps_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(id),
      static_cast<const float*>(wd), static_cast<const int*>(ih),
      static_cast<const float*>(wh), static_cast<const int*>(iw),
      static_cast<const float*>(ww), static_cast<float*>(out), B, D, C, H, W,
      D2, H2, W2, kd, kh, kw);
  return (int)cudaGetLastError();
}
