// Kernel A's engine: 3x3x3 stride-1 conv + per-channel affine + optional
// ReLU on a channel-first (B, D, Cin, H, W) fp32 volume, as an implicit GEMM
// on the tensor cores in 3xTF32. Its entries: conv3d.cu (kernel A, and
// kernel H with four output planes a block) over a stored volume, and
// cvstem.cu (kernel B) over the matching stem's cost volume, built on the
// fly from the two feature maps (volume_src.cuh's input policies).
//
//   out[b, d, co, h, w] = act(scale[co] * sum_{kd,kh,kw,ci}
//        x[b, d+kd-1, ci, h+kh-1, w+kw-1] * W[kd, kh, kw, ci, co] + bias[co])
// with zero padding of 1 on D, H and W.
//
// Bound: operations. At the eval geometry stem_3d1 alone is 25.5 GFLOP on a
// 157 MB input: 0.38 ms at the float32 peak outside the tensor cores (67
// TFLOP/s), 0.15 ms for its three TF32 products at 495 TFLOP/s.
//
// Design (times: chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W):
//   * Implicit GEMM per output plane: M = output pixels (16-pixel runs
//     along W), N = Cout padded to a multiple of 8, K = (tap, input
//     channel). A block owns a th x tw pixel tile, NT*8 output channels
//     and DB consecutive output planes; its 4 warps own MT m-tiles of 16
//     pixels each and keep DB x MT x NT m16n8 accumulators in registers.
//   * mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, each product as
//     a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with x_hi = tf32(x), rounded as
//     cvt.rna.tf32.f32 rounds, and x_lo = x - x_hi, float32 accumulators:
//     ~4e-7 of the output off the float32 plain version, where one TF32
//     product alone (1xTF32) is ~1e-4 off (tests/test_torch_port_
//     redesign.py). Each k-step's three mma start from zero and their sum
//     joins the accumulator with one float32 add: the tensor cores' own
//     accumulation truncates, and chained over all of K it drifted to
//     8.4e-6 of the output at Cin 36, near CONV_RTOL.
//   * A first pass splits the weights (lo = w - hi exactly; the tensor
//     cores read its TF32 bits) into B fragments in mma order, so the
//     main loop takes b_hi and b_lo with one 16-byte load per lane, k-step
//     and n-tile. Its plain version is ops/conv3d.py::pack_weights_tf32;
//     run as torch ops in the wrapper, it made the wrapper's host time
//     exceed the kernel's at the quarter-resolution shapes. The
//     activations are split as their fragments load from shared memory,
//     rounding with two integer ops: cvt.rna.tf32.f32 issues on the
//     conversion pipe, at a quarter of the integer rate.
//   * K runs in stages of one input plane x a chunk of cc <= 16 input
//     channels: K = 9 * cc per stage, padded to a multiple of 8 (Cin 12:
//     108 -> 112, 3.6 % padding; Cin 4: 36 -> 40, 10 %). N pads Cout to 8:
//     Cout 12 -> 16 (25 % of the tensor-core work is padding), 4 -> 8
//     (50 %), 1 -> 8 (88 %), while 8, 16, 24, 32 and 48 waste nothing.
//     A table in shared memory maps k to the slab offset of (tap, channel).
//   * Each stage's haloed slab (cc x (th+2) x (tw+8), zero outside the
//     volume) lands with cp.async in one of two buffers while the previous
//     stage is multiplied: one cp.async.wait_group and two __syncthreads()
//     per stage. Rows start 4 columns left of the tile, so where W % 4 == 0
//     and x is 16-byte aligned (every main-path call) they copy in 16-byte
//     pieces, else in 4-byte ones (chip_smoke.py times both). A channel
//     block's stride is 8 mod 32 floats, so the four k-columns a warp reads
//     sit on separate banks.
//   * With DB = 4 each staged input plane feeds the three output planes
//     that read it (taps kd = 2, 1, 0): the plane is staged and its A
//     fragments split once instead of three times. It is faster where N
//     has one or two n-tiles and K is large, and slower elsewhere;
//     conv_plan picks DB (chip_smoke.py times the plan with DB = 1).
//     Kernel H (the variant path's counterpart of the TPU's D-blocked v4
//     kernel, rag_tpu/ops/pallas_conv3d.py::_conv3d_kernel_v4) is this
//     kernel with DB = 4 at every shape (ops/conv3d.py::conv_plan_dblock);
//     the <2, 3, 4> instance is H's alone.
//   * The affine (folded frozen BatchNorm) and ReLU run in the epilogue.
//     The dx conv of training is this kernel on flipped, io-transposed,
//     scale-folded weights.
//   * The input policy (volume_src.cuh) gives each staged row's source. For
//     kernel B's cost volume a row of the X half is X's row from the
//     diagonal on, a row of the Y half Y's row shifted right by the plane:
//     at Cin = 2C = 24 each stage (cc = 12) is one half. Y's rows at planes
//     p % 4 != 0 and the piece that straddles the diagonal copy 4 bytes at
//     a time. A block skips the stages of planes p > w0 + tw, which are
//     zero under its whole tile and halo (their products are zeros: the
//     sums are the same bits).
//   * bf16 at rest (rag_tpu_torch/ops/precision.py): the input volume (or
//     the two feature maps) and the output may be bf16 (the policy's Elem).
//     A bf16 slab is staged widened to float32 by register loads, 4 bytes
//     of shared memory per element (cp.async copies bytes and cannot
//     widen), so the split, the 3xTF32 products and the sums are the
//     float32 path's (a bf16 value is exact in TF32: its lo part is 0); the
//     epilogue rounds to bf16 (__float2bfloat16_rn). The packed weights,
//     scale and bias stay float32, as rag_tpu/ops/pallas_conv3d.py keeps
//     them. Giving up cp.async for bf16 is the simple form; a fast one
//     would copy the half-size slab and widen it in shared memory.
// The tensor cores' mma.sync TF32 rate, not the float32 FMA rate, bounds
// the design (3 products per multiply-add); wgmma, which reaches the full
// TF32 rate, is later work.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "volume_src.cuh"

namespace {

using rag::cp_async4;
using rag::cp_async16;
using rag::cp_async_commit;
using rag::cp_async_wait_all_but_one;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCC = 16;  // input channels per stage

template <class Src>
struct ConvArgs {
  Src src;              // the (B, D, Cin, H, W) input
  const float4* wfrag;  // (n_split, 3 * n_cc, ksteps, NT, 32) fragments
  const float* scale;
  const float* bias;
  typename Src::T* out;  // in the input's element type
  int D, Cin, H, W, Cout;
  int tw, th, n_wt, n_split, cc, n_cc, ksteps, cs, relu;
  int vec;  // rows copied in 16-byte pieces
};

// Staged columns per row: w0-4 .. w0+tw+3, so that a row starts on a
// 16-byte boundary whenever W % 4 == 0; tile pixel x at tap kw sits at
// column x + kw + 3.
__host__ __device__ inline int slab_width(int tw) { return tw + 8; }

// Floats per staged channel: at least (th + 2) rows, and 8 mod 32.
__host__ __device__ inline int chan_stride(int th, int tw) {
  return ((th + 2) * slab_width(tw) + 23) / 32 * 32 + 8;
}

// v rounded to TF32 (10 explicit mantissa bits) to nearest, ties away from
// zero: the rounding of cvt.rna.tf32.f32, in two integer operations, where
// the conversion instruction made the whole kernel 25 % slower at stem_3d1
// (it issues on the conversion pipe at a quarter of the integer rate)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// c += a * b on the tensor cores (m16n8k8, TF32 in, float32 out)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a * b (a zero accumulator)
__device__ __forceinline__ void mma_tf32_zero(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// Kernel A's first pass: the weights (3, 3, 3, Cin, Cout) split into TF32
// hi = tf32(w) (rounded as cvt.rna) and lo = w - hi exactly, written as
// the B fragments of rag_tpu_torch/ops/conv3d.py::pack_weights_tf32, its
// plain version: lane g*4+t of k-step ks in stage (kd, chunk) of split ns,
// n-tile nt, holds hi(k, n), hi(k+4, n), lo(k, n), lo(k+4, n) for
// k = 8ks + t and n = (ns*NT + nt)*8 + g, where k = (3kh + kw) * cc + ci
// reads input channel chunk*cc + ci; zero past 9*cc, Cin and Cout.
__global__ void __launch_bounds__(256)
conv3d_pack_kernel(const float* __restrict__ w, float4* __restrict__ frag,
                   int n_frag, int Cin, int Cout, int cc, int n_cc,
                   int ksteps, int NT) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n_frag) return;
  const int lane = i % 32;
  int r = i / 32;
  const int nt = r % NT;
  r /= NT;
  const int ks = r % ksteps;
  r /= ksteps;
  const int stage = r % (3 * n_cc), ns = r / (3 * n_cc);
  const int kd = stage / n_cc, ch = stage % n_cc;
  const int n = (ns * NT + nt) * 8 + lane / 4;
  float hi[2], lo[2];
  for (int kk = 0; kk < 2; ++kk) {
    const int k = ks * 8 + lane % 4 + 4 * kk;
    const int tap = k / cc, ci = ch * cc + k % cc;
    const float v =
        k < 9 * cc && ci < Cin && n < Cout
            ? __ldg(w + ((size_t)(kd * 9 + tap) * Cin + ci) * Cout + n)
            : 0.f;
    hi[kk] = __uint_as_float(tf32_rna(v));
    lo[kk] = v - hi[kk];
  }
  frag[i] = make_float4(hi[0], hi[1], lo[0], lo[1]);
}

// The pass over n_frag float4 fragments on one stream.
int launch_pack(const float* w, float4* frag, long long n_frag, int Cin,
                int Cout, int cc, int n_cc, int ksteps, int nt,
                cudaStream_t stream) {
  if (n_frag <= 0 || n_frag > 2147483647LL) return (int)cudaErrorInvalidValue;
  conv3d_pack_kernel<<<(unsigned)((n_frag + 255) / 256), 256, 0, stream>>>(
      w, frag, (int)n_frag, Cin, Cout, cc, n_cc, ksteps, nt);
  return (int)cudaGetLastError();
}

// Grid: x = n_ht * n_wt tiles, y = ceil(D / DB) runs of DB output planes,
// z = B * n_split.
template <int MT, int NT, int DB, class Src>
__global__ void __launch_bounds__(kThreads)
conv3d_tf32x3_kernel(const ConvArgs<Src> a) {
  using Elem = typename Src::T;
  extern __shared__ __align__(16) float smem[];
  const int sw = slab_width(a.tw), sh = a.th + 2;
  const int buf_floats = a.cc * a.cs;
  int* s_off = reinterpret_cast<int*>(smem + 2 * buf_floats);

  // k -> slab offset of (kh, kw, ci); padded k read any staged value,
  // which meets a zero weight
  for (int k = threadIdx.x; k < a.ksteps * 8; k += kThreads) {
    int off = 0;
    if (k < 9 * a.cc) {
      const int tap = k / a.cc, ci = k - tap * a.cc;
      off = ci * a.cs + (tap / 3) * sw + tap % 3 + 3;
    }
    s_off[k] = off;
  }

  const int wt = blockIdx.x % a.n_wt, ht = blockIdx.x / a.n_wt;
  const int d0 = blockIdx.y * DB;
  const int b = blockIdx.z / a.n_split, ns = blockIdx.z % a.n_split;
  const int h0 = ht * a.th, w0 = wt * a.tw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment group, thread in it
  const int per_row = a.tw / 16;          // m-tiles per tile row

  // slab position of this lane's first A row (pixel g of each m-tile) at
  // tap (kh, kw) = (0, 0), less the +3 the k table carries
  int pix[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int i = warp * MT + m;
    pix[m] = (i / per_row) * sw + (i % per_row) * 16 + g;
  }

  // 16-byte copies where every staged row starts on a 16-byte boundary
  // (float32 only)
  const Elem* x = a.src.x;  // the stored volume, or X (and a global
                            // address for zero fills)
  const bool vec = rag::kF32<Elem> &&
                   (Src::kCostVolume
                        ? a.vec != 0
                        : a.W % 4 == 0 &&
                              (reinterpret_cast<uintptr_t>(x) & 15) == 0);
  const int cpr = sw / 4;    // 16-byte chunks per row
  const int rpi = 32 / cpr;  // rows per warp pass (vec)
  const int lane_row = lane / cpr, lane_q = lane % cpr;

  // stages: input planes d0-1 .. d0+DB inside the volume x channel chunks;
  // each feeds the (up to three) output planes of the run that read it.
  // In the cost volume, planes past the last live one under the tile's
  // columns (its halo reaches w0 + tw) are zero there and add nothing
  const int p_lo = max(d0 - 1, 0), p_hi = min(d0 + DB, a.D - 1);
  int n_stages = (p_hi - p_lo + 1) * a.n_cc;
  if constexpr (Src::kCostVolume)
    n_stages = max(min(p_hi, a.src.last_live_plane(w0 + a.tw)) - p_lo + 1,
                   0) * a.n_cc;

  auto stage = [&](int st, float* dst) {
    const int p = p_lo + st / a.n_cc, c0 = (st % a.n_cc) * a.cc;
    const int n_rows = a.cc * sh;
    if constexpr (Src::kCostVolume) {
      // the policy's rows (volume_src.cuh)
      if constexpr (rag::kF32<Elem>) {
        if (vec) {
          if (lane_row >= rpi) return;
          const int step = kWarps * rpi;
          int row = warp * rpi + lane_row;
          int ci = row / sh, r = row - ci * sh;
          for (; row < n_rows; row += step) {
            rag::stage_piece(dst + ci * a.cs + r * sw + 4 * lane_q,
                             a.src.row(b, p, c0 + ci, h0 - 1 + r),
                             w0 - 4 + 4 * lane_q, x);
            for (r += step; r >= sh; r -= sh) ++ci;
          }
          return;
        }
      }
      for (int row = warp; row < n_rows; row += kWarps) {
        const int ci = row / sh, r = row - ci * sh;
        const rag::SrcRow<Elem> src = a.src.row(b, p, c0 + ci, h0 - 1 + r);
        float* dst_row = dst + ci * a.cs + r * sw;
        for (int col = lane; col < sw; col += 32)
          rag::stage_col(dst_row + col, src, w0 - 4 + col, x);
      }
      return;
    }
    const size_t plane = ((size_t)b * a.D + p) * a.Cin;
    if constexpr (rag::kF32<Elem>) {
      if (vec) {
        if (lane_row >= rpi) return;
        const int step = kWarps * rpi;
        int row = warp * rpi + lane_row;
        int ci = row / sh, r = row - ci * sh;
        for (; row < n_rows; row += step) {
          const int h = h0 - 1 + r;
          const int w = w0 - 4 + 4 * lane_q;
          const bool ok = c0 + ci < a.Cin && h >= 0 && h < a.H && w >= 0 &&
                          w < a.W;
          const float* src =
              ok ? x + ((plane + c0 + ci) * a.H + h) * (size_t)a.W + w : x;
          cp_async16(dst + ci * a.cs + r * sw + 4 * lane_q, src, ok);
          for (r += step; r >= sh; r -= sh) ++ci;
        }
        return;
      }
    }
    for (int row = warp; row < n_rows; row += kWarps) {
      const int ci = row / sh, r = row - ci * sh;
      const int h = h0 - 1 + r;
      const bool row_ok = c0 + ci < a.Cin && h >= 0 && h < a.H;
      const Elem* src =
          x + ((plane + (row_ok ? c0 + ci : 0)) * a.H + (row_ok ? h : 0)) *
                  (size_t)a.W;
      float* dst_row = dst + ci * a.cs + r * sw;
      for (int col = lane; col < sw; col += 32) {
        const int w = w0 - 4 + col;
        const bool ok = row_ok && w >= 0 && w < a.W;
        rag::stage1(dst_row + col, ok ? src + w : x, ok);
      }
    }
  };

  float acc[DB][MT][NT][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][m][n][e] = 0.f;

  if (!Src::kCostVolume || n_stages > 0) stage(0, smem);
  cp_async_commit();
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) stage(st + 1, smem + ((st + 1) & 1) * buf_floats);
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();  // stage st (and the k table) visible to every thread

    const float* sb = smem + (st & 1) * buf_floats;
    const int p = p_lo + st / a.n_cc, ch = st % a.n_cc;
    for (int ks = 0; ks < a.ksteps; ++ks) {
      const int o0 = s_off[ks * 8 + t], o1 = s_off[ks * 8 + t + 4];
      // A fragments: rows g, g+8 (pixels) x columns t, t+4 (k), split
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float v[4] = {sb[o0 + pix[m]], sb[o0 + pix[m] + 8],
                            sb[o1 + pix[m]], sb[o1 + pix[m] + 8]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[m][e] = tf32_rna(v[e]);
          al[m][e] = tf32_rna(v[e] - __uint_as_float(ah[m][e]));
        }
      }
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        const int kd = p - d0 - j + 1;  // output plane d0+j reads p at tap kd
        if (kd < 0 || kd > 2 || d0 + j >= a.D) continue;
        const float4* wb =
            a.wfrag +
            (((size_t)(ns * 3 * a.n_cc + kd * a.n_cc + ch) * a.ksteps + ks) *
                 NT) * 32 + lane;
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float4 f = __ldg(wb + n * 32);
          bh[n][0] = __float_as_uint(f.x);
          bh[n][1] = __float_as_uint(f.y);
          bl[n][0] = __float_as_uint(f.z);
          bl[n][1] = __float_as_uint(f.w);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            // the k-step's three products into a zero accumulator, then one
            // round-to-nearest add: the tensor cores' accumulation
            // truncates, and chained over all of K (up to 486 mma at Cin 48)
            // its bias reached 8e-6 of the output at Cin 36 (3-10x float32
            // FMAs)
            float part[4];
            mma_tf32_zero(part, al[m], bh[n][0], bh[n][1]);
            mma_tf32(part, ah[m], bl[n][0], bl[n][1]);
            mma_tf32(part, ah[m], bh[n][0], bh[n][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][m][n][e] += part[e];
          }
      }
    }
    __syncthreads();  // done with this buffer before stage st+2 refills it
  }

  // C fragment: element e of lane (g, t) is pixel g + 8*(e/2), channel
  // 2t + e%2 of its m16n8 tile
#pragma unroll
  for (int j = 0; j < DB; ++j) {
    const int d = d0 + j;
    if (d >= a.D) break;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int i = warp * MT + m;
      const int h = h0 + i / per_row;
      if (h >= a.H) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int w = w0 + (i % per_row) * 16 + g + (e & 2) * 4;
          const int co = (ns * NT + n) * 8 + 2 * t + (e & 1);
          if (w < a.W && co < a.Cout) {
            float y = fmaf(acc[j][m][n][e], __ldg(a.scale + co),
                           __ldg(a.bias + co));
            if (a.relu) y = fmaxf(y, 0.f);
            a.out[((((size_t)b * a.D + d) * a.Cout + co) * a.H + h) * a.W +
                  w] = rag::to_elem<Elem>(y);
          }
        }
      }
    }
  }
}

template <int MT, int NT, int DB, class Src>
int launch(const ConvArgs<Src>& a, dim3 grid, int smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv3d_tf32x3_kernel<MT, NT, DB, Src>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  conv3d_tf32x3_kernel<MT, NT, DB, Src><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Check a plan's integers (rag_tpu_torch/ops/conv3d.py::conv_plan): MT
// m-tiles per warp and a tile tw pixels wide (th = 64 * mt / tw rows), NT
// n-tiles per block and n_split blocks across Cout, cc input channels per
// stage, db output planes per block), fill the arguments, grid and shared
// memory of a launch and run the weight pass into frag (workspace for
// n_split * 3 * ceil(Cin / cc) * ceil(9 cc / 8) * nt * 32 float4 B
// fragments). Returns a cudaError_t; the caller then launches its
// instance of <mt, nt, db>.
template <class Src>
int conv_setup(ConvArgs<Src>& a, dim3& grid, int& smem, const Src& src,
               const void* w, void* frag, const void* scale, const void* bias,
               void* out, int B, int D, int Cin, int H, int W, int Cout,
               int relu, int mt, int nt, int tw, int n_split, int cc, int db,
               cudaStream_t stream) {
  if (B <= 0 || D <= 0 || Cin <= 0 || H <= 0 || W <= 0 || Cout <= 0 ||
      (tw != 16 && tw != 32 && tw != 64) || (mt != 2 && mt != 4) ||
      cc <= 0 || cc > kMaxCC || n_split <= 0 || nt <= 0 ||
      n_split * nt * 8 < Cout || db <= 0)
    return (int)cudaErrorInvalidValue;
  a.src = src;
  a.wfrag = static_cast<const float4*>(frag);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<typename Src::T*>(out);
  a.D = D, a.Cin = Cin, a.H = H, a.W = W, a.Cout = Cout;
  a.tw = tw, a.th = 64 * mt / tw;
  a.n_wt = (W + tw - 1) / tw;
  a.n_split = n_split, a.cc = cc, a.n_cc = (Cin + cc - 1) / cc;
  a.ksteps = (9 * cc + 7) / 8;
  a.cs = chan_stride(a.th, tw);
  a.relu = relu;
  a.vec = src.vec();
  const int n_ht = (H + a.th - 1) / a.th;
  const int n_db = (D + db - 1) / db;
  if (n_db > 65535 || (long long)B * n_split > 65535 ||
      (long long)a.n_wt * n_ht > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  grid = dim3(a.n_wt * n_ht, n_db, B * n_split);
  smem = (2 * cc * a.cs + 8 * a.ksteps) * (int)sizeof(float);
  return launch_pack(static_cast<const float*>(w), static_cast<float4*>(frag),
                     32LL * n_split * 3 * a.n_cc * a.ksteps * nt, Cin, Cout,
                     cc, a.n_cc, a.ksteps, nt, stream);
}

}  // namespace
