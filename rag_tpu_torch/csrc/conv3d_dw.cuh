// Kernel D's engine: the weight gradient of the 3x3x3 stride-1 conv over
// a channel-first (B, D, Cin, H, W) fp32 volume,
//   dW[kd, kh, kw, ci, co] = sum_{b,d,h,w} x[b, d+kd-1, ci, h+kh-1, w+kw-1]
//                                          * dz[b, d, co, h, w]
// with the forward's zero padding of 1 on D, H and W. Its entries:
// conv3d_dw.cu (kernel D) over a stored volume, and cvstem_bwd.cu (kernel
// F) over the matching stem's cost volume, built on the fly from the two
// feature maps (volume_src.cuh's input policies).
//
// The TPU kernels' sequential grids carried the sum in one revisited
// output block. Blocks run in parallel here: each writes a partial dW to a
// workspace and a second kernel sums the partials in a fixed order. No
// float atomics, so two launches give the same bits.
//
// Bound on the H100: operations at every train shape with Cout >= 4
// (2*27*Cin*Cout FLOP per position against 4*(Cin + Cout) bytes: 27 FLOP
// a byte at Cin = Cout = 4, past the float32 ridge of 20), bytes at the
// Cout-1 head. So the design feeds the FMA pipe of the CUDA cores (no
// tensor cores: at these widths they could take at most about a quarter
// off the bound) and reads x and dz once from device memory:
//   * register blocking. A thread owns one (ci, kd) and KH of its three kh
//     taps (KH = 3 at CO_T 1, 4, 8; 1 at CO_T 12), with a KH x 3 x CO_T
//     register tile of those taps by the three kw taps by CO_T output
//     channels. It walks staged rows four columns at a time, keeping
//     x[w-1 .. w+4] of each of its KH rows in registers: per four positions
//     KH float4 loads of x and CO_T float4 loads of dz (one per channel,
//     four positions each) feed 12*KH*CO_T FMAs, 20.6 per shared load at
//     CO_T 4 and 26 at CO_T 8 (KH = 3), 11 at CO_T 12 (KH = 1), 9 at CO_T 1
//     (KH = 3). All lanes of a row group read the same dz float4 (a
//     broadcast);
//   * banks. With KH = 1 the lanes are ordered kh fastest, then ci, then
//     kd, so the eight lanes of one phase of a float4 load mostly share kd
//     and differ in (ci, kh). The row pitch is 12 mod 32 floats and the
//     channel pitch 4 mod 32, so lane kh + 3 ci reads the 16-byte bank
//     group 3 kh + ci = 3 (kh + 3 ci) mod 8: distinct for eight
//     consecutive lanes. With KH = 3, ci fastest then kd: lane ci of one kd
//     reads group ci + c mod 8 (c the same for the whole kd), distinct for
//     eight channels; at four channels a phase's two kd slots lie 4 groups
//     apart (the slot pitch is 4 ci = 16 mod 32 floats);
//   * a grid that fills the card. ops/conv3d.py::dw_plan cuts the work into
//     blocks of (b, run of db output planes, th x tw tile, ci chunk, CO_T
//     chunk), at least two waves where the output has 264 x 128 positions.
//     A block is `groups` row groups of 9 * ci / KH threads; the groups add
//     their tiles in shared memory in group order before the block writes;
//   * staging that overlaps compute. A block walks its planes keeping a
//     ring of four x-plane slots (planes d-1, d, d+1 in use, d+2 landing)
//     and two dz slots; the next plane lands by cp.async while the current
//     one multiplies, with one __syncthreads per plane. Each input plane
//     is staged once per run of planes, not three times. Rows start 4
//     columns left of the tile so that 16-byte copies stay aligned (W % 4
//     == 0 and both operands 16-byte aligned); elsewhere the same code
//     copies 4 bytes at a time;
//   * the input policy gives each staged row's source. For kernel F's cost
//     volume a row of the X half is X's row from the diagonal on, a row of
//     the Y half Y's row shifted right by the plane; at Cin = 2C = 24 each
//     block's channel chunk (ci = 12) is one half. Y's rows at planes
//     p % 4 != 0 and the piece that straddles the diagonal copy 4 bytes at
//     a time. A block stops at the first output plane d with d - 1 >
//     w0 + tw: the three planes it reads are zero under the tile and its
//     halo, and so are all later ones. A block left of the diagonal for its
//     whole run writes a partial of zeros;
//   * the sum pass keeps eight loads in flight per thread: each of eight
//     warps adds one contiguous segment of partials in partial order, then
//     the segments are added in segment order;
//   * bf16 at rest (rag_tpu_torch/ops/precision.py): x (or the feature
//     maps) and dz may be bf16 (the policy's Elem). Their rows are staged
//     widened to float32 by register loads (cp.async cannot widen), so the
//     products and sums are the float32 path's; dW accumulates and is
//     stored in float32, as rag_tpu/ops/pallas_conv3d.py's dW kernel does.
#pragma once

#include <climits>

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "volume_src.cuh"

namespace {

using rag::cp_async16;
using rag::cp_async4;
using rag::cp_async_commit;
using rag::cp_async_wait_all;

constexpr int kMaxThreads = 288;  // ops/conv3d.py::DW_MAX_THREADS
constexpr int kMaxCi = 16;        // DW_MAX_CI
constexpr int kSegs = 8;          // DW_SEGS: warps of the sum pass's block

template <class Src>
struct DwArgs {
  Src src;  // the (B, D, Cin, H, W) input
  const typename Src::T* dz;  // in the input's element type
  float* partial;  // (n_pos, 27, Cin, Cout)
  int D, Cin, Cout, H, W;
  int ci, groups, th, tw, db, n_dc, n_ht, n_wt;
  int rs, cs, dzp;  // x slot row and channel pitch, dz row pitch (floats)
  int vec;          // 16-byte copies
};

// The least p >= n with p % 32 == r (ops/conv3d.py::_pitch).
inline int pitch32(int n, int r) { return (n - r + 31) / 32 * 32 + r; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s + a*q.x + b*q.y + c*q.z + d*q.w, four FMAs in that order
__device__ __forceinline__ float dot4(float a, float b, float c, float d,
                                      float4 q, float s) {
  return fmaf(d, q.w, fmaf(c, q.z, fmaf(b, q.y, fmaf(a, q.x, s))));
}

// Stage rows of `cols` floats from one plane of a (chan, H, W) volume,
// n_chan channels of rpc rows each, row r of a channel read at h = h_lo + r
// and columns w_lo .. w_lo + cols - 1, into dst at the given pitches. Zero
// where the plane, channel (>= chan_limit), row or column lies outside.
// With vec (float32 only), 16-byte copies (w_lo % 4 == 0, W % 4 == 0);
// else one element at a time (stage1: widened from bf16).
template <class Elem>
__device__ __forceinline__ void stage_rows(
    float* dst, const Elem* plane, bool plane_ok, int n_chan, int rpc,
    int chan_limit, int h_lo, int w_lo, int cols, int chan_pitch,
    int row_pitch, int H, int W, bool vec, const Elem* any) {
  const int e = vec ? 4 : 1;
  const int cpr = cols / e;  // copies per row
  const int t = threadIdx.x, n = blockDim.x;
  // a thread copies column q of every rstep-th row from row0 on, or
  // (fewer threads than copies in a row) columns t, t + n, ... of every row
  int q = t, qstep = n, rstep = 1, row0 = 0;
  if (n >= cpr) {
    rstep = n / cpr;
    if (t >= rstep * cpr) return;
    q = t % cpr, qstep = cpr, row0 = t / cpr;
  }
  for (; q < cpr; q += qstep) {
    const int w = w_lo + e * q;
    const bool w_ok = plane_ok && w >= 0 && w < W;
    int chan = row0 / rpc, r = row0 - chan * rpc;
    while (chan < n_chan) {
      const int h = h_lo + r;
      const bool ok = w_ok && chan < chan_limit && h >= 0 && h < H;
      const Elem* src = ok ? plane + ((size_t)chan * H + h) * W + w : any;
      float* d = dst + chan * chan_pitch + r * row_pitch + e * q;
      if constexpr (rag::kF32<Elem>) {
        if (vec) {
          cp_async16(d, src, ok);
        } else {
          cp_async4(d, src, ok);
        }
      } else {
        rag::stage1(d, src, ok);
      }
      for (r += rstep; r >= rpc; r -= rpc) ++chan;
    }
  }
}

// The same walk over rows whose source row_of(chan, r) gives (the cost
// volume's policy, volume_src.cuh), copied by stage_piece with vec
// (float32 only), else by stage_col.
template <class Elem, class RowOf>
__device__ __forceinline__ void stage_src_rows(float* dst, RowOf row_of,
                                               int n_chan, int rpc, int w_lo,
                                               int cols, int chan_pitch,
                                               int row_pitch, bool vec,
                                               const Elem* any) {
  const int e = vec ? 4 : 1;
  const int cpr = cols / e;
  const int t = threadIdx.x, n = blockDim.x;
  int q = t, qstep = n, rstep = 1, row0 = 0;
  if (n >= cpr) {
    rstep = n / cpr;
    if (t >= rstep * cpr) return;
    q = t % cpr, qstep = cpr, row0 = t / cpr;
  }
  for (; q < cpr; q += qstep) {
    const int w = w_lo + e * q;
    int chan = row0 / rpc, r = row0 - chan * rpc;
    while (chan < n_chan) {
      float* d = dst + chan * chan_pitch + r * row_pitch + e * q;
      if constexpr (rag::kF32<Elem>) {
        if (vec) {
          rag::stage_piece(d, row_of(chan, r), w, any);
        } else {
          rag::stage_col(d, row_of(chan, r), w, any);
        }
      } else {
        rag::stage_col(d, row_of(chan, r), w, any);
      }
      for (r += rstep; r >= rpc; r -= rpc) ++chan;
    }
  }
}

// Grid: x = n_pos blocks of (b, run of planes, tile), y = Cin chunks,
// z = Cout chunks. Block: groups row groups of 9 * ci / KH threads. A
// thread owns KH of the three kh taps: KH = 1, one (kd, ci, kh), kh
// fastest; KH = 3, one (kd, ci), ci fastest.
template <int CO_T, int KH, class Src>
__global__ void __launch_bounds__(kMaxThreads)
conv3d_dw_kernel(const DwArgs<Src> a) {
  extern __shared__ __align__(16) float smem[];
  const int owners = 9 * a.ci / KH;
  const int x_slot = a.ci * a.cs;
  const int dz_chan = a.th * a.dzp;
  float* s_x = smem;                   // 4 slots: input planes mod 4
  float* s_dz = smem + 4 * x_slot;     // 2 slots: output planes mod 2

  int rem = blockIdx.x;
  const int wt = rem % a.n_wt;
  rem /= a.n_wt;
  const int ht = rem % a.n_ht;
  rem /= a.n_ht;
  const int dc = rem % a.n_dc, b = rem / a.n_dc;
  const int h0 = ht * a.th, w0 = wt * a.tw;
  const int d0 = dc * a.db;
  int n_planes = min(a.db, a.D - d0);
  // the cost volume: up to the last output plane whose lowest input plane
  // d - 1 is live under the tile's columns (its halo reaches w0 + tw)
  if constexpr (Src::kCostVolume)
    n_planes = max(
        min(n_planes, a.src.last_live_plane(w0 + a.tw) - d0 + 2), 0);
  const int ci0 = blockIdx.y * a.ci, co0 = blockIdx.z * CO_T;

  // thread -> (row group, kd, ci, kh) (see the bank note)
  const int g = threadIdx.x / owners, o = threadIdx.x - g * owners;
  const int kd = o / (3 * a.ci / KH);
  const int o_kd = o - kd * (3 * a.ci / KH);
  const int ci_l = KH == 1 ? o_kd / 3 : o_kd;
  const int kh0 = KH == 1 ? o_kd % 3 : 0;
  const int rpg = a.th / a.groups;

  using Elem = typename Src::T;
  const bool vec = a.vec != 0;
  const size_t hw = (size_t)a.H * a.W;
  // input plane p (-1 .. D) into slot (p - d0 + 1) mod 4
  auto stage_x = [&](int p) {
    float* dst = s_x + ((p - d0 + 1) & 3) * x_slot;
    if constexpr (Src::kCostVolume) {
      stage_src_rows(
          dst,
          [&](int c, int r) { return a.src.row(b, p, ci0 + c, h0 - 1 + r); },
          a.ci, a.th + 2, w0 - 4, a.tw + 8, a.cs, a.rs, vec, a.dz);
    } else {
      const bool ok = p >= 0 && p < a.D;
      const Elem* src =
          a.src.x + (((size_t)b * a.D + (ok ? p : 0)) * a.Cin + ci0) * hw;
      stage_rows(dst, src, ok, a.ci, a.th + 2, a.Cin - ci0, h0 - 1, w0 - 4,
                 a.tw + 8, a.cs, a.rs, a.H, a.W, vec, a.src.x);
    }
  };
  // dz of output plane d (d0 .. d0 + n_planes - 1) into slot (d - d0) mod 2
  auto stage_dz = [&](int d) {
    const Elem* src =
        a.dz + (((size_t)b * a.D + d) * a.Cout + co0) * hw;
    stage_rows(s_dz + ((d - d0) & 1) * CO_T * dz_chan, src, true, CO_T,
               a.th, a.Cout - co0, h0, w0, a.tw, dz_chan, a.dzp, a.H, a.W,
               vec, a.dz);
  };

  float acc[KH][3][CO_T];
#pragma unroll
  for (int j = 0; j < KH; ++j)
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int co = 0; co < CO_T; ++co) acc[j][kw][co] = 0.f;

  if (!Src::kCostVolume || n_planes > 0) {
    stage_x(d0 - 1);
    stage_x(d0);
    stage_x(d0 + 1);
    stage_dz(d0);
  }
  cp_async_commit();
  for (int k = 0; k < n_planes; ++k) {
    // plane k's operands have landed, and every thread is done with plane
    // k - 1, whose slots the next copies overwrite
    cp_async_wait_all();
    __syncthreads();
    if (k + 1 < n_planes) {
      stage_x(d0 + k + 2);
      stage_dz(d0 + k + 1);
    }
    cp_async_commit();

    const float* xp =
        s_x + ((k + kd) & 3) * x_slot + ci_l * a.cs + kh0 * a.rs;
    const float* gp = s_dz + (k & 1) * CO_T * dz_chan;
    for (int rr = 0; rr < rpg; ++rr) {
      const int r = g * rpg + rr;
      const float* xr = xp + r * a.rs;   // slab column j is w0 - 4 + j
      const float* gr = gp + r * a.dzp;
      float4 prv[KH], cur[KH];
#pragma unroll
      for (int j = 0; j < KH; ++j) {
        prv[j] = ld4(xr + j * a.rs);
        cur[j] = ld4(xr + j * a.rs + 4);
      }
#pragma unroll 2
      for (int c = 0; c < a.tw; c += 4) {
        float4 nxt[KH];
#pragma unroll
        for (int j = 0; j < KH; ++j) nxt[j] = ld4(xr + j * a.rs + c + 8);
#pragma unroll
        for (int co = 0; co < CO_T; ++co) {
          const float4 q = ld4(gr + co * dz_chan + c);
#pragma unroll
          for (int j = 0; j < KH; ++j) {
            // x[w0 + c - 1 .. w0 + c + 4] of row r + kh0 + j = v0 .. v5:
            // tap kw of position w0 + c + i reads v(i + kw)
            const float v0 = prv[j].w, v1 = cur[j].x, v2 = cur[j].y,
                        v3 = cur[j].z, v4 = cur[j].w, v5 = nxt[j].x;
            acc[j][0][co] = dot4(v0, v1, v2, v3, q, acc[j][0][co]);
            acc[j][1][co] = dot4(v1, v2, v3, v4, q, acc[j][1][co]);
            acc[j][2][co] = dot4(v2, v3, v4, v5, q, acc[j][2][co]);
          }
        }
#pragma unroll
        for (int j = 0; j < KH; ++j) {
          prv[j] = cur[j];
          cur[j] = nxt[j];
        }
      }
    }
  }

  // row groups 1 .. groups-1 added into group 0 in group order (the last
  // commit was empty, so no copy is in flight into the reused buffer)
  float* red = smem;  // (KH * 3 * CO_T, owners)
  for (int gg = 1; gg < a.groups; ++gg) {
    __syncthreads();
    if (g == gg) {
#pragma unroll
      for (int j = 0; j < KH; ++j)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int co = 0; co < CO_T; ++co)
            red[((j * 3 + kw) * CO_T + co) * owners + o] = acc[j][kw][co];
    }
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < KH; ++j)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int co = 0; co < CO_T; ++co)
            acc[j][kw][co] += red[((j * 3 + kw) * CO_T + co) * owners + o];
    }
  }
  if (g != 0 || ci0 + ci_l >= a.Cin) return;
  float* out = a.partial + (size_t)blockIdx.x * 27 * a.Cin * a.Cout +
               (size_t)(ci0 + ci_l) * a.Cout + co0;
#pragma unroll
  for (int j = 0; j < KH; ++j)
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      float* o_tap =
          out + (size_t)((kd * 3 + kh0 + j) * 3 + kw) * a.Cin * a.Cout;
#pragma unroll
      for (int co = 0; co < CO_T; ++co)
        if (co0 + co < a.Cout) o_tap[co] = acc[j][kw][co];
    }
}

// out[i] = sum over the n_pos partials of partial[p][i]: warp s adds the
// contiguous segment s of partials in order, eight loads in flight; the
// segments are then added in order. Block: 32 outputs x kSegs warps.
__global__ void __launch_bounds__(32 * kSegs)
conv3d_dw_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                     int n_pos, int n_out) {
  __shared__ float s_seg[kSegs][32];
  const int lane = threadIdx.x % 32, seg = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  const int len = (n_pos + kSegs - 1) / kSegs;
  const int p1 = min(seg * len + len, n_pos);
  float s = 0.f;
  if (i < n_out) {
    int p = seg * len;
    for (; p + 8 <= p1; p += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = __ldg(partial + (size_t)(p + u) * n_out + i);
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; p < p1; ++p) s += __ldg(partial + (size_t)p * n_out + i);
  }
  s_seg[seg][lane] = s;
  __syncthreads();
  if (seg != 0 || i >= n_out) return;
  float tot = s_seg[0][lane];
#pragma unroll
  for (int q = 1; q < kSegs; ++q) tot += s_seg[q][lane];
  out[i] = tot;
}

template <int CO_T, int KH, class Src>
int launch_partial(const DwArgs<Src>& a, dim3 grid, int threads, int smem,
                   cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv3d_dw_kernel<CO_T, KH, Src>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  conv3d_dw_kernel<CO_T, KH, Src><<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Both passes on one stream (passes: bit 1 the partials, bit 2 the sum).
// dz (B, D, Cout, H, W), out (3, 3, 3, Cin, Cout); partial: B * ceil(D/db)
// * ceil(H/th) * ceil(W/tw) * 27 * Cin * Cout floats of workspace, every
// one written by the first pass. The blocking (ci, co_t, kh_t, groups, th,
// tw, db) is ops/conv3d.py::DwPlan's. Returns a cudaError_t.
template <class Src>
int dw_run(const Src& src, const typename Src::T* dz, float* partial,
           float* out, int B, int D, int Cin, int Cout, int H, int W, int ci,
           int co_t, int kh_t, int groups, int th, int tw, int db, int passes,
           cudaStream_t stream) {
  if (B <= 0 || D <= 0 || Cin <= 0 || Cout <= 0 || H <= 0 || W <= 0 ||
      ci <= 0 || ci > kMaxCi || (kh_t != 1 && kh_t != 3) || groups <= 0 ||
      th <= 0 || th % groups != 0 || 9 * ci / kh_t * groups > kMaxThreads ||
      tw <= 0 || tw % 4 != 0 || db <= 0)
    return (int)cudaErrorInvalidValue;
  DwArgs<Src> a;
  a.src = src;
  a.dz = dz;
  a.partial = partial;
  a.D = D, a.Cin = Cin, a.Cout = Cout, a.H = H, a.W = W;
  a.ci = ci, a.groups = groups, a.th = th, a.tw = tw, a.db = db;
  a.n_dc = (D + db - 1) / db;
  a.n_ht = (H + th - 1) / th;
  a.n_wt = (W + tw - 1) / tw;
  a.rs = pitch32(tw + 8, 12);
  a.cs = pitch32((th + 2) * a.rs, 4);
  a.dzp = tw + 4;
  a.vec = src.vec() && rag::aligned16(dz);
  const long long n_pos = (long long)B * a.n_dc * a.n_ht * a.n_wt;
  const long long n_out = 27LL * Cin * Cout;
  const int n_ci = (Cin + ci - 1) / ci, n_co = (Cout + co_t - 1) / co_t;
  if (n_pos > INT_MAX || n_ci > 65535 || n_co > 65535 || n_out > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int floats_stage = 4 * ci * a.cs + 2 * co_t * th * a.dzp;
  const int floats_red = 27 * ci * co_t;
  const int smem =
      (floats_stage > floats_red ? floats_stage : floats_red) * sizeof(float);
  if (passes & 1) {
    const dim3 grid((unsigned)n_pos, n_ci, n_co);
    const int threads = 9 * ci / kh_t * groups;
    int rc;
    // ops/conv3d.py::DW_INSTANCES
    switch (co_t * 4 + kh_t) {
#define RAG_DW_CASE(CO, KH)                                          \
  case CO * 4 + KH:                                                  \
    rc = launch_partial<CO, KH>(a, grid, threads, smem, stream);     \
    break;
      RAG_DW_CASE(1, 3)
      RAG_DW_CASE(4, 3)
      RAG_DW_CASE(8, 3)
      RAG_DW_CASE(12, 1)
#undef RAG_DW_CASE
      default: return (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
  }
  if (passes & 2) {
    conv3d_dw_sum_kernel<<<(unsigned)((n_out + 31) / 32), 32 * kSegs, 0,
                           stream>>>(partial, out, (int)n_pos, (int)n_out);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace
