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
// for an odd-size upsample, 1 for a 2x downsample). Padded taps have weight
// 0 and index 0 and are skipped. An axis whose size does not change has the
// one-tap identity table (weight 1), so it passes through exactly, as the
// TPU kernel's skip does. Only the order of the float32 sums differs from
// the matrix form: W taps innermost, then H taps, then D taps from the last
// to the first.
//
// Bound: bytes (a few FLOP per output against 4 bytes written; the head's
// last up-resize at the eval geometry reads 19.7 MB and writes 157 MB,
// ~0.053 ms at 3.35 TB/s).
//
// Design: separable, with D last.
//   * A block owns (b, c, a tile of 8*RPW output rows x 16*QC output
//     columns, a run of output planes); its 4 warps' lanes are 2 rows x 16
//     columns, so a warp's stores and its gathers from shared memory fall
//     on neighbouring columns (a 2x downsample's lanes read every second
//     staged column: at most 2-way bank conflicts, where float4s of four
//     neighbouring outputs would give 8-way ones).
//   * The host (rag_tpu_torch/ops/resize.py::resize_tables) lists, per run,
//     the source planes its output planes' real D taps read, and per row
//     tile the source rows its H taps read (a 4x downsample reads half the
//     planes and half the rows), and per column tile the span of source
//     columns from a multiple of 4. The block walks its run's planes; each
//     plane's listed rows x the column span land in a ring of kRing slots
//     in shared memory with cp.async (16-byte pieces where W % 4 == 0 and
//     x is 16-byte aligned, else 4-byte ones), kRing - 1 planes ahead.
//   * For each staged plane every thread computes its pixels' H/W
//     interpolation once and shifts it into a register window of the last
//     K planes. An output plane whose last D tap is that plane then costs
//     kd FMAs from the window and one coalesced store per pixel. A run
//     that does not start at plane 0 restages its first planes; a plane
//     that no output of the run reads is never staged.
//   * rag_tpu_torch/ops/resize.py::resize_plan picks the tile and the run
//     length per shape: a downsample's runs restage no plane, so they are
//     cut short until the grid holds four waves of resident blocks; an
//     upsample's restage one or two planes each, so they stay long.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): 0.42 ms of
// device time a request, against F.interpolate's 0.76-0.80 ms.
//
// bf16 at rest (rag_tpu_torch/ops/precision.py): rag_resize_taps_cf_bf16
// takes a bf16 x and writes a bf16 out at the float32 instance's plan and
// tables. Its ring holds x's rows as they are, two bytes an element, copied
// with cp.async in 16-byte pieces of eight (W % 8 == 0, x 16-byte aligned)
// from the piece boundary at or left of the tile's first column (wt_lo is a
// multiple of 4 only, so a span may start 4 columns into its first piece
// and is read `off` columns on), else in 8-byte pieces of four (W % 4 == 0,
// x 8-byte aligned; no offset), else element by element (a register load
// and store). Each staged value is widened as it is read, the float32
// weights and sums are the float32 instance's in its order, and the output
// is rounded to bf16 once, at the store: the float32 instance's result on
// the upcast x, rounded. A staged row is at most round8(pitch + 4) bf16
// (16-byte rows) where the float32 instance's is pitch floats, so the ring
// takes about half the shared memory at the same tiles.
#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

using rag::cp_async_commit;

constexpr int kThreads = 128;
constexpr int kRing = 4;  // staged planes: kRing - 1 in flight, one read

template <class Elem>
struct ResizeArgs {
  const Elem* x;
  Elem* out;
  // int32 tables (rag_tpu_torch/ops/resize.py::resize_tables)
  const int* wt_lo;       // (n_wt) first staged column of each W tile
  const int* wt_n;        // (n_wt) staged columns
  const int* col_off;     // (W2) first tap's column in its tile's span
  const int* col_n;       // (W2) real taps
  const int* ht_n;        // (n_ht) staged rows
  const int* ht_rows;     // (n_ht, rows) their source rows
  const int* row_slot;    // (H2) staged slot of the first tap
  const int* row_n;       // (H2) real taps
  const int* run_n;       // (n_runs) staged planes
  const int* run_planes;  // (n_runs, planes) their source planes
  const int* pl_last;     // (D2) list position of the last tap, -1: none
  const int* pl_n;        // (D2) real taps
  // float32 weights, K a row
  const float* col_w;     // (W2, K) tap order
  const float* row_w;     // (H2, K) tap order
  const float* pl_w;      // (D2, K) last tap first
  int D, C, H, W, D2, H2, W2;
  // pitch: elements a staged row; piece: elements a cp.async piece (float32:
  // 4, 16 bytes, or 1, 4-byte copies; bf16: 8, 4 or 1, register copies)
  int n_wt, n_ht, n_runs, run, rows, pitch, planes, piece;
};

// Stage n_row rows (source rows `rows`, `W` apart) of `width` elements from
// src into dst (rows `pitch` apart) in pieces of N elements: one cp.async
// of 16 or 8 bytes a piece, or at N = 1 one element (float32: a 4-byte
// cp.async; bf16: a register load and store, visible after the
// __syncthreads() that publishes the copies).
template <int N, class Elem>
__device__ __forceinline__ void stage_rows(Elem* dst, int pitch,
                                           const Elem* src, const int* rows,
                                           int W, int n_row, int width) {
  const int chunks = width / N, n = n_row * chunks;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int s = i / chunks, q = N * (i - s * chunks);
    const Elem* from = src + (size_t)__ldg(rows + s) * W + q;
    if constexpr (N == 1)
      rag::stage1(dst + s * pitch + q, from, true);
    else
      rag::stage_n<N>(dst + s * pitch + q, from, true);
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Grid: one block per (b, c, run, row tile, column tile), column tiles
// fastest, so neighbouring blocks share the halo of their staged spans.
template <int QC, int RPW, int K, class Elem>
__global__ void __launch_bounds__(kThreads)
resize_taps_kernel(const ResizeArgs<Elem> a) {
  extern __shared__ float4 smem4[];
  Elem* smem = reinterpret_cast<Elem*>(smem4);
  int t = blockIdx.x;
  const int wt = t % a.n_wt;
  t /= a.n_wt;
  const int ht = t % a.n_ht;
  t /= a.n_ht;
  const int run = t % a.n_runs;
  t /= a.n_runs;
  const int c = t % a.C, b = t / a.C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ow0 = wt * 16 * QC + lane % 16;
  const int oh0 = ht * 8 * RPW + 2 * warp + lane / 16;

  // this thread's columns and rows: first tap, real taps, weights (no
  // taps outside the volume, so those pixels stay 0 and are not stored)
  int coff[QC], cn[QC];
  float cw[QC][K];
#pragma unroll
  for (int q = 0; q < QC; ++q) {
    const int ow = ow0 + 16 * q;
    const bool ok = ow < a.W2;
    coff[q] = ok ? __ldg(a.col_off + ow) : 0;
    cn[q] = ok ? __ldg(a.col_n + ow) : 0;
#pragma unroll
    for (int k = 0; k < K; ++k) cw[q][k] = ok ? __ldg(a.col_w + ow * K + k) : 0.f;
  }
  int rslot[RPW], rn[RPW];
  float rw[RPW][K];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int oh = oh0 + 8 * r;
    const bool ok = oh < a.H2;
    rslot[r] = ok ? __ldg(a.row_slot + oh) : 0;
    rn[r] = ok ? __ldg(a.row_n + oh) : 0;
#pragma unroll
    for (int k = 0; k < K; ++k) rw[r][k] = ok ? __ldg(a.row_w + oh * K + k) : 0.f;
  }

  const int lo = __ldg(a.wt_lo + wt), n_col = __ldg(a.wt_n + wt);
  // the staged span: float32 the tile's span as it is (lo and n_col
  // multiples of its piece); bf16 from the piece boundary at or left of
  // lo, whole pieces (within W, a multiple of a piece), read off columns on
  int base = lo, off = 0, width = n_col;
  if constexpr (!rag::kF32<Elem>) {
    base = lo & -a.piece, off = lo - base;
    width = (off + n_col + a.piece - 1) & -a.piece;
  }
  const int n_row = __ldg(a.ht_n + ht);
  const int* rows = a.ht_rows + (size_t)ht * a.rows;
  const int* planes = a.run_planes + (size_t)run * a.planes;
  const int n_plane = __ldg(a.run_n + run);
  const int buf = a.rows * a.pitch;
  const size_t in_plane = (size_t)a.H * a.W;

  // list entry e's staged rows x column span into ring slot e % kRing
  auto stage = [&](int e) {
    if (e >= n_plane) return;
    Elem* dst = smem + (e % kRing) * buf;
    const Elem* src = a.x +
        (((size_t)b * a.D + __ldg(planes + e)) * a.C + c) * in_plane + base;
    if (a.piece == 1)
      stage_rows<1>(dst, a.pitch, src, rows, a.W, n_row, width);
    else if constexpr (rag::kF32<Elem>)
      stage_rows<4>(dst, a.pitch, src, rows, a.W, n_row, width);
    else if (a.piece == 4)
      stage_rows<4>(dst, a.pitch, src, rows, a.W, n_row, width);
    else
      stage_rows<8>(dst, a.pitch, src, rows, a.W, n_row, width);
  };

  // win[j]: this thread's pixels interpolated in H and W on list entry
  // e - j, e the newest entry computed
  float win[K][RPW][QC];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int q = 0; q < QC; ++q) win[j][r][q] = 0.f;

#pragma unroll
  for (int e = 0; e < kRing - 1; ++e) {
    stage(e);
    cp_async_commit();
  }
  int e = -1;
  const int od1 = min(a.D2, (run + 1) * a.run);
  for (int od = run * a.run; od < od1; ++od) {
    const int n = __ldg(a.pl_n + od);
    const int last = __ldg(a.pl_last + od);
    while (e < last) {  // uniform: the tables are the block's
      ++e;
      cp_async_wait<kRing - 2>();  // entry e landed (this thread's copies)
      __syncthreads();  // everyone's; slot (e - 1) % kRing is free again
      stage(e + kRing - 1);
      cp_async_commit();
      const Elem* sb = smem + (e % kRing) * buf + off;
#pragma unroll
      for (int j = K - 1; j > 0; --j)
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int q = 0; q < QC; ++q) win[j][r][q] = win[j - 1][r][q];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          float acc_h = 0.f;
#pragma unroll
          for (int qq = 0; qq < K; ++qq) {
            if (qq < rn[r]) {
              const Elem* row = sb + (rslot[r] + qq) * a.pitch + coff[q];
              float acc_w = 0.f;
#pragma unroll
              for (int k = 0; k < K; ++k)
                if (k < cn[q])
                  acc_w = fmaf(cw[q][k], rag::widen(row[k]), acc_w);
              acc_h = fmaf(rw[r][qq], acc_w, acc_h);
            }
          }
          win[0][r][q] = acc_h;
        }
      }
    }
    // output plane od: its taps are the window's newest n entries
    float wd[K];
#pragma unroll
    for (int j = 0; j < K; ++j) wd[j] = j < n ? __ldg(a.pl_w + od * K + j) : 0.f;
    Elem* o = a.out + (((size_t)b * a.D2 + od) * a.C + c) * a.H2 *
                          (size_t)a.W2;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int oh = oh0 + 8 * r;
      if (oh >= a.H2) continue;
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        const int ow = ow0 + 16 * q;
        if (ow >= a.W2) continue;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (j < n) acc = fmaf(wd[j], win[j][r][q], acc);
        o[(size_t)oh * a.W2 + ow] = rag::to_elem<Elem>(acc);
      }
    }
  }
  cp_async_wait<0>();  // the empty groups committed past the last entry
}

template <int QC, int RPW, int K, class Elem>
int launch(const ResizeArgs<Elem>& a, unsigned blocks, int smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        resize_taps_kernel<QC, RPW, K, Elem>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  resize_taps_kernel<QC, RPW, K, Elem><<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Elements a staged piece (ops/resize.py::resize_piece): float32 4 (16
// bytes) where W % 4 == 0 and x is 16-byte aligned, else 1; bf16 8 (16
// bytes) where W % 8 == 0 and x is 16-byte aligned, else 4 (8 bytes) where
// W % 4 == 0 and x is 8-byte aligned, else 1.
template <class Elem>
int piece_of(int W, const void* x) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(x);
  if (rag::kF32<Elem>) return W % 4 == 0 && p % 16 == 0 ? 4 : 1;
  if (W % 8 == 0 && p % 16 == 0) return 8;
  return W % 4 == 0 && p % 8 == 0 ? 4 : 1;
}

// x and out of element type Elem; pitch: the float32 plan's floats a
// staged row (a multiple of 4), widened by a piece of eight for an offset
// span of bf16 pieces of eight.
template <class Elem>
int resize_entry(const void* x, const void* itab, const void* ftab, void* out,
                 int B, int D, int C, int H, int W, int D2, int H2, int W2,
                 int k, int qc, int rpw, int run, int rows, int pitch,
                 int planes, void* stream) {
  if (B <= 0 || D <= 0 || C <= 0 || H <= 0 || W <= 0 || D2 <= 0 || H2 <= 0 ||
      W2 <= 0 || (k != 2 && k != 4) || run <= 0 || rows <= 0 || pitch <= 0 ||
      pitch % 4 != 0 || planes <= 0)
    return (int)cudaErrorInvalidValue;
  ResizeArgs<Elem> a;
  a.x = static_cast<const Elem*>(x);
  a.out = static_cast<Elem*>(out);
  a.D = D, a.C = C, a.H = H, a.W = W, a.D2 = D2, a.H2 = H2, a.W2 = W2;
  a.n_wt = (W2 + 16 * qc - 1) / (16 * qc);
  a.n_ht = (H2 + 8 * rpw - 1) / (8 * rpw);
  a.n_runs = (D2 + run - 1) / run;
  a.run = run, a.rows = rows, a.planes = planes;
  a.piece = piece_of<Elem>(W, x);
  a.pitch = a.piece == 8 ? (pitch + 4 + 7) / 8 * 8 : pitch;
  const int* it = static_cast<const int*>(itab);
  a.wt_lo = it, it += a.n_wt;
  a.wt_n = it, it += a.n_wt;
  a.col_off = it, it += W2;
  a.col_n = it, it += W2;
  a.ht_n = it, it += a.n_ht;
  a.ht_rows = it, it += (size_t)a.n_ht * rows;
  a.row_slot = it, it += H2;
  a.row_n = it, it += H2;
  a.run_n = it, it += a.n_runs;
  a.run_planes = it, it += (size_t)a.n_runs * planes;
  a.pl_last = it, it += D2;
  a.pl_n = it;
  const float* ft = static_cast<const float*>(ftab);
  a.col_w = ft, ft += (size_t)W2 * k;
  a.row_w = ft, ft += (size_t)H2 * k;
  a.pl_w = ft;
  const long long blocks =
      (long long)B * C * a.n_runs * a.n_ht * a.n_wt;
  const long long smem = (long long)sizeof(Elem) * kRing * rows * a.pitch;
  if (blocks > 2147483647LL || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RAG_RESIZE_CASE(Q, R, K_)           \
  if (qc == Q && rpw == R && k == K_)       \
    return launch<Q, R, K_>(a, (unsigned)blocks, (int)smem, st);
  RAG_RESIZE_CASE(1, 4, 2)
  RAG_RESIZE_CASE(2, 2, 2)
  RAG_RESIZE_CASE(4, 1, 2)
  RAG_RESIZE_CASE(1, 4, 4)
  RAG_RESIZE_CASE(2, 2, 4)
  RAG_RESIZE_CASE(4, 1, 4)
#undef RAG_RESIZE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// itab, ftab: rag_tpu_torch/ops/resize.py::resize_tables for the plan's
// integers: k taps a table row, qc columns and rpw rows a thread, run
// output planes a block, rows staged rows and pitch floats a staged row at
// most, planes source planes a run at most. Returns a cudaError_t.
extern "C" int rag_resize_taps_cf(const void* x, const void* itab,
                                  const void* ftab, void* out, int B, int D,
                                  int C, int H, int W, int D2, int H2, int W2,
                                  int k, int qc, int rpw, int run, int rows,
                                  int pitch, int planes, void* stream) {
  return resize_entry<float>(x, itab, ftab, out, B, D, C, H, W, D2, H2, W2, k,
                             qc, rpw, run, rows, pitch, planes, stream);
}

// The same with x and out bf16, at the same plan and tables.
extern "C" int rag_resize_taps_cf_bf16(const void* x, const void* itab,
                                       const void* ftab, void* out, int B,
                                       int D, int C, int H, int W, int D2,
                                       int H2, int W2, int k, int qc, int rpw,
                                       int run, int rows, int pitch,
                                       int planes, void* stream) {
  return resize_entry<rag::bf16>(x, itab, ftab, out, B, D, C, H, W, D2, H2,
                                 W2, k, qc, rpw, run, rows, pitch, planes,
                                 stream);
}
