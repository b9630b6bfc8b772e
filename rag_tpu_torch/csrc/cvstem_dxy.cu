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
//
// bf16 at rest (rag_tpu_torch/ops/precision.py): dz may be bf16; the sums
// and the partials are float32, and dX and dY are stored in dz's type (the
// features' dtype under the policy), as rag_tpu's VJP casts them. A bf16
// plane is staged as it is, with cp.async in pieces of N elements: 16-byte
// pieces of eight (.cg, past L1) where W % 8 == 0 and dz is 16-byte
// aligned, else 8-byte pieces of four where W % 4 == 0 and dz is 8-byte
// aligned, else element by element (register loads) in the layout of
// pieces of eight. A slot row starts at the piece boundary at or left of
// the window's first column col0 and is read off = col0 - base columns
// further on: N - 2 for the dX half (col0 = w0 - 2) and (q - 2) mod N for
// the dY half, whose window moves with the plane. Pieces wholly outside the
// volume (rows off [0, H), columns off [0, W)) are zero-filled by the
// copy; with W a multiple of N no piece straddles 0 or W. The slots stay
// bf16 (rows of kPitchBf16 = 88: 44 words, 12 mod 32, so a warp's two rows
// of 16 reads, 9 words each, fall on separate banks) and a value is
// widened as the inner loop reads it: one byte permute, which also applies
// the output plane's mask (it takes the float32 instance's select), then
// 12 FMAs. The plan, the walk and the partials are the float32
// instance's, so dX and dY equal its output on the upcast dz, rounded to
// bf16. Half-size slots: 57.8 KB a block at the train shape, three blocks
// an SM where two fit in float32.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"

namespace {

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
constexpr int kPitchBf16 = 88;       // bf16 row pitch (44 words, 12 mod 32)

// Pieces of N bf16 a staged row takes: the window's kSW columns start up
// to N - 1 columns into the first piece.
template <int N>
constexpr int kPieces = (kSW + 2 * N - 2) / N;
static_assert(kPieces<8> * 8 <= kPitchBf16 && kPieces<4> * 4 <= kPitchBf16,
              "a slot row holds its pieces");
static_assert(kPitchBf16 * 2 % 16 == 0, "slot rows stay 16-byte aligned");

// Issue the copies of float32 dz plane q, channels c0 .. c0+kc-1, rows
// h0-1 .. h0+kTY, columns col0 .. col0+kSW-1 into one ring slot
// [kc][kSH][kPitch], one 4-byte cp.async an element; what lies outside the
// volume is zero-filled. Plane q must be in [0, D).
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
      rag::stage1(dst_row + col, ok ? src_row + j : dz, ok);
    }
  }
}

// The same for bf16 dz into a slot [kc][kSH][kPitchBf16] of bf16, in
// pieces of N from column base (a multiple of N at or left of the window):
// slot column s holds dz column base + s. With vec (W % N == 0, dz aligned
// to a piece) a piece is one cp.async of its 2N bytes, or a zero fill of
// them where it lies outside the volume; else every piece is copied
// element by element.
template <int N>
__device__ __forceinline__ void stage_plane(rag::bf16* slot,
                                            const rag::bf16* __restrict__ dz,
                                            int b, int q, int c0, int kc,
                                            int D, int Cout, int H, int W,
                                            int h0, int base, bool vec) {
  constexpr int P = kPieces<N>;
  for (int i = threadIdx.x; i < kc * kSH * P; i += kThreads) {
    const int row = i / P, k = i - row * P;
    const int co = row / kSH, r = row - co * kSH;
    const int h = h0 - 1 + r;
    const bool h_ok = h >= 0 && h < H;
    const rag::bf16* src_row =
        dz + ((((size_t)b * D + q) * Cout + c0 + co) * H + (h_ok ? h : 0)) *
                 (size_t)W;
    rag::bf16* dst = slot + row * kPitchBf16 + k * N;
    const int j0 = base + k * N;
    if (vec && (!h_ok || j0 + N <= 0 || j0 >= W)) {
      rag::stage_n<N>(dst, dz, false);
    } else if (vec && j0 >= 0 && j0 + N <= W) {
      rag::stage_n<N>(dst, src_row + j0, true);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int j = j0 + e;
        const bool ok = h_ok && j >= 0 && j < W;
        rag::stage1(dst + e, ok ? src_row + j : dz, ok);
      }
    }
  }
}

// The slot element and row pitch of an instance: float32 rows of kPitch,
// or bf16 rows of kPitchBf16.
template <class Elem>
using Slot =
    typename std::conditional<rag::kF32<Elem>, float, rag::bf16>::type;
template <class Elem>
constexpr int kSlotPitch = rag::kF32<Elem> ? kPitch : kPitchBf16;

// wpk: (2, n_cc, 27, Cout, CT) weights of the X and Y halves, channel chunk
// cc of each zero-padded to CT. partial: (2, n_chunks, B, C, H, W).
// Grid: x = n_ht * n_wt, y = n_chunks, z = B * 2 * n_cc. N: elements of a
// bf16 piece (8 or 4; 1 for float32), vec: whether bf16 rows copy in
// pieces.
template <int CT, class Elem, int N>
__global__ void __launch_bounds__(kThreads)
cvstem_dxy_partial_kernel(const Elem* __restrict__ dz,
                          const float* __restrict__ wpk,
                          float* __restrict__ partial, int B, int D, int Cout,
                          int C, int H, int W, int n_wt, int chunk,
                          int n_chunks, int n_cc, int kc_max, int vec) {
  constexpr int kP = kSlotPitch<Elem>;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                                     // [27][kc][CT]
  Slot<Elem>* s_ring =                                   // [2][kc][kSH][kP]
      reinterpret_cast<Slot<Elem>*>(smem + 27 * kc_max * CT);
  const int slot_elems = kc_max * kSH * kP;

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
    // stage dz plane q (its window starts at column w0 - 2, shifted by +q
    // for the dY half) into its ring slot
    auto stage = [&](int q) {
      const int col0 = w0 - 2 + (half ? q : 0);
      Slot<Elem>* slot = s_ring + (q & 1) * slot_elems;
      if constexpr (rag::kF32<Elem>)
        stage_plane(slot, dz, b, q, c0, kc, D, Cout, H, W, h0, col0);
      else
        stage_plane<N>(slot, dz, b, q, c0, kc, D, Cout, H, W, h0,
                       col0 & ~(N - 1), vec);
    };
    // dz planes d0-1 .. d_end feed the outputs d0 .. d_end-1
    const int q_lo = max(d0 - 1, 0), q_hi = min(d_end, D - 1);
    if (q_lo <= q_hi) stage(q_lo);
    cp_async_commit();
    for (int q = q_lo; q <= q_hi; ++q) {
      if (q + 1 <= q_hi) stage(q + 1);
      cp_async_commit();
      cp_async_wait_all_but_one();
      __syncthreads();  // plane q (and the weights) visible to every thread
      // the slot's column of window column 0 (bf16: the window's offset in
      // its first piece)
      const int off =
          rag::kF32<Elem> ? 0 : (w0 - 2 + (half ? q : 0)) & (N - 1);
      const Slot<Elem>* slab = s_ring + (q & 1) * slot_elems + off;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const int d = q + 1 - kd;  // the output plane that reads q at tap kd
        if (d < d0 || d >= d_end) continue;
        // staged column of pixel x at tap kw: x + coff + kw
        const int coff = half == 0 ? 1 : 2 - kd;
        bool keep[kPX];
        unsigned sel[kPX];  // bf16: the permute that widens, or gives +0.0
#pragma unroll
        for (int p = 0; p < kPX; ++p) {
          const int j = w0 + tx + p * kTX;
          keep[p] = half == 0 ? j >= d : j + d < W;
          sel[p] = keep[p] ? 0x1044u : 0x4444u;
        }
        for (int co = 0; co < kc; ++co) {
#pragma unroll
          for (int kh = 0; kh < 3; ++kh) {
            const Slot<Elem>* row =
                slab + (co * kSH + ty + kh) * kP + tx + coff;
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
                float v;
                if constexpr (rag::kF32<Elem>)
                  v = keep[p] ? row[kw + p * kTX] : 0.f;
                else  // bytes 0, 1 of the bf16 to the top half, or zeros
                  v = __uint_as_float(__byte_perm(
                      (unsigned)__bfloat16_as_ushort(row[kw + p * kTX]), 0u,
                      sel[p]));
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
// chunks, in ascending chunk order, stored as Elem.
template <class Elem>
__global__ void __launch_bounds__(256)
cvstem_dxy_reduce_kernel(const float* __restrict__ partial,
                         Elem* __restrict__ dX, Elem* __restrict__ dY,
                         long long n, int n_chunks) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= 2 * n) return;
  const int half = i >= n;
  const long long k = i - half * n;
  const float* p = partial + (size_t)half * n_chunks * n + k;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += __ldg(p + (size_t)c * n);
  (half ? dY : dX)[k] = rag::to_elem<Elem>(s);
}

template <int CT, class Elem, int N>
int launch(const Elem* dz, const float* wpk, float* partial, Elem* dX,
           Elem* dY, dim3 grid, int B, int D, int Cout, int C, int H, int W,
           int n_wt, int chunk, int n_chunks, int n_cc, int kc, int vec,
           cudaStream_t stream) {
  // the weights, then two ring slots (ops/cvstem.py::DxyPlan.smem_for)
  const int smem = 27 * kc * CT * (int)sizeof(float) +
                   2 * kc * kSH * kSlotPitch<Elem> * (int)sizeof(Slot<Elem>);
  cudaError_t e = cudaFuncSetAttribute(
      cvstem_dxy_partial_kernel<CT, Elem, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cvstem_dxy_partial_kernel<CT, Elem, N><<<grid, kThreads, smem, stream>>>(
      dz, wpk, partial, B, D, Cout, C, H, W, n_wt, chunk, n_chunks, n_cc, kc,
      vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)B * C * H * W;
  cvstem_dxy_reduce_kernel<Elem><<<(unsigned)((2 * n + 255) / 256), 256, 0,
                                   stream>>>(partial, dX, dY, n, n_chunks);
  return (int)cudaGetLastError();
}

// The elements of the pieces a bf16 dz copies in (ops/cvstem.py::
// dxy_piece): 8 (16 bytes) where W % 8 == 0 and dz is 16-byte aligned, 4
// (8 bytes) where W % 4 == 0 and dz is 8-byte aligned, else 0 (element by
// element).
int dxy_piece(const void* dz, int W) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dz);
  if (W % 8 == 0 && a % 16 == 0) return 8;
  if (W % 4 == 0 && a % 8 == 0) return 4;
  return 0;
}

// The plan's integers (rag_tpu_torch/ops/cvstem.py::dxy_plan): ct channels
// of the half per block (n_cc blocks cover C), chunk planes per block
// (n_chunks cover D), kc dz channels staged per pass. partial:
// 2 * n_chunks * B * C * H * W floats of workspace. dz, dX and dY of
// element type Elem.
template <class Elem>
int dxy_entry(const void* dz, const void* wpk, void* partial, void* dX,
              void* dY, int B, int D, int Cout, int C, int H, int W, int ct,
              int n_cc, int chunk, int n_chunks, int kc, void* stream) {
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
  const Elem* zf = static_cast<const Elem*>(dz);
  const float* wf = static_cast<const float*>(wpk);
  float* pf = static_cast<float*>(partial);
  Elem* xf = static_cast<Elem*>(dX);
  Elem* yf = static_cast<Elem*>(dY);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // float32: N = 1 (one element a copy); bf16: pieces of 8 or 4, or the
  // element path in the layout of pieces of eight
  const int piece = rag::kF32<Elem> ? 1 : dxy_piece(dz, W);
  const int vec = piece > 1;
  auto run = [&](auto ct_c, auto n_c) {
    return launch<decltype(ct_c)::value, Elem, decltype(n_c)::value>(
        zf, wf, pf, xf, yf, grid, B, D, Cout, C, H, W, n_wt, chunk, n_chunks,
        n_cc, kc, vec, st);
  };
  auto by_piece = [&](auto ct_c) {
    if constexpr (rag::kF32<Elem>)
      return run(ct_c, std::integral_constant<int, 1>());
    else if (piece == 4)
      return run(ct_c, std::integral_constant<int, 4>());
    else
      return run(ct_c, std::integral_constant<int, 8>());
  };
  switch (ct) {
    case 4:
      return by_piece(std::integral_constant<int, 4>());
    case 8:
      return by_piece(std::integral_constant<int, 8>());
    case 12:
      return by_piece(std::integral_constant<int, 12>());
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rag_cvstem_dxy(const void* dz, const void* wpk, void* partial,
                              void* dX, void* dY, int B, int D, int Cout,
                              int C, int H, int W, int ct, int n_cc,
                              int chunk, int n_chunks, int kc, void* stream) {
  return dxy_entry<float>(dz, wpk, partial, dX, dY, B, D, Cout, C, H, W, ct,
                          n_cc, chunk, n_chunks, kc, stream);
}

// The same with dz, dX and dY bf16.
extern "C" int rag_cvstem_dxy_bf16(const void* dz, const void* wpk,
                                   void* partial, void* dX, void* dY, int B,
                                   int D, int Cout, int C, int H, int W,
                                   int ct, int n_cc, int chunk, int n_chunks,
                                   int kc, void* stream) {
  return dxy_entry<rag::bf16>(dz, wpk, partial, dX, dY, B, D, Cout, C, H, W,
                              ct, n_cc, chunk, n_chunks, kc, stream);
}
