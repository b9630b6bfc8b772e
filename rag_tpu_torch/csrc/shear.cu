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
// The class table. With u = j - d and k_t = dd - dw in -2..2, an output
// (d, j) keeps px term t where kx = gate(d) & diag(u) has bit t, and py
// term t where ky = kx & edge(j) has it:
//   gate(d)  dd = 0 needs d >= 1, dd = 2 needs d <= D-2   (dd = 1 always)
//   diag(u)  t with k_t <= u: none for u <= -3, 0x004 0x026 0x137 0x1BF for
//            u = -2 -1 0 1, all nine for u >= 2
//   edge(j)  all but dw = 2 (t = 2, 5, 8) at j = W-1
// So the outputs fall in three classes: the interior, ky = all nine
// (1 <= d <= D-2, u >= 2, j <= W-2), where z = P[j] + R[u] with
//   P[j] = sum_t px[t][j],  R[u] = sum_t py[t][u - k_t]   (t ascending),
// two W-long rows per (b, co, h); the zero region, kx = 0 (u <= -3); and
// the rest, term by term in the TPU kernel's order (t ascending, px then
// py): the diagonal band u in [-2, 1], the planes d = 0 and D-1 (every
// plane when D <= 2) and the column j = W-1.
//
// Kernel J replaces rag_tpu/ops/pallas_shear.py::shear_forward (body
// _shear_kernel, gate RAG_TPU_CVSTEM_SHEAR), with its per-channel affine and
// optional ReLU epilogue (frozen BatchNorm folds into it when serving).
// Bound: bytes. At the eval geometry it reads the two 9-map stacks (44 MB)
// and writes the 157 MB output, 0.060 ms at 3.35 TB/s; the output stream
// sets the pace. Design: a block owns one (b, co, h) row and takes it in
// pieces of at most kFwdTileCols columns x kFwdTilePlanes planes (one piece
// at every main-path shape). For a piece of columns [j0, j1) and planes
// [d0, d1) it stages the nine px rows over [j0, j1) and the nine py rows
// over the columns the piece reads, [j0 - d1 - 1, j1 - d0 + 1] within
// [0, W) (16-byte cp.async where W % 4 == 0 and the maps are aligned, else
// 4-byte), and builds P over [j0, j1) and R over the piece's interior u
// there, so shared memory is bounded whatever W and D are. It writes y =
// fmaf(z, a, c) (+ReLU) in groups of G columns: G = 4 (one 16-byte store)
// where W % 4 == 0, else 1. Phase 1 takes the groups that are neither
// wholly interior nor wholly zero, term by term: the first and last planes
// from their first non-zero group, and on the planes between at most two
// band groups (four at G = 1) and the last group. Phase 2 streams the rest:
// a thread walks its group of columns down a run of kFwdPlanes planes, P +
// R or the zero region's fmaf(0, a, c), the same few instructions for every
// thread of a warp. (With both kinds in one loop, a warp waited on the
// band's 18-term sums in most of its iterations.) The interior sums the
// same 18 terms as the TPU kernel in another order; the other classes sum
// them in its order.
//
// Kernel K replaces rag_tpu/ops/pallas_shear.py::shear_adjoint (body
// _shear_adj_kernel): dz (B, D, co, H, W) -> dpx, dpy (B, 9, co, H, W),
//   dpx[t, j] = sum_d g(d+dd-1) [j >= s] dz[d, j]
//             = sum of dz[d, j] down column j over d in [lo, min(hi, j-k)]
//   dpy[t, i] = sum_d g(d+dd-1) [0 <= i+s < W] [i+s <= W-dw] dz[d, i+s]
//             = sum of dz[d, u+d] down diagonal u = i + k over d in
//               [max(lo, -u), min(hi, W-1-u-[dw = 2])]
// with lo = [dd = 0] and hi = D-1-[dd = 2] from the gate. Bound: bytes, dz
// read once (101 MB at the train shape) and 18 maps written (28 MB),
// 0.0385 ms. Design: each thread is one walker: W walk the columns (dpx),
// W + 4 the diagonals u = -2 .. W+1 (dpy; consecutive u read consecutive
// banks). Where the 2W + 4 walkers fit one block (W <= 510, every
// main-path shape), a block owns one (b, co, h) row and stages its D x W
// slab of dz in shared memory (in runs of planes of at most kAdjSlabFloats
// floats, 32 KB for the whole slab at the train shape), each element read
// from device memory once. Wider rows are split over blocks of one kind,
// column blocks and diagonal blocks of at most kAdjMaxThreads walkers;
// each stages, a run at a time, only the columns its walkers read (a
// diagonal block's window slides one column a plane), so shared memory is
// bounded whatever W is and a dz element is read about twice. A walker
// adds its elements in ascending d into two running sums, one from d = 0
// and one from d = 1, carried from run to run, and writes each output at
// the step where its range ends: a column's ends lie in its last five
// steps and a diagonal's in its last two, so the walk is plain adds up to
// that tail. Every output is the sequential ascending-d sum the TPU
// kernel's d grid computes (its masked adds of 0.0 change nothing); no
// float atomics, the same bits on every run.
//
// bf16 at rest (rag_tpu_torch/ops/precision.py): J takes bf16 tap maps
// and stores z in bf16 (rounded to nearest even), K takes a bf16 dz and
// writes dpx and dpy in float32. A bf16 row is staged widened to float32
// by register loads (cp.async cannot widen), 4 bytes of shared memory an
// element, so every sum is the float32 path's; J's bf16 instance stores
// one column at a time (G = 1).
#include <cuda_runtime.h>

#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kFwdMaxThreads = 768;   // J: most threads a block
constexpr int kFwdMinBlocks = 2;      // J: blocks resident an SM (40 registers)
constexpr int kFwdPlanes = 8;        // planes a task of J walks
constexpr int kFwdTileCols = 1024;   // J: most columns a staged piece
constexpr int kFwdTilePlanes = 64;   // J: most planes a staged piece
constexpr int kAdjSlabFloats = 16384;  // K: most dz floats staged at once
constexpr int kAdjMaxThreads = 1024;   // K: most walkers a block
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can take

constexpr unsigned kAll = 0x1FFu;
// diag(u) for u = -2, -1, 0, 1, nine bits each
constexpr unsigned long long kDiagTable =
    0x004ull | 0x026ull << 9 | 0x137ull << 18 | 0x1BFull << 27;
constexpr unsigned kEdgeLast = 0x0DBu;  // edge(W-1): no dw = 2

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// J's shared memory, in floats, for pieces of tw columns x dp planes:
// xs[9][wx] (px), ys[9][wy] (py over the piece's columns j - d - 2 ..
// j - d + 2, widened to 16-byte bounds), P[wx], R[wr] (the piece's interior
// u, at most tw + dp - 1 of them).
struct FwdLayout {
  int wx, wy, wr;
  __host__ __device__ FwdLayout(int W, int tw, int dp)
      : wx(round4(tw)),
        wy(round4(W) < round4(tw + dp + 9) ? round4(W) : round4(tw + dp + 9)),
        wr(W < tw + dp ? W : tw + dp) {}
  __host__ __device__ int floats() const { return 10 * wx + 9 * wy + wr; }
};

__device__ __forceinline__ unsigned diag_bits(int u) {
  if (u < -2) return 0u;
  if (u > 1) return kAll;
  return static_cast<unsigned>(kDiagTable >> (9 * (u + 2))) & kAll;
}

__device__ __forceinline__ unsigned gate_bits(int d, int D) {
  return (d >= 1 ? 0x007u : 0u) | 0x038u | (d <= D - 2 ? 0x1C0u : 0u);
}

__device__ __forceinline__ float affine(float z, float a, float c, int relu) {
  const float y = fmaf(z, a, c);
  return relu ? fmaxf(y, 0.f) : y;
}

// A staged piece in shared memory: xs[t][j - j0], ys[t][i - y0] for py
// columns i in [y0, y1), P[j - j0], R[u - r0].
struct Piece {
  const float* xs;
  const float* ys;
  const float* P;
  const float* R;
  int wx, wy, j0, y0, y1, r0;
};

// One output (d, j) of the staged piece before the affine: the interior
// from P and R, every other class term by term in the TPU kernel's order
// (the zero region keeps no term and gives 0).
__device__ __forceinline__ float shear_elem(const Piece& r, int D, int W,
                                            int d, int j) {
  const int u = j - d;
  const unsigned kx = gate_bits(d, D) & diag_bits(u);
  const unsigned ky = j == W - 1 ? kx & kEdgeLast : kx;
  if (ky == kAll) return r.P[j - r.j0] + r.R[u - r.r0];
  if (kx == 0) return 0.f;
  // every term read (py at j - s = u - k, clamped into the staged columns
  // where the term is dropped), then added or replaced by 0.0: the sum
  // never holds -0.0, so adding 0.0 is skipping the term
  float xv[9], yv[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    xv[t] = r.xs[t * r.wx + j - r.j0];
    yv[t] = r.ys[t * r.wy +
                 min(max(u - (t / 3 - t % 3), r.y0), r.y1 - 1) - r.y0];
  }
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    acc += kx >> t & 1u ? xv[t] : 0.f;
    acc += ky >> t & 1u ? yv[t] : 0.f;
  }
  return acc;
}

// G columns of an output row (G = 4: float32 only, one 16-byte store).
template <int G, class Elem>
__device__ __forceinline__ void store_group(Elem* dst, const float (&y)[G]) {
  if constexpr (G == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
  else
    *dst = rag::to_elem<Elem>(y[0]);
}

// Stage n columns from `from` of the nine rows at src (one tap map apart)
// into dst (rows `pitch` apart), 16-byte copies at G = 4 (float32 only),
// else one element at a time (widened from bf16).
template <int G, class Elem>
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const Elem* src, size_t plane,
                                           int from, int n) {
  const int m = n / G;
  for (int i = threadIdx.x; i < 9 * m; i += blockDim.x) {
    const int r = i / m, q = G * (i - r * m);
    const Elem* s = src + r * plane + from + q;
    if constexpr (G == 4)
      rag::cp_async16(dst + r * pitch + q, s, true);
    else
      rag::stage1(dst + r * pitch + q, s, true);
  }
}

// G: columns a thread stores at once, 4 (16-byte copies and stores, W % 4
// == 0 and aligned maps) or 1. A block owns one row and takes it in pieces
// of tw columns (a multiple of G) x dp planes; a piece's tasks are (run of
// kFwdPlanes planes, group of G columns), one a thread where they fit.
// Two blocks of up to 768 threads stay resident an SM: without the cap the
// piece loop's indices take J to 56 registers, one 640-thread block an SM
// at the eval geometry (PERF.md has both times).
template <int G, class Elem>
__global__ void __launch_bounds__(kFwdMaxThreads, kFwdMinBlocks)
shear_fwd_kernel(const Elem* __restrict__ px, const Elem* __restrict__ py,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, Elem* __restrict__ out,
                 int D, int Co, int H, int W, int relu, int tw, int dp) {
  static_assert(G == 1 || rag::kF32<Elem>, "16-byte groups are float32's");
  extern __shared__ float4 smem4[];
  const FwdLayout lay(W, tw, dp);
  float* xs = reinterpret_cast<float*>(smem4);  // px, 9 rows
  float* ys = xs + 9 * lay.wx;                  // py, 9 rows
  float* P = ys + 9 * lay.wy;
  float* R = P + lay.wx;
  const int CoH = Co * H;
  const size_t plane = (size_t)CoH * W;  // one tap map, one output plane
  const int nG = W / G;
  const long long row = blockIdx.x;
  const int b = (int)(row / CoH), rem = (int)(row - (long long)b * CoH);
  const int co = rem / H;
  const Elem* xrow = px + (size_t)b * 9 * plane + (size_t)rem * W;
  const Elem* yrow = py + (size_t)b * 9 * plane + (size_t)rem * W;
  Elem* orow = out + (size_t)b * D * plane + (size_t)rem * W;
  const float a = __ldg(scale + co), c = __ldg(bias + co);
  const float zero = affine(0.f, a, c, relu);
  const int tiles = (W + tw - 1) / tw;
  const int pieces = tiles * ((D + dp - 1) / dp);

  for (int piece = 0; piece < pieces; ++piece) {
    const int j0 = (piece % tiles) * tw, j1 = min(W, j0 + tw);
    const int d0 = (piece / tiles) * dp, d1 = min(D, d0 + dp);
    // the py columns the piece reads, u - k for u = j - d
    int y0 = max(0, j0 - d1 - 1), y1 = min(W, j1 - d0 + 2);
    if (G == 4) y0 &= ~3, y1 = min(W, round4(y1));
    y1 = max(y1, y0);
    // the interior u of the piece, R's entries
    const int r0 = max(2, j0 - d1 + 1), r1 = min(W - 3, j1 - 1 - d0);
    const Piece pc{xs, ys, P, R, lay.wx, lay.wy, j0, y0, y1, r0};
    stage_rows<G>(xs, lay.wx, xrow, plane, j0, j1 - j0);
    stage_rows<G>(ys, lay.wy, yrow, plane, y0, y1 - y0);
    rag::cp_async_commit();
    rag::cp_async_wait_all();
    __syncthreads();
    // P[j] and R[u], t ascending
    for (int i = threadIdx.x; i < max(j1 - j0, r1 - r0 + 1); i += blockDim.x) {
      if (i < j1 - j0) {
        float p = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) p += xs[t * lay.wx + i];
        P[i] = p;
      }
      if (i <= r1 - r0) {
        float r = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t)
          r += ys[t * lay.wy + r0 + i - (t / 3 - t % 3) - y0];
        R[i] = r;
      }
    }
    __syncthreads();

    // phase 1, the groups that are neither wholly zero nor wholly
    // interior, term by term: from its first non-zero group on, every group
    // of the planes 0 and D-1; on the planes between, the band groups q0 ..
    // (the first interior group) - 1 and the last group (which holds
    // j = W-1), S slots a plane; each within the piece
    constexpr int S = G == 4 ? 3 : 5;
    const int g0 = j0 / G, g1 = j1 / G, ng = g1 - g0;
    const int b0 = max(d0, 1), b1 = min(d1, D - 1);  // the planes between
    const int n_edge = 2 * ng, n_band = max(0, b1 - b0) * S;
    for (int i = threadIdx.x; i < n_edge + n_band; i += blockDim.x) {
      int d, g;
      if (i < n_edge) {
        d = i < ng ? 0 : D - 1;
        g = g0 + (i < ng ? i : i - ng);
        if (d < d0 || d >= d1 || (i >= ng && D == 1)) continue;
        if (g < max(0, d - 2) / G) continue;  // wholly zero: phase 2's
      } else {
        const int s = (i - n_edge) % S;
        d = b0 + (i - n_edge) / S;
        if (s < S - 1) {
          g = max(0, d - 2) / G + s;
          if (g >= (d + 2 + G - 1) / G || g >= nG - 1) continue;
        } else {
          g = nG - 1;
          if (d > W + 1) continue;  // wholly zero: phase 2's
        }
        if (g < g0 || g >= g1) continue;
      }
      float y[G];
#pragma unroll
      for (int k = 0; k < G; ++k)
        y[k] = affine(shear_elem(pc, D, W, d, g * G + k), a, c, relu);
      store_group<G>(orow + (size_t)d * plane + g * G, y);
    }

    // phase 2, the groups wholly in the zero region or wholly interior: a
    // task walks its column group down its run of planes
    const int runs = (d1 - d0 + kFwdPlanes - 1) / kFwdPlanes;
    for (int task = threadIdx.x; task < runs * ng; task += blockDim.x) {
      const int run = task / ng, j = j0 + G * (task - run * ng);
      const int da = d0 + run * kFwdPlanes, db = min(d1, da + kFwdPlanes);
      float p[G];
#pragma unroll
      for (int i = 0; i < G; ++i) p[i] = P[j - j0 + i];
      for (int d = da; d < db; ++d) {
        float y[G];
        if (j + G - 1 - d <= -3) {
#pragma unroll
          for (int i = 0; i < G; ++i) y[i] = zero;
        } else if (d >= 1 && d <= D - 2 && j - d >= 2 && j + G - 1 <= W - 2) {
#pragma unroll
          for (int i = 0; i < G; ++i)
            y[i] = affine(p[i] + R[j + i - d - r0], a, c, relu);
        } else {
          continue;  // phase 1's
        }
        store_group<G>(orow + (size_t)d * plane + j, y);
      }
    }
    __syncthreads();  // the piece's staging is free
  }
}

// A walker's outputs at step d (their ranges end there): column j writes
// dpx[t][j] for each t whose range [lo, min(hi, j - k)] ends at d; diagonal
// u writes dpy[t][u - k] for each t whose [.., min(hi, W-1-u-[dw = 2])]
// ends at d. The sum from d = 1 where dd = 0 (the gate's lo), else from 0.
__device__ __forceinline__ void adj_snapshot(bool col, int j, int u, int d,
                                             float s0, float s1, int D,
                                             int W, size_t plane,
                                             float* xout, float* yout) {
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int dd = t / 3, dw = t % 3, k = dd - dw;
    const int hi = dd == 2 ? D - 2 : D - 1;
    const float v = dd == 0 ? s1 : s0;
    if (col) {
      if (d == min(hi, j - k)) xout[t * plane + j] = v;
    } else {
      const int i = u - k;
      if (i >= 0 && i < W && d == min(hi, W - 1 - u - (dw == 2)))
        yout[t * plane + i] = v;
    }
  }
}

// Stage columns [x0, x1) of planes [c0, c0 + n) of K's row into slab (rows
// `pitch` apart): 16-byte copies with vec (float32 only), else one element
// at a time (widened from bf16).
template <class Elem>
__device__ __forceinline__ void stage_slab(float* slab, int pitch,
                                           const Elem* src, size_t plane,
                                           int n, int x0, int x1, int vec) {
  const int m = vec ? (x1 - x0) >> 2 : x1 - x0;
  for (int i = threadIdx.x; i < n * m; i += blockDim.x) {
    const int r = i / m, q = i - r * m;
    if constexpr (rag::kF32<Elem>) {
      if (vec) {
        rag::cp_async16(slab + r * pitch + 4 * q,
                        src + r * plane + x0 + 4 * q, true);
        continue;
      }
    }
    rag::stage1(slab + r * pitch + q, src + r * plane + x0 + q, true);
  }
}

// A block takes one work item (row, split) and stages the row's dz in runs
// of `planes` planes; the walkers carry their sums from one run to the
// next. ncs = 0: one block a row, its first W threads walk the columns and
// the next W + 4 the diagonals, staging every column. Else splits 0 ..
// ncs-1 walk blockDim.x columns each and the rest blockDim.x diagonals
// each, staging only the columns their walkers read.
template <class Elem>
__global__ void __launch_bounds__(kAdjMaxThreads)
shear_adj_kernel(const Elem* __restrict__ dz, float* __restrict__ dpx,
                 float* __restrict__ dpy, int D, int Co, int H, int W,
                 int splits, int ncs, int planes, int pitch, int vec) {
  extern __shared__ float4 smem4[];
  float* slab = reinterpret_cast<float*>(smem4);
  const long long row = blockIdx.x / splits;
  const int split = (int)(blockIdx.x - row * splits);
  const int CoH = Co * H;
  const int b = (int)(row / CoH), rem = (int)(row - (long long)b * CoH);
  const size_t plane = (size_t)CoH * W;  // one d plane of dz, one tap map
  const Elem* src = dz + (size_t)b * D * plane + (size_t)rem * W;
  float* xout = dpx + (size_t)b * 9 * plane + (size_t)rem * W;
  float* yout = dpy + (size_t)b * 9 * plane + (size_t)rem * W;

  // the walker: column j, or diagonal u, or none; the block's first
  // column (or -1 for a diagonal block) and first diagonal
  const int bd = blockDim.x, tid = threadIdx.x;
  int j, u, xa, ua;
  if (ncs == 0) {
    j = tid, u = tid - W - 2, xa = 0, ua = -2;
  } else if (split < ncs) {
    j = split * bd + tid, u = W + 2, xa = split * bd, ua = W + 2;
  } else {
    ua = (split - ncs) * bd - 2;
    j = W, u = ua + tid, xa = -1;
  }
  const bool col = j < W, diag = !col && u >= -2 && u <= W + 1;
  const int start = diag && u < 0 ? -u : 0;
  const int last = col ? min(D - 1, j + 2) : diag ? min(D - 1, W - 1 - u) : -1;
  const int tail = col ? 4 : 1;  // steps before `last` where ranges end
  const int ts = last - tail;
  // outputs whose range is empty
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int dd = t / 3, dw = t % 3, k = dd - dw;
    const int hi = dd == 2 ? D - 2 : D - 1;
    if (col && min(hi, j - k) < 0) xout[t * plane + j] = 0.f;
    const int i = u - k;
    if (diag && i >= 0 && i < W && min(hi, W - 1 - u - (dw == 2)) < start)
      yout[t * plane + i] = 0.f;
  }

  float s0 = 0.f, s1 = 0.f;  // running sums from d = 0 and from d = 1
  const int step = col ? pitch : pitch + 1;
  for (int c0 = 0; c0 < D; c0 += planes) {
    const int c1 = c0 + planes < D ? c0 + planes : D;
    // the columns this block's walkers read in the run
    int x0, x1;
    if (ncs == 0) {
      x0 = 0, x1 = W;
    } else if (xa >= 0) {
      x0 = xa, x1 = min(W, xa + bd);
    } else {
      x0 = max(0, ua + c0), x1 = min(W, ua + bd + c1 - 1);
      if (vec) x0 &= ~3, x1 = min(W, round4(x1));
      x1 = max(x1, x0);
    }
    stage_slab(slab, pitch, src + (size_t)c0 * plane, plane, c1 - c0, x0, x1,
               vec);
    rag::cp_async_commit();
    rag::cp_async_wait_all();
    __syncthreads();

    if (col || diag) {
      const int lo = c0 > start ? c0 : start;
      const int stop = c1 < ts ? c1 : ts;  // plain adds before the tail
      int d = lo;
      int at = (d - c0) * pitch + (col ? j : u + d) - x0;
      if (d == 0 && d < stop) {
        s0 += slab[at];
        at += step;
        ++d;
      }
#pragma unroll 4
      for (; d < stop; ++d, at += step) {
        const float v = slab[at];
        s0 += v;
        s1 += v;
      }
#pragma unroll
      for (int r = 0; r <= 4; ++r) {
        const int dt = ts + r;
        if (r <= tail && dt >= lo && dt < c1) {
          const float v = slab[(dt - c0) * pitch + (col ? j : u + dt) - x0];
          s0 += v;
          if (dt >= 1) s1 += v;
          adj_snapshot(col, j, u, dt, s0, s1, D, W, plane, xout, yout);
        }
      }
    }
    __syncthreads();  // the slab is free
  }
}

bool bad_shape(int B, int D, int Co, int H, int W) {
  return B <= 0 || D <= 0 || Co <= 0 || H <= 0 || W <= 0 ||
         (long long)Co * H * W > 2147483647LL ||
         (long long)B * D * Co > 2147483647LL;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int set_smem(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int round32(int n) { return (n + 31) / 32 * 32; }

// A launch of J or K: blocks, threads a block, shared memory, the planes
// and columns a staged piece (J) or run (K; columns: the slab's row
// pitch), pieces or runs a row, 16-byte copies, blocks a row (K's splits)
// and K's column blocks a row (0: one block walks both kinds).
struct Plan {
  int threads, planes, cols, runs, vec, splits, ncs;
  long long blocks;
  size_t smem;
};

// J: a block a row, pieces of tw columns x dp planes (column tiles and
// plane chunks of even size), a thread a task (run of kFwdPlanes planes,
// group of columns) of a piece, at most kFwdMaxThreads. 16-byte copies and
// stores (G = 4) for float32 maps only.
template <class Elem>
int fwd_plan(int B, int D, int Co, int H, int W, bool aligned, Plan* p) {
  p->vec = rag::kF32<Elem> && (W % 4 == 0) && aligned;
  p->splits = 1, p->ncs = 0;
  const int tiles = (W + kFwdTileCols - 1) / kFwdTileCols;
  int tw = (W + tiles - 1) / tiles;
  if (p->vec) tw = round4(tw);
  const int chunks = (D + kFwdTilePlanes - 1) / kFwdTilePlanes;
  const int dp = (D + chunks - 1) / chunks;
  p->cols = tw, p->planes = dp;
  p->runs = ((W + tw - 1) / tw) * ((D + dp - 1) / dp);
  const long long tasks = (long long)((dp + kFwdPlanes - 1) / kFwdPlanes) *
                          (p->vec ? tw / 4 : tw);
  p->threads = tasks < kFwdMaxThreads ? round32((int)tasks) : kFwdMaxThreads;
  p->blocks = (long long)B * Co * H;
  p->smem = (size_t)FwdLayout(W, tw, dp).floats() * sizeof(float);
  if (p->blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if constexpr (rag::kF32<Elem>) {
    if (p->vec) return set_smem((const void*)shear_fwd_kernel<4, Elem>,
                                p->smem);
  }
  return set_smem((const void*)shear_fwd_kernel<1, Elem>, p->smem);
}

// K: 2W + 4 walkers a row, one block where they fit kAdjMaxThreads, else
// ceil(W / kAdjMaxThreads) column blocks and ceil((W + 4) / kAdjMaxThreads)
// diagonal blocks of equal size; each row's dz staged in runs of planes of
// equal length, at most kAdjSlabFloats floats a run. 16-byte copies for a
// float32 dz only.
template <class Elem>
int adj_plan(int B, int D, int Co, int H, int W, bool aligned, Plan* p) {
  p->vec = rag::kF32<Elem> && (W % 4 == 0) && aligned;
  const int walkers = 2 * W + 4;
  int most;
  if (walkers <= kAdjMaxThreads) {
    p->threads = round32(walkers);
    p->splits = 1, p->ncs = 0;
    most = kAdjSlabFloats / W;
  } else {
    p->ncs = (W + kAdjMaxThreads - 1) / kAdjMaxThreads;
    const int nds = (W + 4 + kAdjMaxThreads - 1) / kAdjMaxThreads;
    const int per_col = (W + p->ncs - 1) / p->ncs;
    const int per_diag = (W + 4 + nds - 1) / nds;
    p->threads = round32(per_col > per_diag ? per_col : per_diag);
    p->splits = p->ncs + nds;
    // a diagonal block reads threads + planes - 1 columns a run
    most = 1;
    while ((most + 1) * round4(p->threads + most + 9) <= kAdjSlabFloats)
      ++most;
  }
  if (most < 1) most = 1;
  p->runs = (D + most - 1) / most;
  p->planes = (D + p->runs - 1) / p->runs;
  p->cols = p->ncs == 0 ? W : round4(p->threads + p->planes + 8);
  p->blocks = (long long)B * Co * H * p->splits;
  p->smem = (size_t)p->planes * p->cols * sizeof(float);
  return p->blocks > 2147483647LL
             ? (int)cudaErrorInvalidValue
             : set_smem((const void*)shear_adj_kernel<Elem>, p->smem);
}

// px, py and out of element type Elem.
template <class Elem>
int fwd_entry(const void* px, const void* py, const void* scale,
              const void* bias, void* out, int B, int D, int Co, int H,
              int W, int relu, void* stream) {
  if (bad_shape(B, D, Co, H, W)) return (int)cudaErrorInvalidValue;
  Plan p;
  if (const int e = fwd_plan<Elem>(
          B, D, Co, H, W, aligned16(px) && aligned16(py) && aligned16(out),
          &p))
    return e;
  auto kernel = shear_fwd_kernel<1, Elem>;
  if constexpr (rag::kF32<Elem>) {
    if (p.vec) kernel = shear_fwd_kernel<4, Elem>;
  }
  kernel<<<(unsigned)p.blocks, p.threads, p.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Elem*>(px), static_cast<const Elem*>(py),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<Elem*>(out), D, Co, H, W, relu, p.cols, p.planes);
  return (int)cudaGetLastError();
}

// dz of element type Elem.
template <class Elem>
int adj_entry(const void* dz, void* dpx, void* dpy, int B, int D, int Co,
              int H, int W, void* stream) {
  if (bad_shape(B, D, Co, H, W)) return (int)cudaErrorInvalidValue;
  Plan p;
  if (const int e = adj_plan<Elem>(B, D, Co, H, W, aligned16(dz), &p))
    return e;
  shear_adj_kernel<Elem><<<(unsigned)p.blocks, p.threads, p.smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Elem*>(dz), static_cast<float*>(dpx),
      static_cast<float*>(dpy), D, Co, H, W, p.splits, p.ncs, p.planes,
      p.cols, p.vec);
  return (int)cudaGetLastError();
}

}  // namespace

// px, py: (B, 9, Co, H, W); scale, bias: (Co,); out: (B, D, Co, H, W).
extern "C" int rag_shear_fwd(const void* px, const void* py,
                             const void* scale, const void* bias, void* out,
                             int B, int D, int Co, int H, int W, int relu,
                             void* stream) {
  return fwd_entry<float>(px, py, scale, bias, out, B, D, Co, H, W, relu,
                          stream);
}

// The same with px, py and out bf16.
extern "C" int rag_shear_fwd_bf16(const void* px, const void* py,
                                  const void* scale, const void* bias,
                                  void* out, int B, int D, int Co, int H,
                                  int W, int relu, void* stream) {
  return fwd_entry<rag::bf16>(px, py, scale, bias, out, B, D, Co, H, W, relu,
                              stream);
}

// dz: (B, D, Co, H, W); dpx, dpy: (B, 9, Co, H, W).
extern "C" int rag_shear_adj(const void* dz, void* dpx, void* dpy, int B,
                             int D, int Co, int H, int W, void* stream) {
  return adj_entry<float>(dz, dpx, dpy, B, D, Co, H, W, stream);
}

// The same with dz bf16 (dpx and dpy float32).
extern "C" int rag_shear_adj_bf16(const void* dz, void* dpx, void* dpy, int B,
                                  int D, int Co, int H, int W, void* stream) {
  return adj_entry<rag::bf16>(dz, dpx, dpy, B, D, Co, H, W, stream);
}

// The launch of J (adjoint = 0; 16-byte aligned maps assumed) or K
// (adjoint = 1) at a shape, as the two entries above choose it: out[0..8]
// = blocks, threads a block, shared bytes a block, planes and columns a
// staged piece or run, pieces or runs a row, 16-byte copies (1) or 4-byte
// (0), blocks a row, K's column blocks a row (0: one block walks both
// kinds).
extern "C" int rag_shear_plan(int adjoint, int B, int D, int Co, int H,
                              int W, void* out) {
  if (bad_shape(B, D, Co, H, W)) return (int)cudaErrorInvalidValue;
  Plan p;
  if (const int e = adjoint ? adj_plan<float>(B, D, Co, H, W, true, &p)
                            : fwd_plan<float>(B, D, Co, H, W, true, &p))
    return e;
  long long* o = static_cast<long long*>(out);
  o[0] = p.blocks, o[1] = p.threads, o[2] = (long long)p.smem;
  o[3] = p.planes, o[4] = p.cols, o[5] = p.runs, o[6] = p.vec;
  o[7] = p.splits, o[8] = p.ncs;
  return 0;
}
