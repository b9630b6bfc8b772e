// Kernels C and G: the fused disparity head and its backward.
//
// Kernel C replaces the TPU kernel
// rag_tpu/ops/pallas_kernels.py::_disp_pallas_raw (body _disp_kernel). For
// a (B, D, h, w) float32 matching cost it computes, per output pixel
// (ho, wo) of the (B, Ho, Wo) = (B, scale*h, scale*w) map,
//   y[k] = trilinear upsample (align_corners=False) of the cost to
//          (maxdisp, Ho, Wo), at disparity level k;
//   out  = sum_k k * softmax(-y)[k].
// The (B, maxdisp, Ho, Wo) volume (354 MB at the eval geometry) is never
// stored.
//
// Kernel G replaces rag_tpu/ops/pallas_kernels.py::_disp_bwd_pallas (body
// _disp_bwd_kernel): dx = U_d^T U_h^T U_w^T dy with dy_k = -p_k (k - out) g,
// at scale 3.
//
// Bound on the H100: operations. C does ~1 GFLOP at the eval geometry
// (0.0145 ms at the float32 peak) against 13 MB in and 1.8 MB out; G ~1.5
// GFLOP at the train shape (0.022 ms) against 6.7 MB in and 8.4 MB out.
// Every output pixel needs maxdisp exponentials (G twice); at the SFU's 16
// a clock per SM those alone take ~0.02 ms for C at the eval geometry.
// In practice both kernels are bound by instruction issue: each level
// costs a few float32 instructions besides its exponential, so the design
// removes every instruction a level does not need.
//
// Design. One thread per output pixel. The H/W interpolation is separable
// from the D one: a thread blends its four H/W source taps for every cost
// level. At maxdisp = 3*D (the main path) the D axis is periodic in the
// level k with period 3: level 3m+1 reads source level m with weight 1,
// level 3m reads (m-1, m) and level 3m+2 reads (m, m+1) with two
// per-residue weights, and levels 0 and maxdisp-1 read one level with
// weight 1. The periodic instance (D a template parameter, loops fully
// unrolled) keeps the D blended levels in registers and walks them by
// source level, each level's two weights from four per-residue constants:
// no table lookup and no shared-memory load a level. The max of -y over
// the levels is taken over the D blended source levels: every level is a
// convex combination of two neighbours, so that is the same max up to
// float32 rounding, and a shift of the exponent leaves the softmin
// unchanged. Then one walk takes sum(e) and sum(k e). Other shapes
// (maxdisp not 3*D, D without an instance, or scale not 3) run the general
// instance of the same kernel: the per-level two-tap table, whose lower
// tap advances by at most one a level (maxdisp >= D), so the walk keeps
// the two live source levels in registers and blends the next on demand.
// The weights are copied from the float32 matrices the plain version
// contracts with (ops/disparity.py), so they are the same bits.
//
// Kernel C's block is 3 output rows (3j .. 3j+2, which read the same three
// source rows) x 32 columns, 96 threads, every lane live where Wo % 32 ==
// 0 (960 and 384 on the main path). Its periodic instance first stages the
// block's source tile, D levels x 3 rows x 14 columns (10.75 KB at D =
// 64), into shared memory, each thread copying a fixed (row, column) at
// every other level; the blend then reads the tile at fixed offsets, with
// no address arithmetic a level.
//
// Kernel G, pass 1: one warp owns a strip of kStrip = 10 source columns of
// one output row and the 32 output columns whose W taps read them (the
// strip's 30 and a one-column halo each side, recomputed by the
// neighbouring strip). Each lane recomputes its pixel's softmin as C does
// (blending from x directly), walks the levels again (the exponential
// recomputed, nothing stored) to form dy_k and folds it through the D taps
// into D accumulators that live in registers only between their first and
// last tap. The warp then folds W through shared memory: each source
// column sums its five output columns in a fixed order with weights from
// the matrix, and the warp writes e_w (B, D, Ho, w), 25.2 MB at the train
// shape, which stays in the 50 MB L2. Pass 2 folds H: dx[b, m, hi, wi]
// sums e_w over its five output rows in a fixed order, reading along wi.
// No atomics: two launches give the same bits.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kLanes = 32;
constexpr int kTileRows = 3;   // a block's output rows 3j .. 3j+2 (C and G)
constexpr int kTileCols = 32;  // C: output columns of a block's rows
constexpr int kSrcCols = 14;   // staged source columns (periodic instances)
constexpr int kSrcPitch = kTileRows * kSrcCols;  // staged floats a level
constexpr int kStrip = 10;     // G: source columns of a warp's strip
constexpr int kWin = 5;        // output rows/columns a source one gets
constexpr int kPitch = kLanes + 1;  // G's fold buffer row: no bank conflicts
constexpr int kBlock = kTileRows * kTileCols;  // C's block: 96 threads
constexpr int kFoldWarps = 4;       // G's pass-1 block: 4 strips of a row
constexpr int kFoldMinBlocks = 4;   // G's pass 1: at most 128 registers
constexpr int kGatherThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// v, opaque to the compiler: values computed from it are not merged with
// the same values computed from v itself.
__device__ __forceinline__ float opaque(float v) {
  asm volatile("" : "+f"(v));
  return v;
}

// A pixel's H/W taps: offsets of its four source texels within one cost
// level of its source (rows of rs floats, from row r0 and column c0), and
// their weights.
struct Taps {
  int o00, o01, o10, o11;
  float a0, a1, b0, b1;
};

// tab_i / tab_w: int32 / float32 (maxdisp + Ho + Wo, 2) tap tables, rows
// [0, maxdisp) for D, then Ho rows for H, then Wo rows for W.
__device__ __forceinline__ Taps pixel_taps(const int* __restrict__ tab_i,
                                           const float* __restrict__ tab_w,
                                           int maxdisp, int Ho, int ho,
                                           int wo, int rs, int r0, int c0) {
  const int hr = 2 * (maxdisp + ho), wr = 2 * (maxdisp + Ho + wo);
  const int h0 = (__ldg(tab_i + hr) - r0) * rs;
  const int h1 = (__ldg(tab_i + hr + 1) - r0) * rs;
  const int w0 = __ldg(tab_i + wr) - c0, w1 = __ldg(tab_i + wr + 1) - c0;
  return {h0 + w0,           h0 + w1,           h1 + w0,
          h1 + w1,           __ldg(tab_w + hr), __ldg(tab_w + hr + 1),
          __ldg(tab_w + wr), __ldg(tab_w + wr + 1)};
}

// The general instance's source: cost levels read from x.
struct GlobalSrc {
  const float* __restrict__ xb;  // x[b]
  size_t plane;
  Taps t;
  __device__ __forceinline__ float level(int m) const {
    const float* p = xb + (size_t)m * plane;
    const float r0 = fmaf(t.b0, __ldg(p + t.o00), t.b1 * __ldg(p + t.o01));
    const float r1 = fmaf(t.b0, __ldg(p + t.o10), t.b1 * __ldg(p + t.o11));
    return fmaf(t.a0, r0, t.a1 * r1);
  }
};

// The periodic instances' source: the block's staged tile, kSrcPitch
// floats a level (the same blend, from shared memory at fixed offsets).
struct TileSrc {
  const float* tile;
  Taps t;
  __device__ __forceinline__ float level(int m) const {
    const float* p = tile + m * kSrcPitch;
    const float r0 = fmaf(t.b0, p[t.o00], t.b1 * p[t.o01]);
    const float r1 = fmaf(t.b0, p[t.o10], t.b1 * p[t.o11]);
    return fmaf(t.a0, r0, t.a1 * r1);
  }
};

// Stage x[b, m, r0 + i, c0 + c] (i < kTileRows, c < kSrcCols, clamped into
// the map; the clamped copies are never read) for the D levels. Thread t <
// 2 kSrcPitch owns one (i, c) and the levels m = t / kSrcPitch (mod 2):
// its source offset is fixed, so an element costs a pointer step, a load
// and a store (unrolled: every load in flight at once).
template <int D>
__device__ __forceinline__ void stage_tile(float* tile,
                                           const float* __restrict__ xb,
                                           int h, int w, int r0, int c0) {
  static_assert(D % 2 == 0 && kBlock >= 2 * kSrcPitch, "two levels a step");
  const int t = threadIdx.x;
  if (t < 2 * kSrcPitch) {
    const int gm = t / kSrcPitch, rem = t - gm * kSrcPitch;
    const int i = rem / kSrcCols, c = rem - i * kSrcCols;
    const int r = min(max(r0 + i, 0), h - 1);
    const int col = min(max(c0 + c, 0), w - 1);
    const size_t plane = (size_t)h * w;
    const float* src = xb + gm * plane + (size_t)r * w + col;
#pragma unroll
    for (int it = 0; it < D / 2; ++it)
      tile[(2 * it + gm) * kSrcPitch + rem] = __ldg(src + 2 * it * plane);
  }
  __syncthreads();
}

// The periodic instance's per-residue D weights (ops/disparity.py::
// d_residues_np): level 3m reads (m-1, m) with (c0, c1), level 3m+2 reads
// (m, m+1) with (c2, c3).
struct Residues {
  float c0, c1, c2, c3;
};

__device__ __forceinline__ Residues residues(const float* __restrict__ r) {
  return {__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3)};
}

// Blend the D levels into registers; returns their minimum.
template <int D, class Src>
__device__ __forceinline__ float load_levels(const Src& src, float (&s)[D]) {
  float smin = CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < D; ++m) {
    s[m] = src.level(m);
    smin = fminf(smin, s[m]);
  }
  return smin;
}

// Visit the 3D levels of the periodic instance in order: f.one(k, y, m)
// for a level that reads source level m alone (weight 1), f.two(k, y, m,
// wm, wm1) for one that reads m and m + 1.
template <int D, class F>
__device__ __forceinline__ void periodic_levels(const float (&s)[D],
                                                const Residues& c, F& f) {
#pragma unroll
  for (int m = 0; m < D; ++m) {
    if (m == 0)
      f.one(0, s[0], 0);
    else
      f.two(3 * m, fmaf(c.c0, s[m - 1], c.c1 * s[m]), m - 1, c.c0, c.c1);
    f.one(3 * m + 1, s[m], m);
    if (m == D - 1)
      f.one(3 * m + 2, s[m], m);
    else
      f.two(3 * m + 2, fmaf(c.c2, s[m], c.c3 * s[m + 1]), m, c.c2, c.c3);
  }
}

// The general instance's minimum over the d blended source levels.
__device__ __forceinline__ float general_min(const GlobalSrc& src, int d) {
  float smin = CUDART_INF_F;
  for (int m = 0; m < d; ++m) smin = fminf(smin, src.level(m));
  return smin;
}

// Visit the levels of the general instance: per level the table's lower
// tap i0 and weights (w0 on i0, w1 on i0 + 1; w1 = 0 where the row has one
// tap). i0 starts at 0 and advances by at most one a level, so the two live
// source levels stay in registers and the next is blended on demand.
// f.advance(a) is called once source level a has had its last level.
template <class F>
__device__ __forceinline__ void general_levels(
    const GlobalSrc& src, int d, int maxdisp, const int* __restrict__ tab_i,
    const float* __restrict__ tab_w, F& f) {
  int a = 0;
  float lo = src.level(0);
  float hi = d > 1 ? src.level(1) : lo;
  for (int k = 0; k < maxdisp; ++k) {
    if (__ldg(tab_i + 2 * k) != a) {
      f.advance(a);
      ++a;
      lo = hi;
      hi = a + 1 < d ? src.level(a + 1) : lo;
    }
    const float w0 = __ldg(tab_w + 2 * k), w1 = __ldg(tab_w + 2 * k + 1);
    f.level(k, fmaf(w0, lo, w1 * hi), w0, w1);
  }
}

// Softmin sums over the levels: e_k = exp(smin - y_k), se = sum e_k,
// sde = sum k e_k (exp as 2^x of the exponent in log2 units).
struct Sums {
  float sl;  // smin * log2(e)
  float se = 0.f, sde = 0.f;
  __device__ __forceinline__ void add(int k, float y) {
    const float e = ex2(fmaf(-y, kLog2e, sl));
    se += e;
    sde = fmaf((float)k, e, sde);
  }
  __device__ __forceinline__ void one(int k, float y, int) { add(k, y); }
  __device__ __forceinline__ void two(int k, float y, int, float, float) {
    add(k, y);
  }
  __device__ __forceinline__ void level(int k, float y, float, float) {
    add(k, y);
  }
  __device__ __forceinline__ void advance(int) {}
};

// dy_k = -p_k (k - out) g = e_k (k qk + q0), qk = -g / se, q0 = -out qk.
struct Grad {
  float sl, qk, q0;
  __device__ __forceinline__ Grad(const Sums& s, float g)
      : sl(s.sl), qk(-g / s.se), q0(s.sde / s.se * (g / s.se)) {}
  __device__ __forceinline__ float dy(int k, float y) const {
    return ex2(fmaf(-y, kLog2e, sl)) * fmaf((float)k, qk, q0);
  }
};

// Kernel G's D fold, periodic instance: D accumulators, each live in
// registers from its first tap to its last (levels 3m-1 .. 3m+3), then
// stored to the lane's fold-buffer column.
template <int D>
struct FoldPeriodic {
  Grad gr;
  float* col;
  float acc[D];
  __device__ __forceinline__ void one(int k, float y, int m) {
    acc[m] += gr.dy(k, y);
    if (k == 3 * D - 1) col[m * kPitch] = acc[m];
  }
  __device__ __forceinline__ void two(int k, float y, int m, float wm,
                                      float wm1) {
    const float v = gr.dy(k, y);
    acc[m] = fmaf(wm, v, acc[m]);
    acc[m + 1] = fmaf(wm1, v, acc[m + 1]);
    if (k % 3 == 0) col[m * kPitch] = acc[m];  // level 3(m+1): m's last tap
  }
};

// Kernel G's D fold, general instance: the accumulators of the two live
// source levels; a finished one goes to the lane's fold-buffer column.
struct FoldGeneral {
  Grad gr;
  float* col;
  float cur = 0.f, nxt = 0.f;
  __device__ __forceinline__ void level(int k, float y, float w0, float w1) {
    const float v = gr.dy(k, y);
    cur = fmaf(w0, v, cur);
    nxt = fmaf(w1, v, nxt);
  }
  __device__ __forceinline__ void advance(int a) {
    col[a * kPitch] = cur;
    cur = nxt;
    nxt = 0.f;
  }
};

// Kernel C: a block is kTileRows output rows (3j ..) x kTileCols columns,
// one thread a pixel. D > 0: the periodic instance for that D (scale 3,
// the source tile staged); D == 0: the general one.
template <int D>
__global__ void __launch_bounds__(kBlock)
soft_argmin_kernel(const float* __restrict__ x, const int* __restrict__ tab_i,
                   const float* __restrict__ tab_w,
                   const float* __restrict__ res, float* __restrict__ out,
                   int d, int h, int w, int maxdisp, int Ho, int Wo) {
  __shared__ float tile[D > 0 ? D * kSrcPitch : 1];
  const int b = blockIdx.z, j = blockIdx.y;
  const int ho = kTileRows * j + threadIdx.x / kTileCols;
  const int wo = blockIdx.x * kTileCols + threadIdx.x % kTileCols;
  const size_t plane = (size_t)h * w;
  const float* xb = x + (size_t)b * d * plane;
  const bool live = ho < Ho && wo < Wo;
  Sums sums;
  if constexpr (D > 0) {
    const int r0 = j - 1, c0 = blockIdx.x * kTileCols / 3 - 1;
    stage_tile<D>(tile, xb, h, w, r0, c0);
    if (!live) return;
    const TileSrc src{tile, pixel_taps(tab_i, tab_w, maxdisp, Ho, ho, wo,
                                       kSrcCols, r0, c0)};
    float s[D];
    sums.sl = load_levels(src, s) * kLog2e;
    periodic_levels(s, residues(res), sums);
  } else {
    if (!live) return;
    const GlobalSrc src{xb, plane,
                        pixel_taps(tab_i, tab_w, maxdisp, Ho, ho, wo, w, 0, 0)};
    sums.sl = general_min(src, d) * kLog2e;
    general_levels(src, d, maxdisp, tab_i, tab_w, sums);
  }
  out[((size_t)b * Ho + ho) * Wo + wo] = sums.sde / sums.se;
}

// Kernel G, pass 1: warp tasks (b, ho, strip) in order, kFoldWarps a
// block; lane l computes output column 3 * q0 - 1 + l of the strip
// starting at source column q0 and writes its D folded values to column l
// of the warp's (D, kPitch) fold buffer; then the warp folds W into e_w.
// fold: (w + h, kWin) window weights, row q = U[3q - 1 + i, q] of the W
// matrix, then the H rows.
template <int D>
__global__ void __launch_bounds__(kFoldWarps * kLanes, kFoldMinBlocks)
soft_argmin_fold_kernel(const float* __restrict__ x,
                        const float* __restrict__ g,
                        const int* __restrict__ tab_i,
                        const float* __restrict__ tab_w,
                        const float* __restrict__ res,
                        const float* __restrict__ fold,
                        float* __restrict__ ew, int d, int h, int w,
                        int maxdisp, int Ho, int Wo, int strips, int tasks) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int task = blockIdx.x * kFoldWarps + warp;
  if (task >= tasks) return;  // the whole warp
  const int strip = task % strips, r = task / strips, ho = r % Ho,
            b = r / Ho;
  const int q0 = strip * kStrip;
  const int ncols = min(kStrip, w - q0);
  const int dd = D > 0 ? D : d;
  float* buf = smem + warp * dd * kPitch;
  float* col = buf + lane;
  const int wo = 3 * q0 - 1 + lane;
  if (wo >= 0 && wo < Wo && lane < 3 * ncols + 2) {
    const size_t plane = (size_t)h * w;
    const GlobalSrc src{
        x + (size_t)b * dd * plane, plane,
        pixel_taps(tab_i, tab_w, maxdisp, Ho, ho, wo, w, 0, 0)};
    const float gv = __ldg(g + ((size_t)b * Ho + ho) * Wo + wo);
    Sums sums;
    if constexpr (D > 0) {
      float s[D];
      sums.sl = load_levels(src, s) * kLog2e;
      const Residues c = residues(res);
      periodic_levels(s, c, sums);
      // the second walk recomputes its logits and exponentials: through
      // opaque constants, or the compiler keeps the first walk's 192 live
      sums.sl = opaque(sums.sl);
      const Residues c2 = {opaque(c.c0), opaque(c.c1), opaque(c.c2),
                           opaque(c.c3)};
      FoldPeriodic<D> f{Grad(sums, gv), col};
#pragma unroll
      for (int m = 0; m < D; ++m) f.acc[m] = 0.f;
      periodic_levels(s, c2, f);
    } else {
      sums.sl = general_min(src, d) * kLog2e;
      general_levels(src, d, maxdisp, tab_i, tab_w, sums);
      FoldGeneral f{Grad(sums, gv), col};
      general_levels(src, d, maxdisp, tab_i, tab_w, f);
      col[(d - 1) * kPitch] = f.cur;
    }
  } else {
    // outside the map or past the strip: zero, read with weight 0
    for (int m = 0; m < dd; ++m) col[m * kPitch] = 0.f;
  }
  __syncwarp();
  // W fold: lane (jj, mr) = (lane % kStrip, lane / kStrip) sums source
  // column q0 + jj at levels mr, mr + 3, ...; lanes 30 and 31 idle
  const int jj = lane % kStrip, mr = lane / kStrip;
  if (mr >= 3 || jj >= ncols) return;
  const int q = q0 + jj;
  float wf[kWin];
#pragma unroll
  for (int i = 0; i < kWin; ++i) wf[i] = __ldg(fold + q * kWin + i);
  const float* fb = buf + 3 * jj;
  float* dst = ew + ((size_t)b * dd * Ho + ho) * w + q;
  const size_t mstride = (size_t)Ho * w;
  for (int m = mr; m < dd; m += 3) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < kWin; ++i) v = fmaf(wf[i], fb[m * kPitch + i], v);
    dst[m * mstride] = v;
  }
}

// Kernel G, pass 2: per input voxel (b, m, hi, wi), the H fold of e_w over
// output rows 3 hi - 1 + i, i = 0..4 in order (rows outside the map
// skipped). fold_h: (h, kWin) window weights of the H matrix.
__global__ void __launch_bounds__(kGatherThreads)
soft_argmin_gather_kernel(const float* __restrict__ ew,
                          const float* __restrict__ fold_h,
                          float* __restrict__ dx, int h, int w, int Ho,
                          int total) {
  const int idx = blockIdx.x * kGatherThreads + threadIdx.x;
  if (idx >= total) return;
  const int wi = idx % w, r = idx / w, hi = r % h, bm = r / h;
  const float* src = ew + (size_t)bm * Ho * w + wi;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < kWin; ++i) {
    const int o = 3 * hi - 1 + i;
    if (o >= 0 && o < Ho)
      v = fmaf(__ldg(fold_h + hi * kWin + i), src[(size_t)o * w], v);
  }
  dx[idx] = v;
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// instance: 0 (general) or D of a compiled periodic instance, which takes
// maxdisp = 3 D at scale 3.
bool valid_instance(int instance, int D, int h, int w, int maxdisp, int Ho,
                    int Wo) {
  if (instance == 0) return true;
  return instance == D && (D == 8 || D == 64) && maxdisp == 3 * D &&
         Ho == 3 * h && Wo == 3 * w;
}

template <int D>
int launch_c(const void* x, const void* tab_i, const void* tab_w,
             const void* res, void* out, int B, int d, int h, int w,
             int maxdisp, int Ho, int Wo, cudaStream_t st) {
  const dim3 grid((Wo + kTileCols - 1) / kTileCols,
                  (Ho + kTileRows - 1) / kTileRows, B);
  soft_argmin_kernel<D><<<grid, kBlock, 0, st>>>(
      static_cast<const float*>(x), static_cast<const int*>(tab_i),
      static_cast<const float*>(tab_w), static_cast<const float*>(res),
      static_cast<float*>(out), d, h, w, maxdisp, Ho, Wo);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fold(const void* x, const void* g, const void* tab_i,
                const void* tab_w, const void* res, const void* fold,
                void* ew, int B, int d, int h, int w, int maxdisp,
                cudaStream_t st) {
  const size_t smem = (size_t)kFoldWarps * d * kPitch * sizeof(float);
  if (const int e = set_smem((const void*)soft_argmin_fold_kernel<D>, smem))
    return e;
  const int strips = (w + kStrip - 1) / kStrip, tasks = B * 3 * h * strips;
  soft_argmin_fold_kernel<D><<<(tasks + kFoldWarps - 1) / kFoldWarps,
                               kFoldWarps * kLanes, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const int*>(tab_i), static_cast<const float*>(tab_w),
      static_cast<const float*>(res), static_cast<const float*>(fold),
      static_cast<float*>(ew), d, h, w, maxdisp, 3 * h, 3 * w, strips, tasks);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel C. instance: 0 for the general instance, else D (8 or 64) for the
// periodic one (ops/disparity.py::head_plan decides by shape). res: the
// periodic instance's four residue weights.
extern "C" int rag_soft_argmin(const void* x, const void* tab_i,
                               const void* tab_w, const void* res, void* out,
                               int B, int D, int h, int w, int maxdisp,
                               int Ho, int Wo, int instance, void* stream) {
  if (B <= 0 || D <= 0 || h <= 0 || w <= 0 || maxdisp < D || Ho <= 0 ||
      Wo <= 0 || B > 65535 || (Ho + kTileRows - 1) / kTileRows > 65535 ||
      !valid_instance(instance, D, h, w, maxdisp, Ho, Wo))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (instance) {
    case 8:
      return launch_c<8>(x, tab_i, tab_w, res, out, B, D, h, w, maxdisp, Ho,
                         Wo, st);
    case 64:
      return launch_c<64>(x, tab_i, tab_w, res, out, B, D, h, w, maxdisp, Ho,
                          Wo, st);
    default:
      return launch_c<0>(x, tab_i, tab_w, res, out, B, D, h, w, maxdisp, Ho,
                         Wo, st);
  }
}

// Kernel G at scale 3 (Ho = 3h, Wo = 3w). ew: the (B, D, Ho, w) workspace;
// passes: bit 1 runs pass 1 (D and W folds into ew), bit 2 pass 2 (H fold
// into dx). One pass alone is for timing.
extern "C" int rag_soft_argmin_bwd(const void* x, const void* g,
                                   const void* tab_i, const void* tab_w,
                                   const void* res, const void* fold,
                                   void* ew, void* dx, int B, int D, int h,
                                   int w, int maxdisp, int Ho, int Wo,
                                   int instance, int passes, void* stream) {
  if (B <= 0 || D <= 0 || h <= 0 || w <= 0 || maxdisp < D || Ho != 3 * h ||
      Wo != 3 * w || (long long)B * D * Ho * w > INT_MAX ||
      !valid_instance(instance, D, h, w, maxdisp, Ho, Wo))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (passes & 1) {
    int e;
    switch (instance) {
      case 8:
        e = launch_fold<8>(x, g, tab_i, tab_w, res, fold, ew, B, D, h, w,
                           maxdisp, st);
        break;
      case 64:
        e = launch_fold<64>(x, g, tab_i, tab_w, res, fold, ew, B, D, h, w,
                            maxdisp, st);
        break;
      default:
        e = launch_fold<0>(x, g, tab_i, tab_w, res, fold, ew, B, D, h, w,
                           maxdisp, st);
    }
    if (e) return e;
  }
  if (passes & 2) {
    const int total = B * D * h * w;
    soft_argmin_gather_kernel<<<(total + kGatherThreads - 1) / kGatherThreads,
                                kGatherThreads, 0, st>>>(
        static_cast<const float*>(ew),
        static_cast<const float*>(fold) + (size_t)w * kWin,
        static_cast<float*>(dx), h, w, Ho, total);
    return (int)cudaGetLastError();
  }
  return 0;
}
