// K5a and K5b: the 2d periodization pyramid of wavedec2/waverec2.
//
// Replaces:
//   K5a  ptwt_tpu/ops/_pallas.py:_make_wavedec2d_kernel (with the quadrant
//        layout _fused_wavedec2d_impl slices the bands out of);
//   K5b  ptwt_tpu/ops/_pallas.py:_make_waverec2d_kernel (with the concat
//        cascade _fused_waverec2d_impl packs the bands with).
// Each is the other's VJP (the custom VJPs _wavedec2d_with_vjp and
// _waverec2d_with_vjp): K5a's VJP is K5b with the dec taps, K5b's K5a with
// the rec taps, over the same runs.
//
// Math.  One analysis level on an exactly halving chain: with L taps and
// pad = L / 2 - 1, lo_h[i][c] = sum_k lo[k] x[(2i + k - pad) mod h][c] (hi_h
// with hi) along H, then ll[i][j] = sum_k lo[k] lo_h[i][(2j + k - pad) mod
// w], hl with hi on lo_h, lh and hh the same on hi_h (lh = hi along H, as
// SUBBAND_ORDERS names it).  One synthesis step is the transpose with the
// rec taps: lo_w[t][j] = sum over taps k with f = t + pad, f - k even, of
// lo[k] ll[(f - k) / 2][j] + hi[k] lh[(f - k) / 2][j] (hi_w from hl, hh),
// then out[t][u] = the same along W on (lo_w, hi_w); periodization needs no
// crop.  Every level is periodic in its own size, so a value of a tile's
// cone read modulo the band is exact and no edge pass is needed.
//
// Bound on the H100: bytes.  A run of D levels reads its input once and
// writes each band once (about 2x the input's bytes); an output costs L
// multiply-adds per pass, far below the card's operations per byte.  What
// held the first design at 7-10x that bound: per-level arrays and band
// pointers indexed at run time (local memory), one integer division and two
// modulos per staged element, one load in flight per thread, stride-2
// shared reads with one output per thread, and a branch on the wrap inside
// every tap loop.  Here:
//
// * Every kernel is an instance of its run's depth D (1 for tiles, 1-8
//   for a whole image), and every level loop is unrolled over it: the cone
//   bounds, strides and band pointers of each level are registers and
//   static indices (ptxas: 0-byte stack frames).
// * Staging issues cp.async copies, all of a thread's in flight at once: a
//   warp per row, 16-byte copies where the row segment lies inside the
//   image and the rows are 16-byte aligned, element copies elsewhere.  The
//   row is taken modulo once per staged row, a column only where the
//   window crosses the image's edge.  The segment lands at its offset
//   modulo 16 bytes, which the passes add to their column.
// * Each pass is a sliding window over one line (a column for the H pass,
//   a row for the W pass) that gives each thread four outputs (analysis:
//   four outputs of both filters; synthesis: four output pairs 2s, 2s + 1
//   of one band pair) from one ring of registers: per tap pair, one or two
//   shared reads and four taps (from the kernel-parameter bank, the same
//   for the whole warp) feed sixteen multiply-adds.  The H pass runs the
//   lanes along the row (unit stride); the W pass runs them down the
//   column, over buffers with an odd row stride, so the stride-2 reads of
//   a row fall in 32 different banks with no parity split; the staged
//   segment can then keep 16-byte copies.  A whole-image run reads every
//   line modulo its length, one compare per read, with no division.
// * Analysis (K5a): a block owns a th x tw tile of the run's deepest band
//   and stages its level-0 cone (2 c_l + L - 2 positions per axis for c_l
//   at level l, starting at 2 s_l - pad).  Level l: the H pass into lo_h /
//   hi_h, the W pass into ll (the next level's cone) and lh / hl / hh in
//   shared memory, then the positions the tile owns (th << (D - l) per
//   axis, clamped to the band) copied out with the lanes along each band
//   row: every band position has one owner and one coalesced write.
// * Synthesis (K5b): a block owns a th x tw tile of the run's finest output.
//   Step l reads its bands over [c_l, e_l] per axis, c_l = floor((c_{l-1} +
//   pad - (L - 1)) / 2), e_l = floor((e_{l-1} + pad) / 2).  Every band of
//   every step is staged at once, one cp.async group (no serial loads, no
//   barrier per band).  The last step's outputs go through shared memory
//   and out with the lanes along each row.
// * The grid: one block per tile, or for whole images (plan.bufs == 2) a
//   persistent grid whose blocks stage their next image while the current
//   one runs.
// * Whole image: where an image fits a block, one block holds it (no halo),
//   reads it modulo inside shared memory and runs up to PYR2D_MAX_DEPTH
//   levels, on a persistent grid; else a run is one level of tiles.
//
// The plan (ops/_pallas.py) picks each run's depth and tile; the
// shared-memory layouts below are computed alike there and here, and each
// launch checks that its buffers hold them.
#include <cstring>

#include "common.cuh"

#define PYR2D_MAX_DEPTH 8
#define PYR2D_MAX_TILED_DEPTH 1
#define PYR2D_SMEM_LIMIT 232448
// Threads of a block: 256 for tiles; a whole image's block is alone on its
// SM and takes 1024 threads up to depth 4 in float32 (64 registers a
// thread), 512 deeper or in float64, 256 in float64 past depth 4.  Blocks
// an SM should hold by registers: four tiles in float32, two in float64.
// Every instance then needs no stack (ptxas -v).
#define PYR2D_THREADS(T, Whole, D) \
  ((Whole) ? (sizeof(T) == 8 ? ((D) > 4 ? 256 : 512) : ((D) > 4 ? 512 : 1024)) : 256)
#define PYR2D_MIN_BLOCKS(T, Whole) ((Whole) ? 1 : (sizeof(T) == 8 ? 2 : 4))
// rows and columns past a synthesis tile's band range that its last
// window group reads (outputs it discards)
#define PYR2D_SLACK 4

// The plan arrives as an int array from the Python wrappers, in this order.
struct Pyramid2dPlan {
  int depth;             // levels of this run
  int h, w;              // the run's finest image: analysis input, synthesis output
  int th, tw;            // a block's tile: level-depth positions (analysis) or outputs (synthesis)
  int tiles_h, tiles_w;  // tiles per image along H and W
  int whole;             // 1: one block holds the whole image, reads modulo in shared memory
  int pad;               // L / 2 - 1
  int buf_a, buf_b;      // shared-memory regions in elements (see *_need below)
  int bufs;              // copies of region A: 2 stages the next tile during the current one
};

static_assert(sizeof(Pyramid2dPlan) == 12 * sizeof(int), "Pyramid2dPlan is the wrappers' int array");

template <typename T>
struct Pyramid2dOut {
  T* ll;                             // ll_D, [batch, h >> D, w >> D]
  T* det[3 * PYR2D_MAX_DEPTH];       // det[3 (l - 1) + o]: lh, hl, hh of level l
};

template <typename T>
struct Pyramid2dIn {
  const T* ll;
  const T* det[3 * PYR2D_MAX_DEPTH];
};

__host__ __device__ __forceinline__ int floor_half2(int v) {
  return v >= 0 ? v >> 1 : -((1 - v) >> 1);
}

__host__ __device__ __forceinline__ int mod_pos(int p, int m) {
  const int q = p % m;
  return q < 0 ? q + m : q;
}

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// geometry, shared by the kernels and the launch checks
// ---------------------------------------------------------------------------

// Cone length along one axis at every level of an analysis run: the tile
// at level d, 2 c + Le - 2 below it (Le = L rounded up to even: an odd
// bank's missing tap is a zero that reads inside the cone); a whole image
// is its bands.
__host__ __device__ __forceinline__ int cone_at(int t, int size, int le, int whole, int d, int l) {
  return whole ? size >> l : (t << (d - l)) + (le - 2) * ((1 << (d - l)) - 1);
}

// Start of that cone for a tile starting at t0 at level d: s_{l-1} = 2 s_l
// - pad.
__host__ __device__ __forceinline__ int cone_start(int t0, int pad, int whole, int d, int l) {
  return whole ? 0 : (t0 << (d - l)) - pad * ((1 << (d - l)) - 1);
}

// Positions of a level-(l-1) line that the four-output windows of c_out
// outputs read (a whole image's lines wrap instead).
__host__ __device__ __forceinline__ int reach(int c_out, int c_in, int le, int whole) {
  return whole ? c_in : 8 * ((c_out + 3) >> 2) + le - 2;
}

// Elements of an analysis launch's two regions: A holds the staged cone
// (rows the H pass reads x a stride with room for the 16-byte offset),
// then each level's ll (with the rows the next H pass reads) and lh, hl,
// hh; B holds each level's lo_h and hi_h (odd stride, the columns the W
// pass reads).
__host__ __device__ __forceinline__ void analysis_need(int d, int h, int w, int th, int tw,
                                                       int whole, int len, int item,
                                                       int64_t* a, int64_t* b) {
  const int le = len + (len & 1);
  const int v = 16 / item;
  int64_t na = int64_t(reach(cone_at(th, h, le, whole, d, 1), cone_at(th, h, le, whole, d, 0), le, whole)) *
               round_up(cone_at(tw, w, le, whole, d, 0) + v - 1, v);
  int64_t nb = 0;
  for (int l = 1; l <= d; ++l) {
    const int ch = cone_at(th, h, le, whole, d, l), cw = cone_at(tw, w, le, whole, d, l);
    const int rows_ll = l < d ? reach(cone_at(th, h, le, whole, d, l + 1), ch, le, whole) : ch;
    const int64_t sb = round_up(cw, 4) + 1;
    const int64_t s1 = reach(cw, cone_at(tw, w, le, whole, d, l - 1), le, whole) | 1;
    if ((rows_ll + 3 * int64_t(ch)) * sb > na) na = (rows_ll + 3 * int64_t(ch)) * sb;
    if (2 * ch * s1 > nb) nb = 2 * ch * s1;
  }
  *a = round_up(static_cast<int>(na), 4);
  *b = nb;
}

// Bound on a synthesis tile's band range at level l (tile t at level 0),
// and the rows/columns its buffers hold; a whole image's bands.
__host__ __device__ __forceinline__ int span_at(int t, int size, int len, int whole, int l) {
  if (whole) return size >> l;
  int n = t;
  for (int k = 1; k <= l; ++k) n = (n + len - 1) / 2 + 1;
  return n;
}

__host__ __device__ __forceinline__ int alloc_at(int t, int size, int len, int whole, int l) {
  return span_at(t, size, len, whole, l) + (whole ? 0 : PYR2D_SLACK);
}

// Elements of one staged band of level l (rows x a stride with room for the
// 16-byte offset).
__host__ __device__ __forceinline__ int band_elems(int th, int tw, int h, int w, int len,
                                                   int whole, int l, int v) {
  return alloc_at(th, h, len, whole, l) * round_up(alloc_at(tw, w, len, whole, l) + v - 1, v);
}

// The band range [c, c + n) that a synthesis tile of t outputs from
// `first` reads at level l: c_l = floor((c_{l-1} + pad - (L - 1)) / 2),
// e_l = floor((e_{l-1} + pad) / 2); a whole image's band.
template <bool Whole>
__device__ __forceinline__ void band_range(int first, int t, int size, int len, int pad, int l,
                                           int& c, int& n) {
  if (Whole) {
    c = 0;
    n = size >> l;
    return;
  }
  int e = first + t - 1;
  c = first;
  for (int k = 1; k <= l; ++k) {
    c = floor_half2(c + pad - (len - 1));
    e = floor_half2(e + pad);
  }
  n = e - c + 1;
}

// Offset of level l's staged details: ll_D first, then lh, hl, hh of level
// D, D - 1, ..., l + 1.
__host__ __device__ __forceinline__ int details_at(int th, int tw, int h, int w, int len, int whole,
                                                  int d, int l, int v) {
  int at = band_elems(th, tw, h, w, len, whole, d, v);
  for (int m = d; m > l; --m) at += 3 * band_elems(th, tw, h, w, len, whole, m, v);
  return at;
}

// Elements of a synthesis launch's two regions: A holds every staged band
// (ll_D, then lh, hl, hh of level D, D - 1, ..., 1), reused for the last
// step's outputs; B holds the intermediate ll (D > 1) and lo_w, hi_w.
__host__ __device__ __forceinline__ void synthesis_need(int d, int h, int w, int th, int tw,
                                                        int whole, int len, int item,
                                                        int64_t* a, int64_t* b) {
  const int v = 16 / item;
  int64_t bands = band_elems(th, tw, h, w, len, whole, d, v);
  for (int l = 1; l <= d; ++l) bands += 3 * int64_t(band_elems(th, tw, h, w, len, whole, l, v));
  const int64_t out = int64_t(span_at(th, h, len, whole, 0)) * (span_at(tw, w, len, whole, 0) | 1);
  *a = round_up(static_cast<int>(bands > out ? bands : out), 4);
  int64_t low = 0;
  for (int l = 1; l <= d; ++l) {
    const int64_t need = 2 * int64_t(span_at(th, h, len, whole, l - 1)) * (alloc_at(tw, w, len, whole, l) | 1);
    if (need > low) low = need;
  }
  const int64_t ll = d > 1 ? int64_t(alloc_at(th, h, len, whole, 1)) * (alloc_at(tw, w, len, whole, 1) | 1) : 0;
  *b = ll + low;
}

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(addr), "l"(src),
               "n"(static_cast<int>(sizeof(T))));
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src));
}

__device__ __forceinline__ void commit_async() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The offset, in elements, at which a segment starting at column c0 lands
// in its staged row: c0 modulo 16 bytes.
template <typename T>
__device__ __forceinline__ int stage_offset(int c0) {
  return mod_pos(c0, 16 / static_cast<int>(sizeof(T)));
}

// Issue dst[r][o + c] = src[(r0 + r) mod mh][(c0 + c) mod mw] for an nr x nc
// block, o = stage_offset(c0), one warp per row.  A segment inside the row
// whose rows are 16-byte aligned goes as 16-byte copies (from the aligned
// column c0 - o); otherwise each element is its own copy, and a column is
// taken modulo only where it lies outside the image.
template <typename T>
__device__ __forceinline__ void stage_block(T* dst, int stride, const T* __restrict__ src,
                                            int r0, int nr, int c0, int nc, int mh, int mw) {
  constexpr int V = 16 / sizeof(T);
  const int o = stage_offset<T>(c0);
  const bool vec = c0 >= 0 && c0 + nc <= mw && mw % V == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int a0 = c0 - o;
  const int chunks = (o + nc + V - 1) / V;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nr; r += blockDim.x >> 5) {
    int gr = r0 + r;
    if (gr < 0 || gr >= mh) gr = mod_pos(gr, mh);
    const T* row = src + static_cast<int64_t>(gr) * mw;
    T* d = dst + r * stride;
    if (vec) {
      for (int k = lane; k < chunks; k += 32) copy_async16(d + k * V, row + a0 + k * V);
    } else {
      for (int j = lane; j < nc; j += 32) {
        int gc = c0 + j;
        if (gc < 0 || gc >= mw) gc = mod_pos(gc, mw);
        copy_async(d + o + j, row + gc);
      }
    }
  }
}

// Steps a flat item index through [outer, inner] in strides of the block,
// with no division past the first.
struct Walk {
  int outer, inner, d_outer, d_inner, n;
  __device__ __forceinline__ Walk(int start, int step, int n_) : n(n_) {
    outer = start / n;
    inner = start - outer * n;
    d_outer = step / n;
    d_inner = step - d_outer * n;
  }
  __device__ __forceinline__ void next() {
    outer += d_outer;
    inner += d_inner;
    if (inner >= n) {
      inner -= n;
      ++outer;
    }
  }
};

// ---------------------------------------------------------------------------
// the sliding windows
// ---------------------------------------------------------------------------

// The next value of a line read in order: *at, or src[p * stride] with p
// modulo n where Wrap.
template <typename T, bool Wrap>
__device__ __forceinline__ T take(const T* src, const T*& at, int& p, int stride, int n) {
  if (Wrap) {
    const T x = src[p * stride];
    if (++p == n) p = 0;
    return x;
  }
  const T x = *at;
  at += stride;
  return x;
}

// Tap pair h of analysis_line, the s-th of its group of four: reads two
// positions into the ring and feeds them to the four outputs.
template <typename T, bool Wrap>
__device__ __forceinline__ void analysis_step(const T* src, const T*& at, int& p, int stride, int n,
                                              const T* tl, const T* th, int h, int s, T (&v)[8],
                                              T (&lo)[4], T (&hi)[4]) {
  v[(2 * s + 6) & 7] = take<T, Wrap>(src, at, p, stride, n);
  v[(2 * s + 7) & 7] = take<T, Wrap>(src, at, p, stride, n);
  const T a0 = tl[2 * h], a1 = tl[2 * h + 1];
  const T b0 = th[2 * h], b1 = th[2 * h + 1];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const T x0 = v[(2 * s + 2 * r) & 7], x1 = v[(2 * s + 2 * r + 1) & 7];
    lo[r] += a0 * x0 + a1 * x1;
    hi[r] += b0 * x0 + b1 * x1;
  }
}

// Four analysis outputs of both filters on one line: lo[r] += sum over
// k < 2 half of tl[k] line[p + 2r + k] (hi[r] with th), where line[q] is
// src[q * stride] and the position p advances by one per read (modulo n
// where Wrap).  A ring of eight values: per tap pair two reads feed
// sixteen multiply-adds.
template <typename T, bool Wrap>
__device__ __forceinline__ void analysis_line(const T* src, int stride, int p, int n,
                                              const T* tl, const T* th, int half, T (&lo)[4],
                                              T (&hi)[4]) {
  T v[8];
  const T* at = src + (Wrap ? 0 : p * stride);
#pragma unroll
  for (int q = 0; q < 6; ++q) v[q] = take<T, Wrap>(src, at, p, stride, n);
  // whole groups of four tap pairs with no branch (their reads can issue
  // ahead of the multiply-adds), then the rest one pair at a time
  int h0 = 0;
  for (; h0 + 4 <= half; h0 += 4) {
#pragma unroll
    for (int s = 0; s < 4; ++s) analysis_step<T, Wrap>(src, at, p, stride, n, tl, th, h0 + s, s, v, lo, hi);
  }
#pragma unroll
  for (int s = 0; s < 3; ++s)
    if (h0 + s < half) analysis_step<T, Wrap>(src, at, p, stride, n, tl, th, h0 + s, s, v, lo, hi);
}

// Tap pair h of synthesis_line, the s-th of its group of four.
template <typename T, bool Wrap>
__device__ __forceinline__ void synthesis_step(const T* a, int sa, const T* b, int sb, int& p, int n,
                                               const T* ta, const T* tb, int h, int s, T (&ra)[4],
                                               T (&rb)[4], T (&ev)[4], T (&od)[4]) {
  ra[(4 - s) & 3] = a[p * sa];
  rb[(4 - s) & 3] = b[p * sb];
  if (--p < 0 && Wrap) p = n - 1;
  const T a0 = ta[2 * h], a1 = ta[2 * h + 1];
  const T b0 = tb[2 * h], b1 = tb[2 * h + 1];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const T x = ra[(r - s + 4) & 3], y = rb[(r - s + 4) & 3];
    ev[r] += a0 * x + b0 * y;
    od[r] += a1 * x + b1 * y;
  }
}

// Four synthesis output pairs from one band pair on one line: ev[r] +=
// sum over h < half of ta[2h] a[q + r - h] + tb[2h] b[q + r - h], od[r] the
// same with the odd taps 2h + 1, where a[q] is a[q * sa] (b with sb) and q
// is taken modulo n where Wrap.  A ring of four values per band: per tap
// pair two reads feed sixteen multiply-adds.
template <typename T, bool Wrap>
__device__ __forceinline__ void synthesis_line(const T* a, int sa, const T* b, int sb, int q,
                                               int n, const T* ta, const T* tb, int half,
                                               T (&ev)[4], T (&od)[4]) {
  T ra[4], rb[4];
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    int p = q + r;
    if (Wrap)
      while (p >= n) p -= n;
    ra[r] = a[p * sa];
    rb[r] = b[p * sb];
  }
  int p = q;
  int h0 = 0;
  for (; h0 + 4 <= half; h0 += 4) {
#pragma unroll
    for (int s = 0; s < 4; ++s) synthesis_step<T, Wrap>(a, sa, b, sb, p, n, ta, tb, h0 + s, s, ra, rb, ev, od);
  }
#pragma unroll
  for (int s = 0; s < 3; ++s)
    if (h0 + s < half) synthesis_step<T, Wrap>(a, sa, b, sb, p, n, ta, tb, h0 + s, s, ra, rb, ev, od);
}

// ---------------------------------------------------------------------------
// K5a: the analysis pyramid
// ---------------------------------------------------------------------------

// The tile of block index `blk` (image, then tile rows, then tile
// columns), and its cone at each level: rows [SH(l), SH(l) + CH(l)),
// columns [SW(l), SW(l) + CW(l)).
#define PYR2D_TILE                                        \
  const int tiles = plan.tiles_h * plan.tiles_w;          \
  const int img = blk / tiles;                            \
  const int ty = (blk - img * tiles) / plan.tiles_w;      \
  const int tx = blk - img * tiles - ty * plan.tiles_w;   \
  const int le = len + (len & 1);
#define CH(l) cone_at(plan.th, plan.h, le, Whole, D, l)
#define CW(l) cone_at(plan.tw, plan.w, le, Whole, D, l)
#define SH(l) cone_start(ty * plan.th, plan.pad, Whole, D, l)
#define SW(l) cone_start(tx * plan.tw, plan.pad, Whole, D, l)

// Issue the copies of tile `blk`'s level-0 cone into A.
template <typename T, int D, bool Whole>
__device__ __forceinline__ void analysis_stage(T* A, const T* __restrict__ x, int len,
                                               const Pyramid2dPlan& plan, int blk) {
  constexpr int V = 16 / sizeof(T);
  PYR2D_TILE
  stage_block<T>(A, round_up(CW(0) + V - 1, V), x + static_cast<int64_t>(img) * plan.h * plan.w,
                 SH(0), CH(0), SW(0), CW(0), plan.h, plan.w);
}

// Every level of tile `blk` from its staged cone in A (the passes' lo_h /
// hi_h in B), and the positions it owns written out.
template <typename T, int D, bool Whole>
__device__ __forceinline__ void analysis_levels(T* A, T* B, const Pyramid2dOut<T>& out,
                                                const T* tl, const T* tg, int len,
                                                const Pyramid2dPlan& plan, int blk) {
  constexpr int V = 16 / sizeof(T);
  PYR2D_TILE
  const int half = le >> 1;
  const int s0 = round_up(CW(0) + V - 1, V);
  const int o0 = stage_offset<T>(SW(0));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int l = 1; l <= D; ++l) {
    const int bh = plan.h >> (l - 1), bw = plan.w >> (l - 1);  // level l - 1
    const int mh = bh >> 1, mw = bw >> 1;                      // level l
    // the level below: the staged cone, or ll of level l - 1 in A
    const int s_in = l == 1 ? s0 : round_up(CW(l - 1), 4) + 1;
    const int o_in = l == 1 ? o0 : 0;
    const int s1 = reach(CW(l), CW(l - 1), le, Whole) | 1;
    T* const loh = B;
    T* const hih = B + CH(l) * s1;
    // H pass: four output rows of one column per item, lanes along the row
    {
      const int groups = (CH(l) + 3) >> 2;
      const int cols = CW(l - 1);
      for (Walk it(threadIdx.x, blockDim.x, cols); it.outer < groups; it.next()) {
        const int g = it.outer, c = it.inner;
        T lo[4] = {T(0), T(0), T(0), T(0)}, hi[4] = {T(0), T(0), T(0), T(0)};
        const int p = Whole ? mod_pos(8 * g - plan.pad, bh) : 8 * g;
        analysis_line<T, Whole>(A + o_in + c, s_in, p, bh, tl, tg, half, lo, hi);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (4 * g + r < CH(l)) {
            loh[(4 * g + r) * s1 + c] = lo[r];
            hih[(4 * g + r) * s1 + c] = hi[r];
          }
        }
      }
    }
    __syncthreads();
    // W pass: four outputs of one row per item, lanes down the column;
    // lo_h -> ll, hl and hi_h -> lh, hh, into A
    const int sb = round_up(CW(l), 4) + 1;
    const int rows_ll = l < D ? reach(CH(l < D ? l + 1 : D), CH(l), le, Whole) : CH(l);
    T* const ll_buf = A;
    T* const det_buf = A + rows_ll * sb;  // lh, hl, hh: CH(l) x sb each
    {
      const int quads = (CW(l) + 3) >> 2;
      for (Walk it(threadIdx.x, blockDim.x, CH(l)); it.outer < 2 * quads; it.next()) {
        const int hf = it.outer >= quads;
        const int g = it.outer - hf * quads, r = it.inner;
        T lo[4] = {T(0), T(0), T(0), T(0)}, hi[4] = {T(0), T(0), T(0), T(0)};
        const int p = Whole ? mod_pos(8 * g - plan.pad, bw) : 8 * g;
        analysis_line<T, Whole>((hf ? hih : loh) + r * s1, 1, p, bw, tl, tg, half, lo, hi);
        T* const dlo = (hf ? det_buf : ll_buf) + r * sb + 4 * g;
        T* const dhi = det_buf + (hf ? 2 : 1) * CH(l) * sb + r * sb + 4 * g;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dlo[q] = lo[q];
          dhi[q] = hi[q];
        }
      }
    }
    __syncthreads();
    // the positions this tile owns, one warp per band row; the next H pass
    // reads only ll, and the next W pass starts after its barrier
    {
      const int own_h = plan.th << (D - l), own_w = plan.tw << (D - l);
      const int fh = Whole ? 0 : ty * own_h, fw = Whole ? 0 : tx * own_w;
      const int nh = min(fh + own_h, mh) - fh, nw = min(fw + own_w, mw) - fw;
      const int rh = fh - SH(l), rw = fw - SW(l);
      const int nbands = l == D ? 4 : 3;
      const int64_t band = static_cast<int64_t>(img) * mh * mw;
      T* const d0 = out.det[3 * (l - 1)] + band;
      T* const d1 = out.det[3 * (l - 1) + 1] + band;
      T* const d2 = out.det[3 * (l - 1) + 2] + band;
      T* const d3 = out.ll + band;
      for (int rr = warp; rr < nbands * nh; rr += blockDim.x >> 5) {
        const int bi = rr / nh;
        const int i = rr - bi * nh;
        const T* src = (bi < 3 ? det_buf + bi * CH(l) * sb : ll_buf) + (rh + i) * sb + rw;
        T* dst = (bi == 0 ? d0 : bi == 1 ? d1 : bi == 2 ? d2 : d3) + static_cast<int64_t>(fh + i) * mw + fw;
        for (int j = lane; j < nw; j += 32) dst[j] = src[j];
      }
    }
  }
}

#undef CH
#undef CW
#undef SH
#undef SW
#undef PYR2D_TILE

// One block per tile; whole images on a grid whose blocks walk the
// images blockIdx.x, + gridDim.x, ...: one block per image (plan.bufs ==
// 1), or a persistent grid with two cone buffers (plan.bufs == 2), the
// next image's cone in flight while the current one runs its levels.  (A
// tile's block compiles no loop: with one, ptxas scheduled the tiled K5b
// instance slower on the card.)
template <typename T, int D, bool Whole>
__global__ void __launch_bounds__(PYR2D_THREADS(T, Whole, D), PYR2D_MIN_BLOCKS(T, Whole))
    pyramid2d_analysis_kernel(const T* __restrict__ x, const __grid_constant__ Pyramid2dOut<T> out,
                              const __grid_constant__ Taps<T> taps, int len,
                              const Pyramid2dPlan plan, int total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const A0 = reinterpret_cast<T*>(smem_raw);
  T* const A1 = A0 + (plan.bufs - 1) * plan.buf_a;
  T* const B = A0 + plan.bufs * plan.buf_a;
  if constexpr (!Whole) {  // one block per tile
    analysis_stage<T, D, Whole>(A0, x, len, plan, blockIdx.x);
    commit_async();
    wait_async<0>();
    __syncthreads();
    analysis_levels<T, D, Whole>(A0, B, out, taps.lo, taps.hi, len, plan, blockIdx.x);
    return;
  }
  int64_t blk = blockIdx.x;  // tiles past 2^31 - 1 never start: total < 2^31
  if (blk < total) analysis_stage<T, D, Whole>(A0, x, len, plan, static_cast<int>(blk));
  commit_async();
  for (int k = 0; blk < total; ++k, blk += gridDim.x) {
    T* const cur = (k & 1) ? A1 : A0;
    const int64_t next = blk + gridDim.x;
    if (plan.bufs > 1 && next < total) {
      analysis_stage<T, D, Whole>((k & 1) ? A0 : A1, x, len, plan, static_cast<int>(next));
      commit_async();
      wait_async<1>();
    } else {
      wait_async<0>();
    }
    __syncthreads();
    analysis_levels<T, D, Whole>(cur, B, out, taps.lo, taps.hi, len, plan, static_cast<int>(blk));
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K5b: the synthesis pyramid
// ---------------------------------------------------------------------------

// The tile of block index `blk` (image, then tile rows, then tile
// columns); RANGE declares the band rows or columns [c, c + n) it reads at
// level l (recomputed where used, so no per-level array stays live).
#define PYR2D_TILE                                                      \
  constexpr int V = 16 / sizeof(T);                                     \
  const int tiles = plan.tiles_h * plan.tiles_w;                        \
  const int img = blk / tiles;                                          \
  const int ty = (blk - img * tiles) / plan.tiles_w;                    \
  const int tx = blk - img * tiles - ty * plan.tiles_w;                 \
  const int whole = Whole ? 1 : 0;                                      \
  const int row0 = Whole ? 0 : ty * plan.th, col0 = Whole ? 0 : tx * plan.tw;
#define RANGE(first, t, size, l, c, n) \
  int c, n;                            \
  band_range<Whole>(first, t, size, len, plan.pad, l, c, n);

// Issue the copies of every band tile `blk` reads, every level, into A.
template <typename T, int D, bool Whole>
__device__ __forceinline__ void synthesis_stage(T* A, const Pyramid2dIn<T>& in, int len,
                                                const Pyramid2dPlan& plan, int blk) {
  PYR2D_TILE
#pragma unroll
  for (int l = D; l >= 1; --l) {
    const int mh = plan.h >> l, mw = plan.w >> l;
    const int64_t band = static_cast<int64_t>(img) * mh * mw;
    const int sbd = round_up(alloc_at(plan.tw, plan.w, len, whole, l) + V - 1, V);
    const int bs = band_elems(plan.th, plan.tw, plan.h, plan.w, len, whole, l, V);
    T* const at = A + details_at(plan.th, plan.tw, plan.h, plan.w, len, whole, D, l, V);
    RANGE(row0, plan.th, plan.h, l, ch, nh)
    RANGE(col0, plan.tw, plan.w, l, cw, nw)
    if (l == D) stage_block<T>(A, sbd, in.ll + band, ch, nh, cw, nw, mh, mw);
#pragma unroll
    for (int o = 0; o < 3; ++o)
      stage_block<T>(at + o * bs, sbd, in.det[3 * (l - 1) + o] + band, ch, nh, cw, nw, mh, mw);
  }
}

// Every step of tile `blk` from its staged bands in A (ll between steps
// and lo_w / hi_w in B), and its outputs written out.
template <typename T, int D, bool Whole>
__device__ __forceinline__ void synthesis_steps(T* A, T* B, T* __restrict__ out, const T* tl,
                                                const T* tg, int len, const Pyramid2dPlan& plan,
                                                int blk) {
  PYR2D_TILE
  const int half = (len + 1) >> 1;
  const int ll_elems =
      D > 1 ? alloc_at(plan.th, plan.h, len, whole, 1) * (alloc_at(plan.tw, plan.w, len, whole, 1) | 1) : 0;
  T* const low = B + ll_elems;
#pragma unroll
  for (int l = D; l >= 1; --l) {
    const int mh = plan.h >> l, mw = plan.w >> l;
    RANGE(row0, plan.th, plan.h, l, ch, nh)
    RANGE(col0, plan.tw, plan.w, l, cw, nw)
    RANGE(row0, plan.th, plan.h, l - 1, ch_o, nh_o)
    RANGE(col0, plan.tw, plan.w, l - 1, cw_o, nw_o)
    const int o_l = stage_offset<T>(cw);
    const int aw = alloc_at(plan.tw, plan.w, len, whole, l);
    const int sbd = round_up(aw + V - 1, V);
    const int bs = band_elems(plan.th, plan.tw, plan.h, plan.w, len, whole, l, V);
    // ll of this step: staged (l == D) or from the step before, in B
    const T* const ll = l == D ? A + o_l : B;
    const int s_ll = l == D ? sbd : aw | 1;
    const T* const lh = A + details_at(plan.th, plan.tw, plan.h, plan.w, len, whole, D, l, V) + o_l;
    const T* const hl = lh + bs;
    const T* const hh = hl + bs;
    const int s2 = aw | 1;
    T* const hiw = low + span_at(plan.th, plan.h, len, whole, l - 1) * s2;
    // H pass: four output row pairs of one column per item, lanes along the
    // row; (ll, lh) -> lo_w, (hl, hh) -> hi_w
    {
      const int par = (ch_o + plan.pad) & 1;
      const int q0 = ((ch_o + plan.pad - par) >> 1) - ch;
      const int groups = (((nh_o + par + 1) >> 1) + 3) >> 2;
      for (Walk it(threadIdx.x, blockDim.x, nw); it.outer < 2 * groups; it.next()) {
        const int hf = it.outer >= groups;
        const int g = it.outer - hf * groups, j = it.inner;
        T ev[4] = {T(0), T(0), T(0), T(0)}, od[4] = {T(0), T(0), T(0), T(0)};
        const int q = Whole ? mod_pos(q0 + 4 * g, mh) : q0 + 4 * g;
        synthesis_line<T, Whole>((hf ? hl : ll) + j, hf ? sbd : s_ll, (hf ? hh : lh) + j, sbd,
                                 q, mh, tl, tg, half, ev, od);
        T* const dst = (hf ? hiw : low) + j;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = 2 * (4 * g + r) - par;
          if (t >= 0 && t < nh_o) dst[t * s2] = ev[r];
          if (t + 1 < nh_o) dst[(t + 1) * s2] = od[r];
        }
      }
    }
    __syncthreads();
    // W pass: four output pairs of one row per item, lanes down the column;
    // into ll of level l - 1 (B), or at the last step the tile's outputs (A)
    {
      const int par = (cw_o + plan.pad) & 1;
      const int q0 = ((cw_o + plan.pad - par) >> 1) - cw;
      const int groups = (((nw_o + par + 1) >> 1) + 3) >> 2;
      T* const dst_buf = l > 1 ? B : A;
      const int sd = l > 1 ? alloc_at(plan.tw, plan.w, len, whole, l - 1) | 1 : span_at(plan.tw, plan.w, len, whole, 0) | 1;
      for (Walk it(threadIdx.x, blockDim.x, nh_o); it.outer < groups; it.next()) {
        const int g = it.outer, t = it.inner;
        T ev[4] = {T(0), T(0), T(0), T(0)}, od[4] = {T(0), T(0), T(0), T(0)};
        const int q = Whole ? mod_pos(q0 + 4 * g, mw) : q0 + 4 * g;
        synthesis_line<T, Whole>(low + t * s2, 1, hiw + t * s2, 1, q, mw, tl, tg, half, ev, od);
        T* const dst = dst_buf + t * sd;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int u = 2 * (4 * g + r) - par;
          if (u >= 0 && u < nw_o) dst[u] = ev[r];
          if (u + 1 < nw_o) dst[u + 1] = od[r];
        }
      }
    }
    __syncthreads();
  }
  // the tile's outputs, one warp per row
  const int sd = span_at(plan.tw, plan.w, len, whole, 0) | 1;
  const int rows = min(plan.th, plan.h - row0), cols = min(plan.tw, plan.w - col0);
  T* const base = out + static_cast<int64_t>(img) * plan.h * plan.w + static_cast<int64_t>(row0) * plan.w + col0;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    T* const dst = base + static_cast<int64_t>(r) * plan.w;
    for (int j = lane; j < cols; j += 32) dst[j] = A[r * sd + j];
  }
}

#undef RANGE
#undef PYR2D_TILE

// The grid as K5a's: one block per tile; whole images one block each, or
// on a persistent grid with two band buffers (plan.bufs == 2), the next
// image's bands in flight while the current one runs its steps.
template <typename T, int D, bool Whole>
__global__ void __launch_bounds__(PYR2D_THREADS(T, Whole, D), PYR2D_MIN_BLOCKS(T, Whole))
    pyramid2d_synthesis_kernel(const __grid_constant__ Pyramid2dIn<T> in, T* __restrict__ out,
                               const __grid_constant__ Taps<T> taps, int len,
                               const Pyramid2dPlan plan, int total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const A0 = reinterpret_cast<T*>(smem_raw);
  T* const A1 = A0 + (plan.bufs - 1) * plan.buf_a;
  T* const B = A0 + plan.bufs * plan.buf_a;
  if constexpr (!Whole) {  // one block per tile
    synthesis_stage<T, D, Whole>(A0, in, len, plan, blockIdx.x);
    commit_async();
    wait_async<0>();
    __syncthreads();
    synthesis_steps<T, D, Whole>(A0, B, out, taps.lo, taps.hi, len, plan, blockIdx.x);
    return;
  }
  int64_t blk = blockIdx.x;  // tiles past 2^31 - 1 never start: total < 2^31
  if (blk < total) synthesis_stage<T, D, Whole>(A0, in, len, plan, static_cast<int>(blk));
  commit_async();
  for (int k = 0; blk < total; ++k, blk += gridDim.x) {
    T* const cur = (k & 1) ? A1 : A0;
    const int64_t next = blk + gridDim.x;
    if (plan.bufs > 1 && next < total) {
      synthesis_stage<T, D, Whole>((k & 1) ? A0 : A1, in, len, plan, static_cast<int>(next));
      commit_async();
      wait_async<1>();
    } else {
      wait_async<0>();
    }
    __syncthreads();
    synthesis_steps<T, D, Whole>(cur, B, out, taps.lo, taps.hi, len, plan, static_cast<int>(blk));
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

static bool plan_ok(const Pyramid2dPlan& p, int len, long long batch, bool synthesis) {
  if (p.depth < 1 || p.depth > PYR2D_MAX_DEPTH || p.h < 1 || p.w < 1 || p.th < 1 ||
      p.tw < 1 || p.tiles_h < 1 || p.tiles_w < 1 || len < 2 || len > PTWT_MAX_TAPS ||
      batch < 1 || p.pad != len / 2 - 1 || p.whole < 0 || p.whole > 1 || p.bufs < 1 || p.bufs > 2)
    return false;
  if (!p.whole && (p.depth > PYR2D_MAX_TILED_DEPTH || p.bufs != 1)) return false;
  if (p.h % (1 << p.depth) || p.w % (1 << p.depth)) return false;
  // the extent the tiles cover: the deepest band (analysis), the output (synthesis)
  const int eh = synthesis ? p.h : p.h >> p.depth;
  const int ew = synthesis ? p.w : p.w >> p.depth;
  if (int64_t(p.tiles_h) * p.th < eh || int64_t(p.tiles_w) * p.tw < ew) return false;
  if (p.whole && (p.tiles_h != 1 || p.tiles_w != 1 || p.th != eh || p.tw != ew)) return false;
  return int64_t(p.tiles_h) * p.tiles_w * batch < (int64_t(1) << 31);
}

static bool buffers_ok(const Pyramid2dPlan& p, int len, int dtype, int smem_bytes, bool synthesis) {
  const int item = dtype ? 8 : 4;
  int64_t need_a, need_b;
  if (synthesis)
    synthesis_need(p.depth, p.h, p.w, p.th, p.tw, p.whole, len, item, &need_a, &need_b);
  else
    analysis_need(p.depth, p.h, p.w, p.th, p.tw, p.whole, len, item, &need_a, &need_b);
  if (p.buf_a < need_a || p.buf_b < need_b || p.buf_a % 4) return false;
  const int64_t bytes = (int64_t(p.bufs) * p.buf_a + p.buf_b) * item;
  return smem_bytes >= bytes && smem_bytes <= PYR2D_SMEM_LIMIT;
}

static bool details_ok(const void* const* det, int depth) {
  for (int i = 0; i < 3 * depth; ++i)
    if (!det[i]) return false;
  return true;
}

// Raise the kernel's shared-memory limit, and size its grid: one block
// per tile where a block stages one tile at a time (bufs == 1); else a
// persistent grid, as many blocks as the SMs hold at once.
template <typename K>
static int prepare(K kernel, int threads, int smem, int bufs, int64_t total, unsigned* blocks) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (bufs == 1) {
    *blocks = static_cast<unsigned>(total);
    return 0;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident = int64_t(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<unsigned>(total < resident ? total : resident);
  return 0;
}

template <typename T, int D, bool Whole>
static int launch_analysis(const void* x, void* ll, void* const* det, const double* lo,
                           const double* hi, int len, long long batch,
                           const Pyramid2dPlan& plan, int smem, cudaStream_t stream) {
  Pyramid2dOut<T> out;
  out.ll = static_cast<T*>(ll);
  for (int i = 0; i < 3 * PYR2D_MAX_DEPTH; ++i) out.det[i] = static_cast<T*>(det[i]);
  auto kernel = pyramid2d_analysis_kernel<T, D, Whole>;
  const int64_t total = int64_t(plan.tiles_h) * plan.tiles_w * batch;
  unsigned blocks = 0;
  constexpr int threads = PYR2D_THREADS(T, Whole, D);
  if (int err = prepare(kernel, threads, smem, plan.bufs, total, &blocks)) return err;
  kernel<<<blocks, threads, smem, stream>>>(static_cast<const T*>(x), out,
                                                   make_taps<T>(lo, hi, len), len, plan,
                                                   static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool Whole>
static int launch_synthesis(const void* ll, const void* const* det, void* out,
                            const double* lo, const double* hi, int len, long long batch,
                            const Pyramid2dPlan& plan, int smem, cudaStream_t stream) {
  Pyramid2dIn<T> in;
  in.ll = static_cast<const T*>(ll);
  for (int i = 0; i < 3 * PYR2D_MAX_DEPTH; ++i) in.det[i] = static_cast<const T*>(det[i]);
  auto kernel = pyramid2d_synthesis_kernel<T, D, Whole>;
  const int64_t total = int64_t(plan.tiles_h) * plan.tiles_w * batch;
  unsigned blocks = 0;
  constexpr int threads = PYR2D_THREADS(T, Whole, D);
  if (int err = prepare(kernel, threads, smem, plan.bufs, total, &blocks)) return err;
  kernel<<<blocks, threads, smem, stream>>>(in, static_cast<T*>(out),
                                                   make_taps<T>(lo, hi, len), len, plan,
                                                   static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}

// The instance of a run: tiles at depth 1, a whole image at depth 1-8.
template <typename T, bool Whole, bool Synthesis>
static int launch_depth(const void* a, const void* const* det, void* b, const double* lo,
                        const double* hi, int len, long long batch, const Pyramid2dPlan& plan,
                        int smem, cudaStream_t s) {
#define PYR2D_CASE(D)                                                                         \
  case D:                                                                                     \
    return Synthesis ? launch_synthesis<T, D, Whole>(a, det, b, lo, hi, len, batch, plan, smem, s) \
                     : launch_analysis<T, D, Whole>(a, b, const_cast<void* const*>(det), lo, hi, \
                                                    len, batch, plan, smem, s);
  switch (plan.depth) {
    PYR2D_CASE(1)
    default:
      break;
  }
  if constexpr (Whole) {
    switch (plan.depth) {
      PYR2D_CASE(2)
      PYR2D_CASE(3)
      PYR2D_CASE(4)
      PYR2D_CASE(5)
      PYR2D_CASE(6)
      PYR2D_CASE(7)
      PYR2D_CASE(8)
      default:
        break;
    }
  }
#undef PYR2D_CASE
  return PTWT_BAD_ARGUMENT;
}

template <bool Synthesis>
static int launch(int dtype, const void* a, const void* const* det, void* b, const double* lo,
                  const double* hi, int len, long long batch, const Pyramid2dPlan& plan,
                  int smem, cudaStream_t s) {
  if (dtype == 0)
    return plan.whole ? launch_depth<float, true, Synthesis>(a, det, b, lo, hi, len, batch, plan, smem, s)
                      : launch_depth<float, false, Synthesis>(a, det, b, lo, hi, len, batch, plan, smem, s);
  return plan.whole ? launch_depth<double, true, Synthesis>(a, det, b, lo, hi, len, batch, plan, smem, s)
                    : launch_depth<double, false, Synthesis>(a, det, b, lo, hi, len, batch, plan, smem, s);
}

// dtype: 0 = float32, 1 = float64.  `plan` holds the Pyramid2dPlan fields
// in declaration order; `det` holds 3 * PYR2D_MAX_DEPTH band pointers,
// (lh, hl, hh) of levels 1..depth first.  Returns a cudaError_t after the
// launch, or PTWT_BAD_ARGUMENT.
extern "C" int ptwt_pyramid2d_analysis(int dtype, const void* x, void* ll, void* const* det,
                                       const double* lo, const double* hi, int len,
                                       long long batch, const int* plan_ints, int smem_bytes,
                                       void* stream) {
  Pyramid2dPlan plan;
  std::memcpy(&plan, plan_ints, sizeof(plan));
  if (!plan_ok(plan, len, batch, false) || dtype < 0 || dtype > 1 || !x || !ll ||
      !details_ok(det, plan.depth) || !buffers_ok(plan, len, dtype, smem_bytes, false))
    return PTWT_BAD_ARGUMENT;
  return launch<false>(dtype, x, det, ll, lo, hi, len, batch, plan, smem_bytes,
                       static_cast<cudaStream_t>(stream));
}

// The inverse: ll_D and the details (the same order) -> [batch, h, w].
extern "C" int ptwt_pyramid2d_synthesis(int dtype, const void* ll, const void* const* det,
                                        void* out, const double* lo, const double* hi, int len,
                                        long long batch, const int* plan_ints, int smem_bytes,
                                        void* stream) {
  Pyramid2dPlan plan;
  std::memcpy(&plan, plan_ints, sizeof(plan));
  if (!plan_ok(plan, len, batch, true) || dtype < 0 || dtype > 1 || !ll || !out ||
      !details_ok(det, plan.depth) || !buffers_ok(plan, len, dtype, smem_bytes, true))
    return PTWT_BAD_ARGUMENT;
  return launch<true>(dtype, ll, det, out, lo, hi, len, batch, plan, smem_bytes,
                      static_cast<cudaStream_t>(stream));
}
