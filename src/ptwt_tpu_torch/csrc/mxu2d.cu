// K9a and K9b: one circular 2d filter-bank level as banded-window matrix
// products on the tensor cores.
//
// K9a replaces the Pallas kernel ptwt_tpu/ops/_mxu2d.py:_dwt_kernel, K9b
// replaces ptwt_tpu/ops/_mxu2d.py:_idwt_kernel.  They take the arguments
// of a K1 / K2 launch (dwt2.cu) and give the same outputs, every mode
// included, so the autograd Functions of ops/_pallas2d.py drive both pairs
// through one code path.  Each is the other's VJP: K9a's VJP is K9b's fold
// instance, K9b's VJP is K9a's zero-bounded instance.
//
// * K9a: band[i, j] = sum f_a[ka] f_b[kb] X(2i + ka - pad, 2j + kb - pad)
//   for the four subbands, X read modulo the period (circular = 1; past
//   the image the last sample repeats) or zero outside the image (K9b's
//   VJP).  A tile of tm x tn band positions stages its input window, runs
//   the W pass Y[r, c] = sum_kb f[kb] X[r, 2c + kb] as [16 rows x 8 band
//   columns] products over k-steps of 8 input columns (the JAX package's
//   x_ext @ FW), then the H pass band[i, c] = sum_ka f[ka] Y[2i + ka, c] as
//   [16 band columns x 8 band rows] products over k-steps of 8 rows of Y
//   (the transpose of FH @ y).
// * K9b: out[u, v] = sum rec_a[ka] rec_b[kb] B(qa, qb) with
//   qa = (u + off_h - ka) / 2 over the parity-matched taps, B read modulo
//   half the period and folded (each band row also collecting the rows
//   + half, + 2 half, ... < m: K9a's VJP), or zero outside the bands (the
//   cropped periodic synthesis).  A tile of tu x tv outputs stages the
//   band window its outputs read, runs the W pass T_lo = ll SW_lo + hl SW_hi
//   and T_hi = lh SW_lo + hh SW_hi as [16 band rows x 8 output columns]
//   products over k-steps of 8 band columns, then the H pass out = SH_lo
//   T_lo + SH_hi T_hi as [16 output columns x 8 output rows] products over
//   k-steps of 8 band rows.  The crop lives in the index range (off = pad).
//   An output past the image's last row (the clamp of an odd periodization
//   axis) is not taken: K9's gate admits even images only.
//
// Every product takes 8 outputs along its N side from a k-window of 8
// steps that slides 16 inputs (analysis) or 4 band positions (synthesis)
// per 8 outputs, so its B operand, a window of the band matrix (FW, FH,
// SW, SH), depends only on the k-step, the filter and the lane: a block
// tabulates those fragments from the taps once, and the products run over
// the k-steps inside the band only.  The band matrices are never loaded.
// The tile plan (ops/_mxu2d.py: analysis_plan, synthesis_plan) comes in as
// ints, which the C entry points check before a launch.
//
// Precision: mma.sync.m16n8k8 takes TF32 operands (10 mantissa bits).  One
// pass keeps about 3 decimal digits: built with -DPTWT_MXU2D_ONE_PASS it
// is some 1e-3 off the plain version relative to the band's magnitude on
// the headline's level on an H100, 50 times the port's 2e-5 limit
// (PERF.md).  So each operand is split, a = a_big + a_small with a_big = a
// cut to TF32 and a_small = a - a_big, and each product is small*big +
// big*small + big*big (3xTF32) accumulated in float32, which drops the
// small*small term and small's bits past TF32's (about 2^-20 relative).
// The split is an integer and a float operation, where cvt.rna.tf32.f32
// would run at the conversion rate (16 a clock per SM at compute
// capability 9.0, a quarter of the integer rate, by the CUDA programming
// guide's throughput table).
//
// Bound on the H100: bytes.  K9a reads the image once and writes four
// quarter-size bands, K9b the mirror image: the same bytes as K1/K2; the
// band-only products at 3x take a quarter to a third of that time at 495
// TF32 TFLOP/s, and mma.sync runs at a fraction of that peak.  What the
// design does about it:
//
// * A persistent grid, two blocks of 256 threads on each SM, walks the
//   tiles with a ring of staged windows, two or three deep: the windows of
//   the next tiles are in flight (cp.async) while the current tile's
//   products run, and one block's staging and barriers overlap the other
//   block's products.  A window that lies inside the image (or band)
//   stages with no index map, 16 bytes a copy where its rows are 16-byte
//   aligned; one that crosses an edge copies 16 bytes where a 4-column
//   chunk lies inside, else element copies with the modulo or a zero fill.
// * A tile stages and computes only what its live positions need: the
//   last tile row or column of an image (515 = 8 x 64 + 3 band rows at
//   the headline's periodic level 1) costs its 3 live rows, not 64.
// * Fragments come from shared memory by ldmatrix (a 16 x 8 float tile is
//   four 8 x 16-byte matrices) and are split into their TF32 pair once per
//   load.  The first pass writes its output transposed, so the second
//   pass's A fragments are ldmatrix loads too, and its C fragments hold 8
//   consecutive columns of 4 output rows: each store instruction writes
//   four whole 32-byte sectors, straight from the registers.
// * A warp runs one kind of product (small x big, big x small, big x big)
//   over all its accumulators before the next, so dependent mma.sync are
//   2 U apart.
// * K9b's fold runs only in the VJP instance (half < m), and only in the
//   tiles whose window reads a band row or column past half: a second pass
//   over those positions once the stage has landed.
#include <cstring>
#include <mutex>

#include "common.cuh"

#define MXU_THREADS 256
#define MXU_WARPS (MXU_THREADS / 32)
#define MXU_MAX_TAPS 64
#define MXU_MAX_SMEM 232448
// products a warp carries at once: K9a's W and H passes, K9b's W and H
#define ANA_UNITS_W 3
#define ANA_UNITS_H 2
#define SYN_UNITS_W 2
#define SYN_UNITS_H 4

struct __align__(16) FragA {  // a 16x8 A operand, split
  uint32_t big[4], small[4];
};
struct __align__(16) FragB {  // an 8x8 B operand, split
  uint32_t big[2], small[2];
};

// x = big + small: big is x cut to TF32's 10 mantissa bits (exact), small
// the rest (exact in float32), of which the tensor cores take the top 10
// bits.  Two integer and float operations, no conversion instruction.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
#ifdef PTWT_MXU2D_ONE_PASS
  small = 0u;
#else
  small = __float_as_uint(x - __uint_as_float(big));
#endif
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i][f] += a[i] b[f] in 3xTF32 for the live units i < live, one round
// of each product kind over every accumulator before the next.
template <int U, int F>
__device__ __forceinline__ void mma3(float (&acc)[U][F][4], const FragA (&a)[U],
                                     const FragB (&b)[F], int live) {
#ifndef PTWT_MXU2D_ONE_PASS
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int f = 0; f < F; ++f)
      if (i < live) mma_tf32(acc[i][f], a[i].small, b[f].big);
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int f = 0; f < F; ++f)
      if (i < live) mma_tf32(acc[i][f], a[i].big, b[f].small);
#endif
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int f = 0; f < F; ++f)
      if (i < live) mma_tf32(acc[i][f], a[i].big, b[f].big);
}

// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4):
//   A[16x8]: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B[8x8]:  b0 (k = t, n = g), b1 (k = t+4, n = g)
//   C[16x8]: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// ldmatrix.x4 reads four 8 x 16-byte matrices and gives lane (g, t) the 32
// bits at (row g, word t) of each: so an A operand comes from a row-major
// float tile, lane l addressing row l % 16, words 4 (l / 16) .. + 3.
__device__ __forceinline__ void load_a(FragA& f, const float* p) {
  uint32_t r[4];
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
#pragma unroll
  for (int e = 0; e < 4; ++e) split(__uint_as_float(r[e]), f.big[e], f.small[e]);
}

// The lane's row address for load_a at a tile of row stride `stride`.
__device__ __forceinline__ int lane_a(int lane, int stride) {
  return (lane & 15) * stride + 4 * (lane >> 4);
}

__device__ __forceinline__ float tap_at(const float* taps, int len, int k) {
  return k >= 0 && k < len ? taps[k] : 0.f;
}

// A table of B fragments for `steps` k-steps: entry (2 s + f) * 32 + lane
// (f the filter) holds B[k][n] = f[c + step s + k_sign k + n_sign n].
__device__ __forceinline__ void build_table(FragB* tab, int steps, const Taps<float>& taps,
                                            int len, int c, int step, int k_sign, int n_sign) {
  for (int e = threadIdx.x; e < steps * 64; e += MXU_THREADS) {
    const int s = e >> 6, ln = e & 31, gg = ln >> 2, tt = ln & 3;
    const float* f = (e >> 5) & 1 ? taps.hi : taps.lo;
    const int k = c + step * s + k_sign * tt + n_sign * gg;
    FragB fr;
    split(tap_at(f, len, k), fr.big[0], fr.small[0]);
    split(tap_at(f, len, k + 4 * k_sign), fr.big[1], fr.small[1]);
    tab[e] = fr;
  }
}

// The C fragment's element e (0..3): row g + 8 (e >> 1) of M, column
// 2 t + (e & 1) of N.
__device__ __forceinline__ int c_m(int g, int e) { return g + 8 * (e >> 1); }
__device__ __forceinline__ int c_n(int t, int e) { return 2 * t + (e & 1); }

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ void copy4(float* dst, const float* src, bool fill) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src),
               "r"(fill ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_async() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until the oldest of the ring's staged tiles has landed: at most
// stages - 2 of this thread's groups still in flight.
__device__ __forceinline__ void wait_oldest(int stages) {
  if (stages == 3)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void zero4(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
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

// rows x cols floats from rows of `ld` floats at `src` to rows of
// `stride` floats at `dst`: 16 bytes at a time where `vec` (src and ld
// 16-byte aligned, cols a multiple of 4), else one float at a time.
__device__ __forceinline__ void stage_inside(float* dst, int stride, const float* src, int64_t ld,
                                             int rows, int cols, bool vec) {
  if (vec) {
    for (Walk it(threadIdx.x, MXU_THREADS, cols / 4); it.outer < rows; it.next())
      copy16(dst + it.outer * stride + 4 * it.inner, src + it.outer * ld + 4 * it.inner);
  } else {
    for (Walk it(threadIdx.x, MXU_THREADS, cols); it.outer < rows; it.next())
      copy4(dst + it.outer * stride + it.inner, src + it.outer * ld + it.inner, true);
  }
}

// ---------------------------------------------------------------------------
// K9a
// ---------------------------------------------------------------------------

// ops/_mxu2d.py:analysis_plan, in its order.
struct AnaPlan {
  int tm, tn;        // band rows and columns of a tile
  int off;           // the window starts off columns left of 2 j0 - pad
  int kw, kh;        // k-steps per 8 band columns (W), 8 band rows (H)
  int xrows, xcols;  // the largest staged window
  int sx, sy;        // strides: window, W output (transposed)
  int tiles_h, tiles_w;
  int xbuf;          // floats of one ring stage
  int stages;        // depth of the ring, 2 or 3
};
#define ANA_PLAN_INTS 13

// A tile's place and its live extent.
struct AnaTile {
  int64_t b;
  int i0, j0, rows, cols;  // live band rows / columns
  int nbs, ncs;            // 8-row and 16-column blocks of them
  int xr, xc;              // the window they read
};

__device__ __forceinline__ AnaTile ana_tile(const AnaPlan& p, int64_t tile, int m_h, int m_w) {
  AnaTile t;
  const int64_t per_image = int64_t(p.tiles_h) * p.tiles_w;
  t.b = tile / per_image;
  const int rest = static_cast<int>(tile - t.b * per_image);
  const int ty = rest / p.tiles_w;
  t.i0 = ty * p.tm;
  t.j0 = (rest - ty * p.tiles_w) * p.tn;
  t.rows = min(p.tm, m_h - t.i0);
  t.cols = min(p.tn, m_w - t.j0);
  t.nbs = cdiv(t.rows, 8);
  t.ncs = cdiv(t.cols, 16);
  t.xr = cdiv(16 * (t.nbs - 1) + 8 * p.kh, 16) * 16;
  t.xc = 32 * (t.ncs - 1) + 16 + 8 * p.kw;
  return t;
}

// X[r][c] = X(2 i0 - pad + r, 2 j0 - pad - off + c) for r < xr, c < xc.
__device__ __forceinline__ void ana_stage(float* xs, const float* __restrict__ x, const AnaPlan& p,
                                          const AnaTile& t, int h, int w, int per_h, int per_w,
                                          int pad, int circular) {
  const float* img = x + t.b * h * w;
  const int r0 = 2 * t.i0 - pad, c0 = 2 * t.j0 - pad - p.off;
  const bool vec_rows = w % 4 == 0 && aligned16(x);
  if (r0 >= 0 && r0 + t.xr <= h && c0 >= 0 && c0 + t.xc <= w) {
    stage_inside(xs, p.sx, img + static_cast<int64_t>(r0) * w + c0, w, t.xr, t.xc, vec_rows);
    return;
  }
  for (Walk it(threadIdx.x, MXU_THREADS, t.xc / 4); it.outer < t.xr; it.next()) {
    int gr = r0 + it.outer;
    bool row_in = true;
    if (circular) {
      gr = wrap_index(gr, per_h, h);
    } else {
      row_in = gr >= 0 && gr < h;
      gr = row_in ? gr : 0;
    }
    const float* line = img + static_cast<int64_t>(gr) * w;
    float* d = xs + it.outer * p.sx + 4 * it.inner;
    const int gc = c0 + 4 * it.inner;
    if (!row_in) {
      zero4(d);
    } else if (vec_rows && gc >= 0 && gc + 4 <= w) {
      copy16(d, line + gc);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int c = gc + e;
        bool in = true;
        if (circular) {
          c = wrap_index(c, per_w, w);
        } else {
          in = c >= 0 && c < w;
          c = in ? c : 0;
        }
        copy4(d + e, line + c, in);
      }
    }
  }
}

__global__ void __launch_bounds__(MXU_THREADS, 2)
    mxu2d_analysis_kernel(const float* __restrict__ x, float* __restrict__ out,
                          const __grid_constant__ Taps<float> taps, const AnaPlan p, int len,
                          int h, int w, int per_h, int per_w, int m_h, int m_w, int pad,
                          int circular, int64_t total, int64_t plane) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FragB* tab_w = reinterpret_cast<FragB*>(smem_raw);
  FragB* tab_h = tab_w + p.kw * 64;
  float* ring = reinterpret_cast<float*>(tab_h + p.kh * 64);
  float* ys = ring + p.stages * p.xbuf;  // [2 (W lo, hi)][tn][sy]: Y transposed
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // FW: B[k][n] = f[8s + k - 2n - off] (window columns 16 j + 8 s + k of
  // band column 8 j + n); FH: B[k][n] = f[8s + k - 2n] (rows 16 b + 8 s + k
  // of Y for band row 8 b + n)
  build_table(tab_w, p.kw, taps, len, -p.off, 8, 1, -2);
  build_table(tab_h, p.kh, taps, len, 0, 8, 1, -2);

  int64_t tile = blockIdx.x;
  for (int j = 0; j < p.stages - 1; ++j) {
    const int64_t tj = tile + int64_t(j) * gridDim.x;
    if (tj < total)
      ana_stage(ring + j * p.xbuf, x, p, ana_tile(p, tj, m_h, m_w), h, w, per_h, per_w, pad,
                circular);
    commit_async();
  }
  for (int k = 0; tile < total; ++k, tile += gridDim.x) {
    __syncthreads();  // the last tile's passes are done with its stage and Y
    const int64_t ahead = tile + int64_t(p.stages - 1) * gridDim.x;
    if (ahead < total)
      ana_stage(ring + ((k + p.stages - 1) % p.stages) * p.xbuf, x, p,
                ana_tile(p, ahead, m_h, m_w), h, w, per_h, per_w, pad, circular);
    commit_async();
    wait_oldest(p.stages);
    __syncthreads();
    const float* cur = ring + (k % p.stages) * p.xbuf;
    const AnaTile tl = ana_tile(p, tile, m_h, m_w);

    // W pass: units (16 window rows, 8 band columns), both filters, into
    // Y^T[f][c][r]
    const int nts = 2 * tl.ncs;
    const int nw = (tl.xr / 16) * nts;
    for (int u0 = warp; u0 < nw; u0 += MXU_WARPS * ANA_UNITS_W) {
      const int live = cdiv(nw - u0, MXU_WARPS);
      float acc[ANA_UNITS_W][2][4] = {};
      int at[ANA_UNITS_W];
#pragma unroll
      for (int i = 0; i < ANA_UNITS_W; ++i) {
        const int u = u0 + MXU_WARPS * i, mt = u / nts, j = u - mt * nts;
        at[i] = 16 * mt * p.sx + 16 * j + lane_a(lane, p.sx);
      }
      for (int s = 0; s < p.kw; ++s) {
        const FragB b[2] = {tab_w[(2 * s) * 32 + lane], tab_w[(2 * s + 1) * 32 + lane]};
        FragA a[ANA_UNITS_W];
#pragma unroll
        for (int i = 0; i < ANA_UNITS_W; ++i)
          if (i < live) load_a(a[i], cur + at[i] + 8 * s);
        mma3(acc, a, b, live);
      }
#pragma unroll
      for (int i = 0; i < ANA_UNITS_W; ++i) {
        const int u = u0 + MXU_WARPS * i, mt = u / nts, j = u - mt * nts;
        if (i < live) {
#pragma unroll
          for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              ys[(f * p.tn + 8 * j + c_n(t, e)) * p.sy + 16 * mt + c_m(g, e)] = acc[i][f][e];
        }
      }
    }
    __syncthreads();

    // H pass: units (16 band columns, 8 band rows, W filter), both H
    // filters; (ll, lh, hl, hh) = (H, W) filters (lo, lo), (hi, lo), (lo,
    // hi), (hi, hi): band 2 fw + fh
    const int nh = tl.ncs * tl.nbs * 2;
    float* const dst = out + (tl.b * m_h + tl.i0) * m_w + tl.j0;
    for (int u0 = warp; u0 < nh; u0 += MXU_WARPS * ANA_UNITS_H) {
      const int live = cdiv(nh - u0, MXU_WARPS);
      float acc[ANA_UNITS_H][2][4] = {};
      int at[ANA_UNITS_H];
#pragma unroll
      for (int i = 0; i < ANA_UNITS_H; ++i) {
        const int u = u0 + MXU_WARPS * i, fw = u & 1, nb = (u >> 1) / tl.ncs;
        const int mc = (u >> 1) - nb * tl.ncs;
        at[i] = (fw * p.tn + 16 * mc) * p.sy + 16 * nb + lane_a(lane, p.sy);
      }
      for (int s = 0; s < p.kh; ++s) {
        const FragB b[2] = {tab_h[(2 * s) * 32 + lane], tab_h[(2 * s + 1) * 32 + lane]};
        FragA a[ANA_UNITS_H];
#pragma unroll
        for (int i = 0; i < ANA_UNITS_H; ++i)
          if (i < live) load_a(a[i], ys + at[i] + 8 * s);
        mma3(acc, a, b, live);
      }
#pragma unroll
      for (int i = 0; i < ANA_UNITS_H; ++i) {
        const int u = u0 + MXU_WARPS * i, fw = u & 1, nb = (u >> 1) / tl.ncs;
        const int mc = (u >> 1) - nb * tl.ncs;
        if (i < live) {
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            float* band = dst + (2 * fw + f) * plane;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 8 * nb + c_n(t, e), c = 16 * mc + c_m(g, e);
              if (r < tl.rows && c < tl.cols) band[static_cast<int64_t>(r) * m_w + c] = acc[i][f][e];
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K9b
// ---------------------------------------------------------------------------

// ops/_mxu2d.py:synthesis_plan, in its order.
struct SynPlan {
  int tu, tv;          // outputs of a tile
  int dq_h, dq_w;      // first band row / column read: u0 / 2 + dq
  int e_h, e_w;        // output u0 + mu takes tap e + mu - 2 mq of row q0 + mq
  int o;               // the window starts o columns left of that
  int base;            // first window column of output columns [0, 8)
  int ks, kw;          // k-steps per 8 output rows (H), 8 columns (W)
  int brows, bcols;    // the largest staged band window
  int sb, st;          // strides: window, W output (transposed)
  int tiles_h, tiles_w;
  int bbuf;            // floats of one ring stage
  int stages;          // depth of the ring, 2 or 3
};
#define SYN_PLAN_INTS 18

template <typename T>
struct Bands4 {
  const T* band[4];  // ll, lh, hl, hh
};

struct SynTile {
  int64_t b;
  int u0, v0, rows, cols;  // live outputs
  int nbs, ncs;            // 8-row and 16-column blocks of them
  int br, bc;              // the band window they read
  int q0, c0;              // its first band row / column
};

__device__ __forceinline__ SynTile syn_tile(const SynPlan& p, int64_t tile, int out_h, int out_w) {
  SynTile t;
  const int64_t per_image = int64_t(p.tiles_h) * p.tiles_w;
  t.b = tile / per_image;
  const int rest = static_cast<int>(tile - t.b * per_image);
  const int ty = rest / p.tiles_w;
  t.u0 = ty * p.tu;
  t.v0 = (rest - ty * p.tiles_w) * p.tv;
  t.rows = min(p.tu, out_h - t.u0);
  t.cols = min(p.tv, out_w - t.v0);
  t.nbs = cdiv(t.rows, 8);
  t.ncs = cdiv(t.cols, 16);
  t.br = cdiv(4 * (t.nbs - 1) + 8 * p.ks, 16) * 16;
  t.bc = 8 * (t.ncs - 1) + 4 + p.base + 8 * p.kw;
  t.q0 = t.u0 / 2 + p.dq_h;
  t.c0 = t.v0 / 2 + p.dq_w - p.o;
  return t;
}

// The four bands' windows: W[o][r][c] = B_o(q0 + r, c0 + c) modulo half
// (circular; the fold's other terms come after) or zero outside the bands.
__device__ __forceinline__ void syn_stage(float* bs, const Bands4<float>& bands, const SynPlan& p,
                                          const SynTile& t, int m_h, int m_w, int circular,
                                          int half_h, int half_w) {
  const int64_t image = t.b * m_h * m_w;
  const bool vec_rows = m_w % 4 == 0 && aligned16(bands.band[0]) && aligned16(bands.band[1]) &&
                        aligned16(bands.band[2]) && aligned16(bands.band[3]);
  const int plane = p.brows * p.sb;
  const int lim_h = circular ? half_h : m_h, lim_w = circular ? half_w : m_w;
  if (t.q0 >= 0 && t.q0 + t.br <= lim_h && t.c0 >= 0 && t.c0 + t.bc <= lim_w) {
    // the window lies inside the bands: one walk for the four
    const int64_t at = image + static_cast<int64_t>(t.q0) * m_w + t.c0;
    if (vec_rows) {
      for (Walk it(threadIdx.x, MXU_THREADS, t.bc / 4); it.outer < t.br; it.next()) {
        const int64_t src = at + it.outer * static_cast<int64_t>(m_w) + 4 * it.inner;
        const int dst = it.outer * p.sb + 4 * it.inner;
#pragma unroll
        for (int o = 0; o < 4; ++o) copy16(bs + o * plane + dst, bands.band[o] + src);
      }
    } else {
      for (Walk it(threadIdx.x, MXU_THREADS, t.bc); it.outer < t.br; it.next()) {
        const int64_t src = at + it.outer * static_cast<int64_t>(m_w) + it.inner;
        const int dst = it.outer * p.sb + it.inner;
#pragma unroll
        for (int o = 0; o < 4; ++o) copy4(bs + o * plane + dst, bands.band[o] + src, true);
      }
    }
    return;
  }
  for (Walk it(threadIdx.x, MXU_THREADS, t.bc / 4); it.outer < t.br; it.next()) {
    int qa = t.q0 + it.outer;
    bool row_in = true;
    if (circular) {
      qa = wrap_index(qa, half_h, half_h);
    } else {
      row_in = qa >= 0 && qa < m_h;
      qa = row_in ? qa : 0;
    }
    const int64_t line = image + static_cast<int64_t>(qa) * m_w;
    const int at = it.outer * p.sb + 4 * it.inner;
    const int qb = t.c0 + 4 * it.inner;
    if (!row_in) {
#pragma unroll
      for (int o = 0; o < 4; ++o) zero4(bs + o * plane + at);
    } else if (vec_rows && qb >= 0 && qb + 4 <= lim_w) {
#pragma unroll
      for (int o = 0; o < 4; ++o) copy16(bs + o * plane + at, bands.band[o] + line + qb);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int c = qb + e;
        bool in = true;
        if (circular) {
          c = wrap_index(c, half_w, half_w);
        } else {
          in = c >= 0 && c < m_w;
          c = in ? c : 0;
        }
#pragma unroll
        for (int o = 0; o < 4; ++o) copy4(bs + o * plane + at + e, bands.band[o] + line + c, in);
      }
    }
  }
}

// K9a's VJP: each staged position (ra0, rb0) also collects the band
// positions (ra0 + half_h, rb0), (ra0, rb0 + half_w) and (ra0 + half_h,
// rb0 + half_w) that lie in the band (m < 2 half: K9's gate takes images
// of 128 rows and more, m - half < 32).  Only the rows ra0 < xh = m_h -
// half_h and the columns rb0 < xw have any.  Their positions form one flat
// list, spread over the block so that every thread's loads are in flight
// at once: first the window rows of band rows k < xh (whole), then in the
// other rows the window columns of band columns i < xw (the window,
// narrower than half, reads each band row and column at most once).
__device__ __forceinline__ int fold_items(const SynTile& t, int xh, int xw, int half_h,
                                          int half_w) {
  if (t.q0 >= xh && t.q0 + t.br <= half_h && t.c0 >= xw && t.c0 + t.bc <= half_w) return 0;
  return xh * t.bc + t.br * xw;
}

__device__ __forceinline__ void syn_fold(float* bs, const Bands4<float>& bands, const SynPlan& p,
                                         const SynTile& t, int m_h, int m_w, int half_h,
                                         int half_w, int n) {
  const int xh = m_h - half_h, xw = m_w - half_w, n_rows = xh * t.bc;
  const int64_t image = t.b * m_h * m_w, down = static_cast<int64_t>(half_h) * m_w;
  const int plane = p.brows * p.sb;
  for (int f = threadIdx.x; f < n; f += MXU_THREADS) {
    int r, c, ra0, rb0;
    if (f < n_rows) {
      ra0 = f / t.bc;
      c = f - ra0 * t.bc;
      r = wrap_index(ra0 - t.q0, half_h, half_h);
      rb0 = wrap_index(t.c0 + c, half_w, half_w);
    } else {
      r = (f - n_rows) / xw;
      rb0 = f - n_rows - r * xw;
      ra0 = wrap_index(t.q0 + r, half_h, half_h);
      c = wrap_index(rb0 - t.c0, half_w, half_w);
      if (ra0 < xh) continue;  // a whole row, above
    }
    if (r >= t.br || c >= t.bc) continue;
    const bool row = ra0 < xh, col = rb0 < xw;
    const int64_t at = image + static_cast<int64_t>(ra0) * m_w + rb0;
    float v[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const float* src = bands.band[o] + at;
      v[o] = (row ? src[down] : 0.f) + (col ? src[half_w] : 0.f) +
             (row && col ? src[down + half_w] : 0.f);
    }
#pragma unroll
    for (int o = 0; o < 4; ++o) bs[o * plane + r * p.sb + c] += v[o];
  }
}

__global__ void __launch_bounds__(MXU_THREADS, 2)
    mxu2d_synthesis_kernel(const __grid_constant__ Bands4<float> bands, float* __restrict__ out,
                           const __grid_constant__ Taps<float> taps, const SynPlan p, int len,
                           int m_h, int m_w, int out_h, int out_w, int circular, int half_h,
                           int half_w, int64_t total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FragB* tab_w = reinterpret_cast<FragB*>(smem_raw);
  FragB* tab_h = tab_w + p.kw * 64;
  float* ring = reinterpret_cast<float*>(tab_h + p.ks * 64);
  float* ts = ring + p.stages * p.bbuf;  // [2 (T lo, hi)][tv][st]: T transposed
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool fold = circular && (half_h < m_h || half_w < m_w);

  // SW: B[k][n] = rec[e_w + n + 2 o - 2 base - 16s - 2k] (window columns
  // 4 j + base + 8 s + k of output column 8 j + n); SH: B[k][n] = rec[e_h +
  // n - 16s - 2k] (band rows 4 b + 8 s + k of output row 8 b + n)
  build_table(tab_w, p.kw, taps, len, p.e_w + 2 * p.o - 2 * p.base, -16, -2, 1);
  build_table(tab_h, p.ks, taps, len, p.e_h, -16, -2, 1);

  const int plane = p.brows * p.sb;
  int64_t tile = blockIdx.x;
  for (int j = 0; j < p.stages - 1; ++j) {
    const int64_t tj = tile + int64_t(j) * gridDim.x;
    if (tj < total)
      syn_stage(ring + j * p.bbuf, bands, p, syn_tile(p, tj, out_h, out_w), m_h, m_w, circular,
                half_h, half_w);
    commit_async();
  }
  for (int k = 0; tile < total; ++k, tile += gridDim.x) {
    __syncthreads();  // the last tile's passes are done with its stage and T
    const int64_t ahead = tile + int64_t(p.stages - 1) * gridDim.x;
    if (ahead < total)
      syn_stage(ring + ((k + p.stages - 1) % p.stages) * p.bbuf, bands, p,
                syn_tile(p, ahead, out_h, out_w), m_h, m_w, circular, half_h, half_w);
    commit_async();
    wait_oldest(p.stages);
    __syncthreads();
    float* const cur = ring + (k % p.stages) * p.bbuf;
    const SynTile tl = syn_tile(p, tile, out_h, out_w);
    if (fold) {
      const int n = fold_items(tl, m_h - half_h, m_w - half_w, half_h, half_w);
      if (n > 0) {
        syn_fold(cur, bands, p, tl, m_h, m_w, half_h, half_w, n);
        __syncthreads();
      }
    }

    // W pass: units (16 band rows, 8 output columns) into T^T[f][v][qa]:
    // T_lo += ll SW_lo, T_hi += lh SW_lo, then hl and hh with SW_hi
    const int nts = 2 * tl.ncs;
    const int nw = (tl.br / 16) * nts;
    for (int u0 = warp; u0 < nw; u0 += MXU_WARPS * SYN_UNITS_W) {
      const int live = cdiv(nw - u0, MXU_WARPS);
      float acc[SYN_UNITS_W][1][4] = {}, acc_hi[SYN_UNITS_W][1][4] = {};
      int at[SYN_UNITS_W];
#pragma unroll
      for (int i = 0; i < SYN_UNITS_W; ++i) {
        const int u = u0 + MXU_WARPS * i, mt = u / nts, n = u - mt * nts;
        at[i] = 16 * mt * p.sb + 4 * n + p.base + lane_a(lane, p.sb);
      }
      for (int s = 0; s < p.kw; ++s) {
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const FragB w[1] = {tab_w[(2 * s + f) * 32 + lane]};
          FragA a_lo[SYN_UNITS_W], a_hi[SYN_UNITS_W];
#pragma unroll
          for (int i = 0; i < SYN_UNITS_W; ++i) {
            if (i < live) {
              load_a(a_lo[i], cur + 2 * f * plane + at[i] + 8 * s);        // ll, hl
              load_a(a_hi[i], cur + (2 * f + 1) * plane + at[i] + 8 * s);  // lh, hh
            }
          }
          mma3(acc, a_lo, w, live);
          mma3(acc_hi, a_hi, w, live);
        }
      }
#pragma unroll
      for (int i = 0; i < SYN_UNITS_W; ++i) {
        const int u = u0 + MXU_WARPS * i, mt = u / nts, n = u - mt * nts;
        if (i < live) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int at_t = (8 * n + c_n(t, e)) * p.st + 16 * mt + c_m(g, e);
            ts[at_t] = acc[i][0][e];
            ts[p.tv * p.st + at_t] = acc_hi[i][0][e];
          }
        }
      }
    }
    __syncthreads();

    // H pass: units (16 output columns, 8 output rows): out^T = T_lo^T
    // SH_lo^T + T_hi^T SH_hi^T
    const int nh = tl.ncs * tl.nbs;
    float* const dst = out + (tl.b * out_h + tl.u0) * out_w + tl.v0;
    for (int u0 = warp; u0 < nh; u0 += MXU_WARPS * SYN_UNITS_H) {
      const int live = cdiv(nh - u0, MXU_WARPS);
      float acc[SYN_UNITS_H][1][4] = {};
      int at[SYN_UNITS_H];
#pragma unroll
      for (int i = 0; i < SYN_UNITS_H; ++i) {
        const int u = u0 + MXU_WARPS * i, nb = u / tl.ncs, mc = u - nb * tl.ncs;
        at[i] = 16 * mc * p.st + 4 * nb + lane_a(lane, p.st);
      }
      for (int s = 0; s < p.ks; ++s) {
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const FragB b[1] = {tab_h[(2 * s + f) * 32 + lane]};
          FragA a[SYN_UNITS_H];
#pragma unroll
          for (int i = 0; i < SYN_UNITS_H; ++i)
            if (i < live) load_a(a[i], ts + f * p.tv * p.st + at[i] + 8 * s);
          mma3(acc, a, b, live);
        }
      }
#pragma unroll
      for (int i = 0; i < SYN_UNITS_H; ++i) {
        const int u = u0 + MXU_WARPS * i, nb = u / tl.ncs, mc = u - nb * tl.ncs;
        if (i < live) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 8 * nb + c_n(t, e), c = 16 * mc + c_m(g, e);
            if (r < tl.rows && c < tl.cols) dst[static_cast<int64_t>(r) * out_w + c] = acc[i][0][e];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

static int cdiv_host(int a, int b) { return (a + b - 1) / b; }

static size_t ana_smem(const AnaPlan& p) {
  return sizeof(FragB) * (p.kw + p.kh) * 64 +
         sizeof(float) * (static_cast<size_t>(p.stages) * p.xbuf + 2 * static_cast<size_t>(p.tn) * p.sy);
}

static size_t syn_smem(const SynPlan& p) {
  return sizeof(FragB) * (p.kw + p.ks) * 64 +
         sizeof(float) * (static_cast<size_t>(p.stages) * p.bbuf + 2 * static_cast<size_t>(p.tv) * p.st);
}

// The plan the Python side made must cover the launch: every window,
// stride and stage it implies inside the buffers it sizes.
static bool ana_plan_ok(const AnaPlan& p, int len, int pad, int m_h, int m_w) {
  return p.tm >= 8 && p.tm % 8 == 0 && p.tn >= 16 && p.tn % 16 == 0 &&
         p.off == ((-pad) % 4 + 4) % 4 && p.kw >= 1 && 8 * p.kw >= p.off + 14 + len &&
         p.kh >= 1 && 8 * p.kh >= 14 + len && p.xrows % 16 == 0 &&
         p.xrows >= 2 * p.tm - 16 + 8 * p.kh && p.xcols >= 2 * p.tn - 16 + 8 * p.kw &&
         p.xcols % 4 == 0 && p.sx >= p.xcols && p.sx % 4 == 0 && p.sy >= p.xrows &&
         p.sy % 4 == 0 && p.tiles_h == cdiv_host(m_h, p.tm) && p.tiles_w == cdiv_host(m_w, p.tn) &&
         p.xbuf % 4 == 0 && p.xbuf >= int64_t(p.xrows) * p.sx && p.stages >= 2 && p.stages <= 3 &&
         ana_smem(p) <= MXU_MAX_SMEM;
}

static bool syn_plan_ok(const SynPlan& p, int len, int off_h, int off_w, int out_h, int out_w) {
  const int dq_h = (off_h - len + 1) >> 1, dq_w = (off_w - len + 1) >> 1;
  const int e_h = off_h - 2 * dq_h, e_w = off_w - 2 * dq_w;
  // output columns [0, 8) read window columns o + ceil((e_w - L + 1) / 2)
  // .. o + (7 + e_w) / 2, output rows [0, 8) band rows 0 .. (7 + e_h) / 2
  const int lo = (e_w - len + 2) >> 1, hi = (7 + e_w) >> 1;
  return p.tu >= 8 && p.tu % 8 == 0 && p.tv >= 16 && p.tv % 16 == 0 && p.dq_h == dq_h &&
         p.dq_w == dq_w && p.e_h == e_h && p.e_w == e_w && p.o == (dq_w % 4 + 4) % 4 &&
         p.base >= 0 && p.base % 4 == 0 && p.base <= p.o + lo && p.kw >= 1 &&
         p.base + 8 * p.kw > p.o + hi && p.ks >= 1 && 8 * p.ks > (7 + e_h) / 2 &&
         p.brows % 16 == 0 && p.brows >= p.tu / 2 - 4 + 8 * p.ks &&
         p.bcols >= p.tv / 2 - 4 + p.base + 8 * p.kw && p.bcols % 4 == 0 && p.sb >= p.bcols &&
         p.sb % 4 == 0 && p.st >= p.brows && p.st % 4 == 0 &&
         p.tiles_h == cdiv_host(out_h, p.tu) && p.tiles_w == cdiv_host(out_w, p.tv) &&
         p.bbuf % 4 == 0 && p.bbuf >= 4 * int64_t(p.brows) * p.sb && p.stages >= 2 &&
         p.stages <= 3 && syn_smem(p) <= MXU_MAX_SMEM;
}

// Raise the kernel's shared-memory limit and size its persistent grid:
// as many blocks as the SMs hold at once, at most one per tile.  The
// attribute and the occupancy are asked once per device and size, not at
// every launch (host time between a backward's launches leaves the card
// idle).
template <typename K>
static int prepare(K kernel, size_t smem, int64_t total, unsigned* blocks) {
  static std::mutex lock;
  static int known_device = -1, resident = 0;
  static size_t known_smem = 0;
  std::lock_guard<std::mutex> guard(lock);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && (device != known_device || smem != known_smem)) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MXU_THREADS, smem);
    if (err == cudaSuccess) {
      known_device = device;
      known_smem = smem;
      resident = sms * (per_sm > 0 ? per_sm : 1);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = static_cast<unsigned>(total < resident ? total : resident);
  return 0;
}

// The tiles of a launch, walked with a 64-bit index.
static bool tiles_ok(int64_t total) { return total > 0 && total < (int64_t(1) << 40); }

// The arguments of ptwt_dwt2 (dwt2.cu), then K9a's plan (ANA_PLAN_INTS
// ints); float32 only (dtype 0), at most 64 taps.  Returns a cudaError_t
// after the launch, or PTWT_BAD_ARGUMENT.
extern "C" int ptwt_mxu2d_analysis(int dtype, const void* x, void* out, const double* lo,
                                   const double* hi, int len, long long batch, int h, int w,
                                   int per_h, int per_w, int m_h, int m_w, int pad, int circular,
                                   const int* plan_ints, int plan_len, void* stream) {
  if (dtype != 0 || len < 1 || len > MXU_MAX_TAPS || batch < 1 || h < 1 || w < 1 || m_h < 1 ||
      m_w < 1 || pad < 0 || (circular && (per_h < h || per_w < w)) || !plan_ints ||
      plan_len != ANA_PLAN_INTS)
    return PTWT_BAD_ARGUMENT;
  AnaPlan p;
  static_assert(sizeof(AnaPlan) == ANA_PLAN_INTS * sizeof(int), "AnaPlan is its ints");
  memcpy(&p, plan_ints, sizeof(p));
  const int64_t total = batch * p.tiles_h * static_cast<int64_t>(p.tiles_w);
  if (!ana_plan_ok(p, len, pad, m_h, m_w) || !tiles_ok(total)) return PTWT_BAD_ARGUMENT;
  const size_t smem = ana_smem(p);
  unsigned blocks = 0;
  if (int err = prepare(mxu2d_analysis_kernel, smem, total, &blocks)) return err;
  mxu2d_analysis_kernel<<<blocks, MXU_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), make_taps<float>(lo, hi, len), p,
      len, h, w, per_h, per_w, m_h, m_w, pad, circular, total,
      batch * static_cast<int64_t>(m_h) * m_w);
  return static_cast<int>(cudaGetLastError());
}

// The arguments of ptwt_idwt2 (dwt2.cu), with per_h == out_h and
// per_w == out_w (no clamped output rows), then K9b's plan (SYN_PLAN_INTS
// ints); float32 only, at most 64 taps.
extern "C" int ptwt_mxu2d_synthesis(int dtype, const void* ll, const void* lh, const void* hl,
                                    const void* hh, void* out, const double* lo,
                                    const double* hi, int len, long long batch, int m_h, int m_w,
                                    int out_h, int out_w, int off_h, int off_w, int circular,
                                    int half_h, int half_w, int per_h, int per_w,
                                    const int* plan_ints, int plan_len, void* stream) {
  const bool folds = half_h != m_h || half_w != m_w;
  if (dtype != 0 || len < 1 || len > MXU_MAX_TAPS || batch < 1 || m_h < 1 || m_w < 1 ||
      out_h < 1 || out_w < 1 || off_h < 0 || off_w < 0 || half_h < 1 || half_h > m_h ||
      half_w < 1 || half_w > m_w || per_h != out_h || per_w != out_w || (folds && !circular) ||
      !plan_ints || plan_len != SYN_PLAN_INTS)
    return PTWT_BAD_ARGUMENT;
  SynPlan p;
  static_assert(sizeof(SynPlan) == SYN_PLAN_INTS * sizeof(int), "SynPlan is its ints");
  memcpy(&p, plan_ints, sizeof(p));
  const int64_t total = batch * p.tiles_h * static_cast<int64_t>(p.tiles_w);
  if (!syn_plan_ok(p, len, off_h, off_w, out_h, out_w) || !tiles_ok(total) ||
      (folds && (m_h >= 2 * half_h || m_w >= 2 * half_w || p.brows > half_h || p.bcols > half_w)))
    return PTWT_BAD_ARGUMENT;
  const size_t smem = syn_smem(p);
  unsigned blocks = 0;
  if (int err = prepare(mxu2d_synthesis_kernel, smem, total, &blocks)) return err;
  Bands4<float> bands;
  bands.band[0] = static_cast<const float*>(ll);
  bands.band[1] = static_cast<const float*>(lh);
  bands.band[2] = static_cast<const float*>(hl);
  bands.band[3] = static_cast<const float*>(hh);
  mxu2d_synthesis_kernel<<<blocks, MXU_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      bands, static_cast<float*>(out), make_taps<float>(lo, hi, len), p, len, m_h, m_w, out_h,
      out_w, circular, half_h, half_w, total);
  return static_cast<int>(cudaGetLastError());
}
