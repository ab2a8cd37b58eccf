// K9a and K9b: one circular 2d filter-bank level as banded-window matrix
// products on the tensor cores.
//
// K9a replaces the Pallas kernel ptwt_tpu/ops/_mxu2d.py:_dwt_kernel, K9b
// replaces ptwt_tpu/ops/_mxu2d.py:_idwt_kernel.  They take the arguments
// of a K1 / K2 launch (dwt2.cu) and give the same outputs, every mode
// included, so the autograd Functions of ops/_pallas2d.py drive both pairs
// through one code path:
//
// * K9a: band[i, j] = sum f_a[ka] f_b[kb] X(2i + ka - pad, 2j + kb - pad)
//   for the four subbands, X read modulo the period (circular = 1; past
//   the image the last sample repeats) or zero outside the image (K9b's
//   VJP).  A block owns A_TM x A_TN band positions.  It stages its input
//   window with that extension in shared memory, runs the W pass
//   Y[r, c] = sum_kb f[kb] X[r, 2c + kb] as products [16 rows x 8 bands]
//   over k-steps of 8 input columns (the JAX package's x_ext @ FW), then
//   the H pass band[i, c] = sum_ka f[ka] Y[2i + ka, c] as [16 x 8] products
//   over k-steps of 8 rows of Y (FH @ y).
// * K9b: out[u, v] = sum rec_a[ka] rec_b[kb] B(qa, qb) with
//   qa = (u + off_h - ka) / 2 over the parity-matched taps, B read modulo
//   half the period and folded (each band row also collecting the rows
//   + half, + 2 half, ... < m: K9a's VJP), or zero outside the bands (the
//   cropped periodic synthesis).  A block owns S_TU x S_TV outputs: it
//   stages the band window its outputs read, folded or zero-extended, runs
//   the H pass Z = SH_lo ll + SH_hi lh (and hl, hh) over k-steps of 8 band
//   rows, then out = Z_lo SW_lo + Z_hi SW_hi over k-steps of 8 band
//   columns.  The crop lives in the index range (off = pad).  An output
//   past the image's last row (the clamp of an odd periodization axis) is
//   not taken: K9's gate admits even images only.
//
// The extension is chosen at staging, not in the products.  The band
// matrices (FW, FH, SH, SW) are never loaded: 98% of FW's entries are zero
// and it would not fit in shared memory.  Each operand fragment of a band
// matrix depends only on the k-step, the filter and the lane, so a block
// builds a table of them from the taps at its start, and the products run
// over the k-steps inside the band only: ceil((L + 14) / 8) per 8 band
// columns and ceil((L + 30) / 8) per 16 band rows in K9a, about 16x fewer
// than the dense 384-deep product.
//
// Precision: mma.sync.m16n8k8 takes TF32 operands (10 mantissa bits).  One
// pass keeps about 3 decimal digits: built with -DPTWT_MXU2D_ONE_PASS it
// is 5e-4 off the plain version relative to the band's magnitude (2.7e-3
// absolute) on the headline's level on an H100, 25 times the port's 2e-5
// limit (PERF.md).  So each operand is split, a = a_big + a_small
// with a_big = tf32(a) and a_small = tf32(a - a_big), and each product is
// small*big + big*small + big*big (3xTF32) accumulated in float32, which
// drops only the small*small term (about 2^-22 relative).
//
// Bound on the H100: bytes.  K9a reads the image once and writes four
// quarter-size bands, K9b the mirror image: the same bytes as K1/K2.  The
// band-only products at 3x take a quarter to a third of that time at 495
// TF32 TFLOP/s.  The staging is scalar, one warp per row, lanes along the
// contiguous axis; a TMA or cp.async pipeline and a persistent grid are
// the next steps.
#include "common.cuh"

#define MXU_THREADS 256
#define MXU_WARPS (MXU_THREADS / 32)
#define MXU_MAX_TAPS 64
#define MXU_MAX_SMEM 232448
// K9a tile: band rows x band columns; K9b tile: output rows x columns
#define A_TM 32
#define A_TN 64
#define S_TU 64
#define S_TV 64

struct __align__(16) FragA {  // a 16x8 A operand, split
  uint32_t big[4], small[4];
};
struct __align__(16) FragB {  // an 8x8 B operand, split
  uint32_t big[2], small[2];
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
#ifdef PTWT_MXU2D_ONE_PASS
  small = 0u;
#else
  small = to_tf32(x - __uint_as_float(big));
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

// d += a b in 3xTF32, the small products first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
#ifndef PTWT_MXU2D_ONE_PASS
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
#endif
  mma_tf32(d, a.big, b.big);
}

// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4):
//   A[16x8]: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B[8x8]:  b0 (k = t, n = g), b1 (k = t+4, n = g)
//   C[16x8]: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// A from a row-major tile at `base` with row stride `stride`.
__device__ __forceinline__ void load_a(FragA& f, const float* base, int stride,
                                       int g, int t) {
  split(base[g * stride + t], f.big[0], f.small[0]);
  split(base[(g + 8) * stride + t], f.big[1], f.small[1]);
  split(base[g * stride + t + 4], f.big[2], f.small[2]);
  split(base[(g + 8) * stride + t + 4], f.big[3], f.small[3]);
}

// B from a tile stored k-major: element (k, n) at base[k * stride + n].
__device__ __forceinline__ void load_b(FragB& f, const float* base, int stride,
                                       int g, int t) {
  split(base[t * stride + g], f.big[0], f.small[0]);
  split(base[(t + 4) * stride + g], f.big[1], f.small[1]);
}

__device__ __forceinline__ float tap_at(const float* taps, int len, int k) {
  return k >= 0 && k < len ? taps[k] : 0.f;
}

__device__ __forceinline__ void store_c(float* base, int stride, int g, int t,
                                        const float (&c)[4]) {
  *reinterpret_cast<float2*>(base + g * stride + 2 * t) = make_float2(c[0], c[1]);
  *reinterpret_cast<float2*>(base + (g + 8) * stride + 2 * t) =
      make_float2(c[2], c[3]);
}

// ---------------------------------------------------------------------------
// K9a
// ---------------------------------------------------------------------------

struct AnaPlan {
  int len;
  int kw, kh;      // k-steps per 8 band columns (W pass), 16 band rows (H)
  int rows, cols;  // staged input window
  int sx, sy;      // shared-memory strides of X and Y (bank-conflict free)
  int tiles_h, tiles_w;
};

static AnaPlan ana_plan(int len, int m_h, int m_w) {
  AnaPlan p;
  p.len = len;
  p.kw = (len + 14 + 7) / 8;
  p.kh = (len + 30 + 7) / 8;
  const int yrows = 2 * A_TM - 32 + 8 * p.kh;  // rows of Y the H pass reads
  p.rows = (yrows + 15) / 16 * 16;
  p.cols = 2 * A_TN - 16 + 8 * p.kw;
  p.sx = p.cols + 4;   // = 4 mod 8: the A loads' 8 rows x 4 columns
  p.sy = A_TN + 8;     // = 8 mod 32: the B loads' 4 rows x 8 columns
  p.tiles_h = (m_h + A_TM - 1) / A_TM;
  p.tiles_w = (m_w + A_TN - 1) / A_TN;
  return p;
}

static size_t ana_smem(const AnaPlan& p) {
  return sizeof(FragB) * p.kw * 64 + sizeof(FragA) * p.kh * 64 +
         sizeof(float) * (static_cast<size_t>(p.rows) * p.sx +
                          2 * static_cast<size_t>(p.rows) * p.sy);
}

__global__ void __launch_bounds__(MXU_THREADS)
    mxu2d_analysis_kernel(const float* __restrict__ x, float* __restrict__ out,
                          const __grid_constant__ Taps<float> taps,
                          const AnaPlan plan, int h, int w, int per_h,
                          int per_w, int m_h, int m_w, int pad, int circular,
                          int64_t plane) {
  extern __shared__ uint4 smem[];
  FragB* tab_w = reinterpret_cast<FragB*>(smem);
  FragA* tab_h = reinterpret_cast<FragA*>(tab_w + plan.kw * 64);
  float* xs = reinterpret_cast<float*>(tab_h + plan.kh * 64);
  float* ys = xs + plan.rows * plan.sx;  // [2 (W lo, hi)][rows][sy]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  unsigned blk = blockIdx.x;
  const int tx = static_cast<int>(blk % static_cast<unsigned>(plan.tiles_w));
  blk /= static_cast<unsigned>(plan.tiles_w);
  const int ty = static_cast<int>(blk % static_cast<unsigned>(plan.tiles_h));
  const unsigned b = blk / static_cast<unsigned>(plan.tiles_h);
  const int i0 = ty * A_TM, j0 = tx * A_TN;

  // FW's B fragments: B[k][n] = f[8s + k - 2n] in the window of 8 bands
  for (int e = tid; e < plan.kw * 64; e += MXU_THREADS) {
    const int s = e >> 6, ln = e & 31, gg = ln >> 2, tt = ln & 3;
    const float* f = (e >> 5) & 1 ? taps.hi : taps.lo;
    FragB fr;
    split(tap_at(f, plan.len, 8 * s + tt - 2 * gg), fr.big[0], fr.small[0]);
    split(tap_at(f, plan.len, 8 * s + tt + 4 - 2 * gg), fr.big[1], fr.small[1]);
    tab_w[e] = fr;
  }
  // FH's A fragments: A[r][c] = f[8s + c - 2r] in the window of 16 bands
  for (int e = tid; e < plan.kh * 64; e += MXU_THREADS) {
    const int s = e >> 6, ln = e & 31, gg = ln >> 2, tt = ln & 3;
    const float* f = (e >> 5) & 1 ? taps.hi : taps.lo;
    const int k = 8 * s + tt - 2 * gg;
    FragA fr;
    split(tap_at(f, plan.len, k), fr.big[0], fr.small[0]);
    split(tap_at(f, plan.len, k - 16), fr.big[1], fr.small[1]);
    split(tap_at(f, plan.len, k + 4), fr.big[2], fr.small[2]);
    split(tap_at(f, plan.len, k - 12), fr.big[3], fr.small[3]);
    tab_h[e] = fr;
  }
  // the input window X[r][c] = X(2 i0 - pad + r, 2 j0 - pad + c)
  const float* img = x + static_cast<int64_t>(b) * h * w;
  const int r0 = 2 * i0 - pad, c0 = 2 * j0 - pad;
  for (int r = warp; r < plan.rows; r += MXU_WARPS) {
    int gr = r0 + r;
    bool row_in = true;
    if (circular) {
      gr = wrap_index(gr, per_h, h);
    } else {
      row_in = gr >= 0 && gr < h;
      gr = row_in ? gr : 0;
    }
    const float* line = img + static_cast<int64_t>(gr) * w;
    float* dst = xs + r * plan.sx;
    for (int c = lane; c < plan.cols; c += 32) {
      const int gc = c0 + c;
      float v = 0.f;
      if (circular)
        v = line[wrap_index(gc, per_w, w)];
      else if (row_in && gc >= 0 && gc < w)
        v = line[gc];
      dst[c] = v;
    }
  }
  __syncthreads();

  // W pass: Y_f[r][8 nt + n] over the k-steps from input column 16 nt
  const int ntiles = A_TN / 8;
  for (int u = warp; u < plan.rows / 16 * ntiles; u += MXU_WARPS) {
    const int mt = u / ntiles, nt = u % ntiles;
    float acc_lo[4] = {0.f, 0.f, 0.f, 0.f}, acc_hi[4] = {0.f, 0.f, 0.f, 0.f};
    const float* base = xs + 16 * mt * plan.sx + 16 * nt;
    for (int s = 0; s < plan.kw; ++s) {
      FragA a;
      load_a(a, base + 8 * s, plan.sx, g, t);
      mma3(acc_lo, a, tab_w[(2 * s) * 32 + lane]);
      mma3(acc_hi, a, tab_w[(2 * s + 1) * 32 + lane]);
    }
    float* y_lo = ys + 16 * mt * plan.sy + 8 * nt;
    store_c(y_lo, plan.sy, g, t, acc_lo);
    store_c(y_lo + plan.rows * plan.sy, plan.sy, g, t, acc_hi);
  }
  __syncthreads();

  // H pass: band[16 mt + r][8 nt + n] over the k-steps from Y row 32 mt,
  // both H filters on one B fragment; (ll, lh, hl, hh) = (H, W) filters
  // (lo, lo), (hi, lo), (lo, hi), (hi, hi)
  for (int u = warp; u < A_TM / 16 * ntiles * 2; u += MXU_WARPS) {
    const int fw = u & 1, mt = (u >> 1) / ntiles, nt = (u >> 1) % ntiles;
    const float* base = ys + (fw * plan.rows + 32 * mt) * plan.sy + 8 * nt;
    float acc_lo[4] = {0.f, 0.f, 0.f, 0.f}, acc_hi[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < plan.kh; ++s) {
      FragB bf;
      load_b(bf, base + 8 * s * plan.sy, plan.sy, g, t);
      mma3(acc_lo, tab_h[(2 * s) * 32 + lane], bf);
      mma3(acc_hi, tab_h[(2 * s + 1) * 32 + lane], bf);
    }
    const int64_t band_lo = (fw ? 2 : 0) * plane, band_hi = (fw ? 3 : 1) * plane;
    const int jj = j0 + 8 * nt + 2 * t;
    for (int half = 0; half < 2; ++half) {
      const int ii = i0 + 16 * mt + g + 8 * half;
      if (ii >= m_h) continue;
      const int64_t at = (static_cast<int64_t>(b) * m_h + ii) * m_w + jj;
      for (int q = 0; q < 2; ++q) {
        if (jj + q >= m_w) continue;
        out[band_lo + at + q] = acc_lo[2 * half + q];
        out[band_hi + at + q] = acc_hi[2 * half + q];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K9b
// ---------------------------------------------------------------------------

struct SynPlan {
  int len;
  int ks, kw;          // k-steps per 16 output rows (H), 8 output columns (W)
  int brows, bcols;    // staged band window
  int sb, sz;          // strides of the bands (= 8 mod 16) and of Z (= 4 mod 8)
  int tiles_h, tiles_w;
};

static SynPlan syn_plan(int len, int out_h, int out_w) {
  SynPlan p;
  p.len = len;
  // 16 output rows read (15 + L) / 2 + 1 band rows, 8 columns (7 + L) / 2 + 1
  p.ks = ((len + 15) / 2 + 1 + 7) / 8;
  p.kw = ((len + 7) / 2 + 1 + 7) / 8;
  p.brows = S_TU / 2 - 8 + 8 * p.ks;
  p.bcols = (S_TV / 2 - 4 + 8 * p.kw + 7) / 8 * 8;
  p.sb = p.bcols % 16 == 8 ? p.bcols : p.bcols + 8;
  p.sz = p.bcols + 4;
  p.tiles_h = (out_h + S_TU - 1) / S_TU;
  p.tiles_w = (out_w + S_TV - 1) / S_TV;
  return p;
}

static size_t syn_smem(const SynPlan& p) {
  return sizeof(FragA) * p.ks * 64 + sizeof(FragB) * p.kw * 64 +
         sizeof(float) * (4 * static_cast<size_t>(p.brows) * p.sb +
                          2 * static_cast<size_t>(S_TU) * p.sz);
}

template <typename T>
struct Bands4 {
  const T* band[4];  // ll, lh, hl, hh
};

__global__ void __launch_bounds__(MXU_THREADS)
    mxu2d_synthesis_kernel(const Bands4<float> bands, float* __restrict__ out,
                           const __grid_constant__ Taps<float> taps,
                           const SynPlan plan, int m_h, int m_w, int out_h,
                           int out_w, int off_h, int off_w, int circular,
                           int half_h, int half_w) {
  extern __shared__ uint4 smem[];
  FragA* tab_h = reinterpret_cast<FragA*>(smem);
  FragB* tab_w = reinterpret_cast<FragB*>(tab_h + plan.ks * 64);
  float* bs = reinterpret_cast<float*>(tab_w + plan.kw * 64);  // [4][brows][sb]
  float* zs = bs + 4 * plan.brows * plan.sb;                   // [2][S_TU][sz]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int L = plan.len;
  unsigned blk = blockIdx.x;
  const int tx = static_cast<int>(blk % static_cast<unsigned>(plan.tiles_w));
  blk /= static_cast<unsigned>(plan.tiles_w);
  const int ty = static_cast<int>(blk % static_cast<unsigned>(plan.tiles_h));
  const unsigned b = blk / static_cast<unsigned>(plan.tiles_h);
  const int u0 = ty * S_TU, v0 = tx * S_TV;
  // first staged band row / column (floor division), and e = u0 + off -
  // 2 q0 in {L - 1, L}: output u0 + mu reads tap e + mu - 2 mq of row q0 + mq
  const int q0 = (u0 + off_h - L + 1) >> 1, qc0 = (v0 + off_w - L + 1) >> 1;
  const int e_h = u0 + off_h - 2 * q0, e_w = v0 + off_w - 2 * qc0;

  // SH's A fragments: A[r][c] = rec[e_h + r - 16s - 2c]
  for (int e = tid; e < plan.ks * 64; e += MXU_THREADS) {
    const int s = e >> 6, ln = e & 31, gg = ln >> 2, tt = ln & 3;
    const float* f = (e >> 5) & 1 ? taps.hi : taps.lo;
    const int k = e_h + gg - 16 * s - 2 * tt;
    FragA fr;
    split(tap_at(f, L, k), fr.big[0], fr.small[0]);
    split(tap_at(f, L, k + 8), fr.big[1], fr.small[1]);
    split(tap_at(f, L, k - 8), fr.big[2], fr.small[2]);
    split(tap_at(f, L, k), fr.big[3], fr.small[3]);
    tab_h[e] = fr;
  }
  // SW's B fragments: B[k][n] = rec[e_w + n - 16s - 2k]
  for (int e = tid; e < plan.kw * 64; e += MXU_THREADS) {
    const int s = e >> 6, ln = e & 31, gg = ln >> 2, tt = ln & 3;
    const float* f = (e >> 5) & 1 ? taps.hi : taps.lo;
    const int k = e_w + gg - 16 * s - 2 * tt;
    FragB fr;
    split(tap_at(f, L, k), fr.big[0], fr.small[0]);
    split(tap_at(f, L, k - 8), fr.big[1], fr.small[1]);
    tab_w[e] = fr;
  }
  // the band window, folded modulo half (circular) or zero outside
  const int64_t band0 = static_cast<int64_t>(b) * m_h * m_w;
  for (int r = warp; r < plan.brows; r += MXU_WARPS) {
    int qa = q0 + r;
    bool row_in = true;
    if (circular)
      qa = wrap_index(qa, half_h, half_h);
    else
      row_in = qa >= 0 && qa < m_h;
    for (int c = lane; c < plan.bcols; c += 32) {
      int qb = qc0 + c;
      bool in = row_in;
      if (circular)
        qb = wrap_index(qb, half_w, half_w);
      else
        in = in && qb >= 0 && qb < m_w;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (in) {
        for (int ra = qa; ra < m_h; ra += half_h) {
          const int64_t line = band0 + static_cast<int64_t>(ra) * m_w;
          for (int rb = qb; rb < m_w; rb += half_w)
            for (int o = 0; o < 4; ++o) v[o] += bands.band[o][line + rb];
        }
      }
      for (int o = 0; o < 4; ++o) bs[(o * plan.brows + r) * plan.sb + c] = v[o];
    }
  }
  __syncthreads();

  // H pass: Z_lo = SH_lo ll + SH_hi lh, Z_hi = SH_lo hl + SH_hi hh, for
  // output rows 16 mt + r over the k-steps from band row 8 mt
  const int nb = plan.bcols / 8;
  const int plane_s = plan.brows * plan.sb;
  for (int u = warp; u < S_TU / 16 * nb; u += MXU_WARPS) {
    const int mt = u / nb, nt = u % nb;
    float z_lo[4] = {0.f, 0.f, 0.f, 0.f}, z_hi[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < plan.ks; ++s) {
      const float* base = bs + (8 * mt + 8 * s) * plan.sb + 8 * nt;
      const FragA& a_lo = tab_h[(2 * s) * 32 + lane];
      const FragA& a_hi = tab_h[(2 * s + 1) * 32 + lane];
      FragB f;
      load_b(f, base, plan.sb, g, t);
      mma3(z_lo, a_lo, f);
      load_b(f, base + plane_s, plan.sb, g, t);
      mma3(z_lo, a_hi, f);
      load_b(f, base + 2 * plane_s, plan.sb, g, t);
      mma3(z_hi, a_lo, f);
      load_b(f, base + 3 * plane_s, plan.sb, g, t);
      mma3(z_hi, a_hi, f);
    }
    float* z = zs + 16 * mt * plan.sz + 8 * nt;
    store_c(z, plan.sz, g, t, z_lo);
    store_c(z + S_TU * plan.sz, plan.sz, g, t, z_hi);
  }
  __syncthreads();

  // W pass: out = Z_lo SW_lo + Z_hi SW_hi for output columns 8 nt + n over
  // the k-steps from band column 4 nt
  const int ntiles = S_TV / 8;
  float* dst = out + static_cast<int64_t>(b) * out_h * out_w;
  for (int u = warp; u < S_TU / 16 * ntiles; u += MXU_WARPS) {
    const int mt = u / ntiles, nt = u % ntiles;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* base = zs + 16 * mt * plan.sz + 4 * nt;
    for (int s = 0; s < plan.kw; ++s) {
      FragA a;
      load_a(a, base + 8 * s, plan.sz, g, t);
      mma3(acc, a, tab_w[(2 * s) * 32 + lane]);
      load_a(a, base + S_TU * plan.sz + 8 * s, plan.sz, g, t);
      mma3(acc, a, tab_w[(2 * s + 1) * 32 + lane]);
    }
    const int vv = v0 + 8 * nt + 2 * t;
    for (int half = 0; half < 2; ++half) {
      const int uu = u0 + 16 * mt + g + 8 * half;
      if (uu >= out_h) continue;
      for (int q = 0; q < 2; ++q)
        if (vv + q < out_w)
          dst[static_cast<int64_t>(uu) * out_w + vv + q] = acc[2 * half + q];
    }
  }
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

static bool grid_ok(int64_t blocks) {
  return blocks > 0 && blocks < (int64_t(1) << 31);
}

// The arguments of ptwt_dwt2 (dwt2.cu); float32 only (dtype 0), at most 64
// taps.  Returns a cudaError_t after the launch, or PTWT_BAD_ARGUMENT.
extern "C" int ptwt_mxu2d_analysis(int dtype, const void* x, void* out,
                                   const double* lo, const double* hi, int len,
                                   long long batch, int h, int w, int per_h,
                                   int per_w, int m_h, int m_w, int pad,
                                   int circular, void* stream) {
  if (dtype != 0 || len < 1 || len > MXU_MAX_TAPS || batch < 1 || h < 1 ||
      w < 1 || m_h < 1 || m_w < 1 || pad < 0 ||
      (circular && (per_h < h || per_w < w)))
    return PTWT_BAD_ARGUMENT;
  const AnaPlan plan = ana_plan(len, m_h, m_w);
  const int64_t blocks = batch * plan.tiles_h * static_cast<int64_t>(plan.tiles_w);
  const size_t smem = ana_smem(plan);
  if (!grid_ok(blocks) || smem > MXU_MAX_SMEM) return PTWT_BAD_ARGUMENT;
  cudaError_t err = cudaFuncSetAttribute(
      mxu2d_analysis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mxu2d_analysis_kernel<<<static_cast<unsigned>(blocks), MXU_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      make_taps<float>(lo, hi, len), plan, h, w, per_h, per_w, m_h, m_w, pad,
      circular, batch * static_cast<int64_t>(m_h) * m_w);
  return static_cast<int>(cudaGetLastError());
}

// The arguments of ptwt_idwt2 (dwt2.cu), with per_h == out_h and
// per_w == out_w (no clamped output rows); float32 only, at most 64 taps.
extern "C" int ptwt_mxu2d_synthesis(int dtype, const void* ll, const void* lh,
                                    const void* hl, const void* hh, void* out,
                                    const double* lo, const double* hi,
                                    int len, long long batch, int m_h, int m_w,
                                    int out_h, int out_w, int off_h, int off_w,
                                    int circular, int half_h, int half_w,
                                    int per_h, int per_w, void* stream) {
  const bool folds = half_h != m_h || half_w != m_w;
  if (dtype != 0 || len < 1 || len > MXU_MAX_TAPS || batch < 1 || m_h < 1 ||
      m_w < 1 || out_h < 1 || out_w < 1 || off_h < 0 || off_w < 0 ||
      half_h < 1 || half_h > m_h || half_w < 1 || half_w > m_w ||
      per_h != out_h || per_w != out_w || (folds && !circular))
    return PTWT_BAD_ARGUMENT;
  const SynPlan plan = syn_plan(len, out_h, out_w);
  const int64_t blocks = batch * plan.tiles_h * static_cast<int64_t>(plan.tiles_w);
  const size_t smem = syn_smem(plan);
  if (!grid_ok(blocks) || smem > MXU_MAX_SMEM) return PTWT_BAD_ARGUMENT;
  cudaError_t err = cudaFuncSetAttribute(
      mxu2d_synthesis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Bands4<float> bands;
  bands.band[0] = static_cast<const float*>(ll);
  bands.band[1] = static_cast<const float*>(lh);
  bands.band[2] = static_cast<const float*>(hl);
  bands.band[3] = static_cast<const float*>(hh);
  mxu2d_synthesis_kernel<<<static_cast<unsigned>(blocks), MXU_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      bands, static_cast<float*>(out), make_taps<float>(lo, hi, len), plan,
      m_h, m_w, out_h, out_w, off_h, off_w, circular, half_h, half_w);
  return static_cast<int>(cudaGetLastError());
}
