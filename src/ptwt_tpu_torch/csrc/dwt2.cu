// K1 and K2: one circular 2d filter-bank level over both spatial axes, as
// shared-memory tiles.
//
// K1 replaces the Pallas kernel ptwt_tpu/ops/_pallas2d.py:_dwt2_kernel,
// K2 replaces ptwt_tpu/ops/_pallas2d.py:_idwt2_kernel.
//
// K1: band[i, j] = sum_a sum_b f_a[ka] f_b[kb] x[src(2i+ka-p), src(2j+kb-p)]
// for the four subbands (ll, lh, hl, hh) of a [B, h, w] image, written as
// one [4, B, m_h, m_w] tensor so that each subband is contiguous.  src() is
// the circular source map (periodization of odd axes repeats the last
// sample); reading modulo the period makes the band of pywt's even-length
// periodic mode come out whole, wrap entries included, with no copy.
//
// K2: out[u, v] = sum over taps of rec_a[ka] rec_b[kb] band[qa, qb] with
// qa = (u + off_h - ka) / 2 for the taps of matching parity: circular in
// q for periodization, and for periodic a crop of the transposed
// convolution folded into the index range, exact for any coefficients.
//
// The two are each other's VJP, as in the JAX package (_level_calls), with
// the same taps and pad:
//
// * K1's VJP is K2's circular synthesis with off = pad.  pywt's periodic
//   band is longer than half its period (m = n/2 + len/2 - 1 rows), and an
//   odd periodization axis repeats its last sample, so K2 takes a fold:
//   each band row q read modulo `half` also collects rows q + half,
//   q + 2 half, ... < m, and the last output row also collects the output
//   positions [out, per) (the clamp's adjoint).  Without a fold
//   (half == m, per == out) K2 is the plain synthesis.
// * K2's VJP is K1's read with pad = off: circular for periodization, and
//   zero outside [0, n) for the cropped periodic synthesis (the transpose
//   of a crop folded into the index range is a zero-bounded correlation).
//
// Bound on the H100: bytes.  K1 reads the image once and writes four
// quarter-size bands, K2 the mirror image; a level costs about L
// multiply-adds per sample and axis, far below the card's operations per
// byte.  So each block stages the window its outputs read once in shared
// memory, with the mode applied while staging (modulo the period with the
// odd-axis repeat, zero outside, or the band fold), and the two separable
// passes read shared memory only, with no branch on the mode:
//
// * K1 (dwt2_tile_kernel): a block owns T x T positions of every band.  It
//   stages its input window, 2 (T + L/2 - 1) rows and columns, split into
//   even and odd columns (so the stride-2 reads are unit-stride), runs the
//   W pass Y_lo/Y_hi[r][j] = sum_kb f[kb] X[r][2j + kb] into shared
//   memory, then the H pass band[i][j] = sum_ka f[ka] Y[2i + ka][j] into
//   the four bands, each lane storing along w.
// * K2 (idwt2_tile_kernel): a block owns T x T outputs.  Output position
//   F = u + off belongs to pair s = F / 2 and reads taps (F & 1) + 2j of
//   band row s - j, j < L/2: both positions of a pair read the same rows,
//   and every pair reads the same two taps at step j.  The block stages
//   the (T + ext) / 2 + L/2 band rows and columns its pairs read, runs the
//   H pass Z_lo = sum rec_lo ll + rec_hi lh, Z_hi = sum rec_lo hl +
//   rec_hi hh into shared memory (two positions per thread), adds the
//   clamp's extra rows into its last row, then the W pass out = sum rec_lo
//   Z_lo + rec_hi Z_hi, two neighbouring outputs per thread, stored along
//   w as one vector where the address allows.  The clamp's adjoint (the
//   ext = per - out positions past the last output) costs only the tiles
//   that own the last row or column.
//
// In every pass a warp's lanes run along the contiguous axis and read the
// same tap at the same step, which the kernel-parameter bank broadcasts;
// staging keeps 8 (K1) or 16 (K2: four bands of 4 elements) loads in
// flight per thread, and K2's fold adds its extra band rows in a second,
// sparse pass.  Blocks compute
// image and tile offsets in 64 bits and walk the batch folded into the
// grid, so no launch is limited by its number of outputs.
//
// Shared memory: T is the largest of 64, 32, 16, 8 (K1: 32, 16, 8) whose
// block fits 65,536 bytes, so that several blocks share an SM, else the
// largest that fits the 232,448 a block can have (a long filter's window is
// mostly halo, so it keeps the largest tile the card takes).  K1 holds
// 2 (2T + L - 2) (2T + L/2 - 1) values, K2 4 br^2 + 4 ph br with
// ph = (T + ext) / 2 + 1 and br = ph + L/2 - 1, both beside a few hundred
// bytes of index tables (KB = 1,000 bytes):
//
//   taps (wavelet)   float32: K1       K2              float64: K1       K2
//   2 (haar)         T=32  33.3 KB   T=64  35.1 KB     T=16  16.6 KB   T=32  18.6 KB
//   8 (db4)          T=32  38.1 KB   T=64  40.0 KB     T=16  21.6 KB   T=32  23.8 KB
//   102 (coif17)     T=8   62.2 KB   T=16  64.7 KB     T=16 174.2 KB   T=32 180.6 KB
#include "common.cuh"

#define DWT2_SMEM_TARGET (64 * 1024)
#define DWT2_SMEM_MAX 232448
#define STAGE_LOADS 8
#define BAND_LOADS 4

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

// Steps a flat index through a [rows, cols] grid in strides of the block.
struct Walk {
  int row, col, drow, dcol, cols;
  __device__ __forceinline__ Walk(int idx, int cols_) : cols(cols_) {
    row = idx / cols;
    col = idx - row * cols;
    drow = PTWT_THREADS / cols;
    dcol = PTWT_THREADS - drow * cols;
  }
  __device__ __forceinline__ void next() {
    row += drow;
    col += dcol;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

// Block `blk` of a [batch, tiles_h, tiles_w] grid.
struct TileAt {
  int64_t b;
  int ty, tx;
  __device__ __forceinline__ TileAt(int64_t blk, int tiles_h, int tiles_w) {
    tx = static_cast<int>(blk % tiles_w);
    const int64_t rest = blk / tiles_w;
    ty = static_cast<int>(rest % tiles_h);
    b = rest / tiles_h;
  }
};

// ---------------------------------------------------------------------------
// K1: analysis (zero-bounded: K2's VJP)
// ---------------------------------------------------------------------------

struct AnaTile {
  int t, tp;   // band positions per side; taps per parity, (len + 1) / 2
  int xr, xh;  // staged input rows; columns per parity plane
  int tiles_h, tiles_w;
};

static size_t ana_smem(int t, int tp, size_t item) {
  const size_t xr = 2 * (t + tp - 1), xh = t + tp - 1;
  return item * (2 * xr * xh + 2 * xr * t) + sizeof(int) * (xr + 2 * xh);
}

template <bool ZERO_BOUNDED>
__device__ __forceinline__ int source(int r, int period, int n) {
  if constexpr (ZERO_BOUNDED) return r >= 0 && r < n ? r : -1;
  return wrap_index(r, period, n);
}

template <typename T, bool ZERO_BOUNDED>
__global__ void __launch_bounds__(PTWT_THREADS)
    dwt2_tile_kernel(const T* __restrict__ x, T* __restrict__ out,
                     const __grid_constant__ Taps<T> taps, const AnaTile tile,
                     int64_t blocks, int h, int w, int per_h, int per_w,
                     int m_h, int m_w, int pad, int64_t plane) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = tile.t, tp = tile.tp, xr = tile.xr, xh = tile.xh;
  T* xs = reinterpret_cast<T*>(smem_raw);  // [2 (even, odd)][xr][xh]
  T* ys = xs + 2 * xr * xh;                // [2 (lo, hi)][xr][t]
  int* rows = reinterpret_cast<int*>(ys + 2 * xr * t);  // source row or -1
  int* cols = rows + xr;                                // [2 xh]
  const int tid = threadIdx.x;
  for (int64_t blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const TileAt at(blk, tile.tiles_h, tile.tiles_w);
    const int i0 = at.ty * t, j0 = at.tx * t;
    for (int r = tid; r < xr; r += PTWT_THREADS)
      rows[r] = source<ZERO_BOUNDED>(2 * i0 - pad + r, per_h, h);
    for (int c = tid; c < 2 * xh; c += PTWT_THREADS)
      cols[c] = source<ZERO_BOUNDED>(2 * j0 - pad + c, per_w, w);
    __syncthreads();

    // the input window, even columns in plane 0 and odd ones in plane 1
    const T* img = x + at.b * h * w;
    const int n = xr * 2 * xh;
    Walk st(tid, 2 * xh);
    for (int e = tid; e < n; e += PTWT_THREADS * STAGE_LOADS) {
      T v[STAGE_LOADS];
      int dst[STAGE_LOADS];
#pragma unroll
      for (int k = 0; k < STAGE_LOADS; ++k) {
        v[k] = T(0);
        dst[k] = -1;
        if (e + k * PTWT_THREADS < n) {
          const int sr = rows[st.row], sc = cols[st.col];
          dst[k] = ((st.col & 1) * xr + st.row) * xh + (st.col >> 1);
          if (sr >= 0 && sc >= 0) v[k] = img[static_cast<int64_t>(sr) * w + sc];
        }
        st.next();
      }
#pragma unroll
      for (int k = 0; k < STAGE_LOADS; ++k)
        if (dst[k] >= 0) xs[dst[k]] = v[k];
    }
    __syncthreads();

    // W pass: Y[r][j] = sum_a f[2a] X_even[r][j + a] + f[2a + 1] X_odd[r][j + a]
    const T* xo = xs + xr * xh;
    T* yhi = ys + xr * t;
    Walk wp(tid, t);
    for (int e = tid; e < xr * t; e += PTWT_THREADS, wp.next()) {
      const T* pe = xs + wp.row * xh + wp.col;
      const T* po = xo + wp.row * xh + wp.col;
      T lo = T(0), hi = T(0);
      for (int a = 0; a < tp; ++a) {
        const T ve = pe[a], vo = po[a];
        lo += taps.lo[2 * a] * ve + taps.lo[2 * a + 1] * vo;
        hi += taps.hi[2 * a] * ve + taps.hi[2 * a + 1] * vo;
      }
      ys[e] = lo;
      yhi[e] = hi;
    }
    __syncthreads();

    // H pass: band[i][j] = sum_ka f[ka] Y[2i + ka][j]; lh is hi on H, lo on W
    Walk hp(tid, t);
    for (int e = tid; e < t * t; e += PTWT_THREADS, hp.next()) {
      const int i = i0 + hp.row, j = j0 + hp.col;
      if (i >= m_h || j >= m_w) continue;
      const T* yl = ys + 2 * hp.row * t + hp.col;
      const T* yh = yhi + 2 * hp.row * t + hp.col;
      T ll = T(0), lh = T(0), hl = T(0), hh = T(0);
      for (int a = 0; a < tp; ++a) {
        const T l0 = yl[2 * a * t], l1 = yl[(2 * a + 1) * t];
        const T h0 = yh[2 * a * t], h1 = yh[(2 * a + 1) * t];
        const T fl0 = taps.lo[2 * a], fl1 = taps.lo[2 * a + 1];
        const T fh0 = taps.hi[2 * a], fh1 = taps.hi[2 * a + 1];
        ll += fl0 * l0 + fl1 * l1;
        lh += fh0 * l0 + fh1 * l1;
        hl += fl0 * h0 + fl1 * h1;
        hh += fh0 * h0 + fh1 * h1;
      }
      const int64_t o = (at.b * m_h + i) * m_w + j;
      out[o] = ll;
      out[plane + o] = lh;
      out[2 * plane + o] = hl;
      out[3 * plane + o] = hh;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K2: synthesis (with the fold: K1's VJP)
// ---------------------------------------------------------------------------

template <typename T>
struct Bands2d {
  const T* band[4];  // ll, lh, hl, hh
};

// Band rows and columns of a K2 launch: read modulo half_* when circular;
// a fold (half < m) also collects the rows + half, + 2 half, ... < m, and
// the last output row and column collect the positions [out, per).
struct Fold2d {
  int half_h, half_w, per_h, per_w;
};

struct SynTile {
  int t, tp;             // outputs per side; taps per parity
  int ph, pw;            // position pairs per tile: rows, columns
  int br, bc;            // staged band rows (ph + tp - 1) and columns
  int ext_h, ext_w;      // clamp positions past the last output row, column
  int tiles_h, tiles_w;
};

static SynTile syn_shape(int t, int tp, int ext_h, int ext_w) {
  SynTile s;
  s.t = t;
  s.tp = tp;
  s.ph = (t + ext_h) / 2 + 1;
  s.pw = (t + ext_w) / 2 + 1;
  s.br = s.ph + tp - 1;
  s.bc = s.pw + tp - 1;
  s.ext_h = ext_h;
  s.ext_w = ext_w;
  return s;
}

static size_t syn_smem(const SynTile& s, size_t item) {
  return item * (4 * static_cast<size_t>(s.br) * s.bc +
                 2 * static_cast<size_t>(2 * s.ph) * s.bc) +
         sizeof(int) * (s.br + s.bc);
}

// The clamp's extra output columns [out_w, per_w) of one Z row, summed.
template <typename T>
__device__ T clamp_columns(const T* zl, const T* zh, const Taps<T>& taps,
                           int tp, int sc0, int out_w, int per_w, int off_w) {
  T acc = T(0);
  for (int v = out_w; v < per_w; ++v) {
    const int g = v + off_w, par = g & 1;
    const int c = (g >> 1) - sc0 + tp - 1;
    for (int j = 0; j < tp; ++j)
      acc += taps.lo[par + 2 * j] * zl[c - j] + taps.hi[par + 2 * j] * zh[c - j];
  }
  return acc;
}

template <typename T, bool FOLD>
__global__ void __launch_bounds__(PTWT_THREADS)
    idwt2_tile_kernel(const Bands2d<T> bands, T* __restrict__ out,
                      const __grid_constant__ Taps<T> taps, const SynTile tile,
                      int64_t blocks, int m_h, int m_w, int out_h, int out_w,
                      int off_h, int off_w, int circular, const Fold2d fold) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = tile.t, tp = tile.tp, br = tile.br, bc = tile.bc;
  const int nb = br * bc, nz = 2 * tile.ph * bc;
  T* bs = reinterpret_cast<T*>(smem_raw);  // [4][br][bc]
  T* zs = bs + 4 * nb;                     // [2 (lo, hi)][2 ph][bc]
  int* rows = reinterpret_cast<int*>(zs + 2 * nz);  // first band row or -1
  int* cols = rows + br;
  const int tid = threadIdx.x;
  const int half_h = FOLD ? fold.half_h : m_h;
  const int half_w = FOLD ? fold.half_w : m_w;
  for (int64_t blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const TileAt at(blk, tile.tiles_h, tile.tiles_w);
    const int u0 = at.ty * t, v0 = at.tx * t;
    // first pair of the tile, first staged band row / column (off >= 0)
    const int s0 = (u0 + off_h) >> 1, sc0 = (v0 + off_w) >> 1;
    const int q0 = s0 - tp + 1, qc0 = sc0 - tp + 1;
    for (int r = tid; r < br; r += PTWT_THREADS) {
      const int q = q0 + r;
      rows[r] = circular ? wrap_index(q, half_h, half_h) : (q >= 0 && q < m_h ? q : -1);
    }
    for (int c = tid; c < bc; c += PTWT_THREADS) {
      const int q = qc0 + c;
      cols[c] = circular ? wrap_index(q, half_w, half_w) : (q >= 0 && q < m_w ? q : -1);
    }
    __syncthreads();

    // the band window, zero outside: the four bands share each element's
    // source, so BAND_LOADS elements put 4 BAND_LOADS loads in flight
    const int64_t band0 = at.b * m_h * m_w;
    Walk st(tid, bc);
    for (int e = tid; e < nb; e += PTWT_THREADS * BAND_LOADS) {
      T v[BAND_LOADS][4];
#pragma unroll
      for (int k = 0; k < BAND_LOADS; ++k) {
#pragma unroll
        for (int o = 0; o < 4; ++o) v[k][o] = T(0);
        if (e + k * PTWT_THREADS < nb) {
          const int sr = rows[st.row], sc = cols[st.col];
          if (sr >= 0 && sc >= 0) {
            const int64_t i = band0 + static_cast<int64_t>(sr) * m_w + sc;
#pragma unroll
            for (int o = 0; o < 4; ++o) v[k][o] = bands.band[o][i];
          }
        }
        st.next();
      }
#pragma unroll
      for (int k = 0; k < BAND_LOADS; ++k) {
        if (e + k * PTWT_THREADS >= nb) continue;
#pragma unroll
        for (int o = 0; o < 4; ++o) bs[o * nb + e + k * PTWT_THREADS] = v[k][o];
      }
    }
    if constexpr (FOLD) {
      // the few staged rows and columns with band rows past half: each
      // thread adds them to the elements it staged
      Walk fo(tid, bc);
      for (int e = tid; e < nb; e += PTWT_THREADS, fo.next()) {
        const int sr = rows[fo.row], sc = cols[fo.col];
        if (sr + half_h >= m_h && sc + half_w >= m_w) continue;
        T add[4] = {T(0), T(0), T(0), T(0)};
        for (int ra = sr; ra < m_h; ra += half_h)
          for (int rb = sc; rb < m_w; rb += half_w) {
            if (ra == sr && rb == sc) continue;
            const int64_t i = band0 + static_cast<int64_t>(ra) * m_w + rb;
#pragma unroll
            for (int o = 0; o < 4; ++o) add[o] += bands.band[o][i];
          }
#pragma unroll
        for (int o = 0; o < 4; ++o) bs[o * nb + e] += add[o];
      }
    }
    __syncthreads();

    // H pass: pair p (positions 2 (s0 + p) and + 1) reads band row
    // p + tp - 1 - j with taps 2j and 2j + 1
    Walk hp(tid, bc);
    for (int e = tid; e < tile.ph * bc; e += PTWT_THREADS, hp.next()) {
      const int at_row = (hp.row + tp - 1) * bc + hp.col;
      const T* ll = bs + at_row;
      T ze_lo = T(0), zo_lo = T(0), ze_hi = T(0), zo_hi = T(0);
      for (int j = 0; j < tp; ++j) {
        const int d = -j * bc;
        const T a = ll[d], b = ll[nb + d], c = ll[2 * nb + d], g = ll[3 * nb + d];
        const T le = taps.lo[2 * j], lo = taps.lo[2 * j + 1];
        const T he = taps.hi[2 * j], ho = taps.hi[2 * j + 1];
        ze_lo += le * a + he * b;
        zo_lo += lo * a + ho * b;
        ze_hi += le * c + he * g;
        zo_hi += lo * c + ho * g;
      }
      const int z = 2 * hp.row * bc + hp.col;
      zs[z] = ze_lo;
      zs[z + bc] = zo_lo;
      zs[nz + z] = ze_hi;
      zs[nz + z + bc] = zo_hi;
    }
    __syncthreads();

    // Z row of output u is u - u0 + dh; the clamp's rows join the last one
    const int dh = (u0 + off_h) & 1;
    if (tile.ext_h > 0 && out_h - 1 >= u0 && out_h - 1 < u0 + t) {
      const int last = (out_h - 1 - u0 + dh) * bc;
      for (int c = tid; c < bc; c += PTWT_THREADS) {
        T lo = T(0), hi = T(0);
        for (int k = 1; k <= tile.ext_h; ++k) {
          lo += zs[last + k * bc + c];
          hi += zs[nz + last + k * bc + c];
        }
        zs[last + c] += lo;
        zs[nz + last + c] += hi;
      }
      __syncthreads();
    }

    // W pass: two neighbouring outputs per thread, stored along w
    const int v_end = min(v0 + t, out_w);
    Walk wp(tid, tile.pw);
    for (int e = tid; e < t * tile.pw; e += PTWT_THREADS, wp.next()) {
      const int u = u0 + wp.row;
      if (u >= out_h) continue;
      const T* zl = zs + (wp.row + dh) * bc;
      const T* zh = zl + nz;
      const int c = wp.col + tp - 1;
      T even = T(0), odd = T(0);
      for (int j = 0; j < tp; ++j) {
        const T a = zl[c - j], b = zh[c - j];
        even += taps.lo[2 * j] * a + taps.hi[2 * j] * b;
        odd += taps.lo[2 * j + 1] * a + taps.hi[2 * j + 1] * b;
      }
      const int v = 2 * (sc0 + wp.col) - off_w;
      const bool e_ok = v >= v0 && v < v_end;
      const bool o_ok = v + 1 >= v0 && v + 1 < v_end;
      if (tile.ext_w > 0) {
        if (e_ok && v == out_w - 1)
          even += clamp_columns(zl, zh, taps, tp, sc0, out_w, fold.per_w, off_w);
        if (o_ok && v + 1 == out_w - 1)
          odd += clamp_columns(zl, zh, taps, tp, sc0, out_w, fold.per_w, off_w);
      }
      T* dst = out + (at.b * out_h + u) * out_w + v;
      if (e_ok && o_ok &&
          reinterpret_cast<uintptr_t>(dst) % sizeof(typename Vec2<T>::type) == 0) {
        typename Vec2<T>::type pair;
        pair.x = even;
        pair.y = odd;
        *reinterpret_cast<typename Vec2<T>::type*>(dst) = pair;
      } else {
        if (e_ok) dst[0] = even;
        if (o_ok) dst[1] = odd;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The largest tile of `cands` whose shared memory fits the target, else the
// largest that fits the card; 0 if none does.
template <typename F>
static int pick_tile(const int (&cands)[4], F smem) {
  for (int t : cands)
    if (t > 0 && smem(t) <= DWT2_SMEM_TARGET) return t;
  for (int t : cands)
    if (t > 0 && smem(t) <= DWT2_SMEM_MAX) return t;
  return 0;
}

static unsigned grid_of(int64_t blocks) {
  const int64_t cap = (int64_t(1) << 31) - 1;
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

template <typename K>
static int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T>
static int launch_dwt2(const void* x, void* out, const double* lo,
                       const double* hi, int len, long long batch, int h,
                       int w, int per_h, int per_w, int m_h, int m_w, int pad,
                       int circular, cudaStream_t stream) {
  AnaTile tile;
  tile.tp = (len + 1) / 2;
  const int cands[4] = {32, 16, 8, 0};
  tile.t = pick_tile(cands, [&](int t) { return ana_smem(t, tile.tp, sizeof(T)); });
  if (tile.t == 0) return PTWT_BAD_ARGUMENT;
  tile.xr = 2 * (tile.t + tile.tp - 1);
  tile.xh = tile.t + tile.tp - 1;
  tile.tiles_h = (m_h + tile.t - 1) / tile.t;
  tile.tiles_w = (m_w + tile.t - 1) / tile.t;
  const size_t smem = ana_smem(tile.t, tile.tp, sizeof(T));
  const int64_t blocks = batch * tile.tiles_h * static_cast<int64_t>(tile.tiles_w);
  auto kernel = circular ? dwt2_tile_kernel<T, false> : dwt2_tile_kernel<T, true>;
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<grid_of(blocks), PTWT_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), make_taps<T>(lo, hi, len),
      tile, blocks, h, w, per_h, per_w, m_h, m_w, pad,
      batch * static_cast<int64_t>(m_h) * m_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_idwt2(const void* ll, const void* lh, const void* hl,
                        const void* hh, void* out, const double* lo,
                        const double* hi, int len, long long batch, int m_h,
                        int m_w, int out_h, int out_w, int off_h, int off_w,
                        int circular, Fold2d fold, cudaStream_t stream) {
  Bands2d<T> bands;
  bands.band[0] = static_cast<const T*>(ll);
  bands.band[1] = static_cast<const T*>(lh);
  bands.band[2] = static_cast<const T*>(hl);
  bands.band[3] = static_cast<const T*>(hh);
  const int tp = (len + 1) / 2;
  const int ext_h = fold.per_h - out_h, ext_w = fold.per_w - out_w;
  const int cands[4] = {64, 32, 16, 8};
  const int t = pick_tile(
      cands, [&](int c) { return syn_smem(syn_shape(c, tp, ext_h, ext_w), sizeof(T)); });
  if (t == 0) return PTWT_BAD_ARGUMENT;
  SynTile tile = syn_shape(t, tp, ext_h, ext_w);
  tile.tiles_h = (out_h + t - 1) / t;
  tile.tiles_w = (out_w + t - 1) / t;
  const size_t smem = syn_smem(tile, sizeof(T));
  const int64_t blocks = batch * tile.tiles_h * static_cast<int64_t>(tile.tiles_w);
  const bool folds = fold.half_h != m_h || fold.half_w != m_w;
  auto kernel = folds ? idwt2_tile_kernel<T, true> : idwt2_tile_kernel<T, false>;
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<grid_of(blocks), PTWT_THREADS, smem, stream>>>(
      bands, static_cast<T*>(out), make_taps<T>(lo, hi, len), tile, blocks, m_h,
      m_w, out_h, out_w, off_h, off_w, circular, fold);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = float64.  Returns a cudaError_t after the launch,
// or PTWT_BAD_ARGUMENT.  circular = 0 reads zero outside the image.
extern "C" int ptwt_dwt2(int dtype, const void* x, void* out,
                         const double* lo, const double* hi, int len,
                         long long batch, int h, int w, int per_h, int per_w,
                         int m_h, int m_w, int pad, int circular,
                         void* stream) {
  if (!sizes_ok(len, 4 * batch * static_cast<int64_t>(m_h) * m_w) ||
      batch < 1 || m_h < 1 || m_w < 1 || h < 1 || w < 1 ||
      (circular && (per_h < h || per_w < w)))
    return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dwt2<float>(x, out, lo, hi, len, batch, h, w, per_h, per_w,
                              m_h, m_w, pad, circular, s);
  if (dtype == 1)
    return launch_dwt2<double>(x, out, lo, hi, len, batch, h, w, per_h,
                               per_w, m_h, m_w, pad, circular, s);
  return PTWT_BAD_ARGUMENT;
}

// half_* and per_* set the fold (see Fold2d); half = m and per = out is
// the plain synthesis.  A fold needs circular = 1.
extern "C" int ptwt_idwt2(int dtype, const void* ll, const void* lh,
                          const void* hl, const void* hh, void* out,
                          const double* lo, const double* hi, int len,
                          long long batch, int m_h, int m_w, int out_h,
                          int out_w, int off_h, int off_w, int circular,
                          int half_h, int half_w, int per_h, int per_w,
                          void* stream) {
  const Fold2d fold{half_h, half_w, per_h, per_w};
  const bool folds =
      half_h != m_h || half_w != m_w || per_h != out_h || per_w != out_w;
  if (!sizes_ok(len, batch * static_cast<int64_t>(out_h) * out_w) ||
      batch < 1 || out_h < 1 || out_w < 1 ||
      m_h < 1 || m_w < 1 || off_h < 0 || off_w < 0 ||
      half_h < 1 || half_h > m_h || half_w < 1 || half_w > m_w ||
      per_h < out_h || per_w < out_w || (folds && !circular))
    return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_idwt2<float>(ll, lh, hl, hh, out, lo, hi, len, batch, m_h,
                               m_w, out_h, out_w, off_h, off_w, circular,
                               fold, s);
  if (dtype == 1)
    return launch_idwt2<double>(ll, lh, hl, hh, out, lo, hi, len, batch, m_h,
                                m_w, out_h, out_w, off_h, off_w, circular,
                                fold, s);
  return PTWT_BAD_ARGUMENT;
}
