// K3 and K4: one filter-bank level along one axis, as shared-memory tiles,
// each kernel also the other's VJP; and KT, the gradient with respect to
// the taps of a K3 or K4 launch (its own section below).
//
// K3 replaces the Pallas kernel ptwt_tpu/ops/_pallas2.py:_analysis_kernel,
// K4 replaces ptwt_tpu/ops/_pallas2.py:_synthesis_kernel; K4's fold
// instance carries the contract of _analysis_transpose_kernel (K3's VJP),
// K3's zero-bounded instances that of _synthesis_transpose_kernel (K4's).
//
// The tensor is viewed as [outer, n, inner] with the transformed axis in
// the middle; inner == 1 is the last axis.
//
// K3: lo[i] = sum_k dec~[k] x[src(2i + k - pad)] and the same for hi,
// written as one [2, outer, m, inner] tensor.  src() is pywt's extension
// of the unpadded axis as an index map (utils/_padding.py:source_index):
// zero (or valid, with pad 0), constant, symmetric, reflect, periodic and
// periodization (modulo `period` with the odd-axis repeat of wrap_index),
// and, for K4's VJP, modulo `period` with zeros past n.  The mode is
// applied while the window is staged, so no padded copy exists in any mode.
//
// K4: out[t] = sum over taps k with t + off - k even of rec_lo[k]
// lo[(t + off - k) / 2] + rec_hi[k] hi[(t + off - k) / 2] for up to two
// (lo, hi) pairs, written as [G, outer, out_len, inner]: the stride-2
// transposed convolution with the crop folded into the index range, band
// rows read zero outside [0, m), or modulo m for periodization.
//
// Each is the other's VJP, with no atomics and one summation order:
//
// * K3's VJP is K4 with the dec taps and off = pad (zero-bounded bands):
//   y[p] = sum over (i, k) with 2i + k - pad = p of f[k] ct[i] is K4's
//   form, and x_bar[u] sums y over every extended position p that K3 read
//   from u: u itself, plus the positions outside [0, n) with src(p) == u
//   (the mirrored and whole-period preimages of reflect and symmetric,
//   constant's pile-up, the modulo preimages and the odd-axis clamp of the
//   circular modes).  Those positions lie outside [0, n), within `reach`
//   of the ends; only the tiles at the ends collect them, from strips of
//   the first and last band rows staged with their window: after the tap
//   loop, one thread per output within `reach` adds its preimages' y[p]
//   to the output it wrote (the fold instance; mode 0 folds nothing).
// * K4's VJP is K3 with the rec taps, pad = off and the cotangent read
//   zero outside [0, out_len) (mode zero), or, for periodization, modulo
//   2m and zero past out_len (the crop makes out_len < 2m); the G pairs
//   are folded into `outer`.
//
// Bound on the H100: bytes.  A launch reads each input once and writes
// each output once; an output costs L multiply-adds per band, far below
// the card's operations per byte.  So a block owns a tile of positions
// along the axis times a run of the fastest-varying index (64 columns of
// inner in float32, 32 in float64, for a middle axis; 16 rows for the
// last axis), stages the window its outputs read once into shared memory
// with every element its own cp.async copy (coalesced along the fastest
// axis, all of a thread's copies in flight at once, no registers held),
// and computes from shared memory only:
//
// * K3 stages its 2 (T + L/2 - 1) window positions, through the mode's
//   map, once for the whole run (a table of sources per position).  On a
//   middle axis a warp's lanes run along inner, so even and odd positions
//   are rows of the window; on the last axis they are split into two
//   planes at staging (64 bytes apart in banks), so the stride-2 reads of
//   neighbouring lanes are unit-stride and free of bank conflicts.
// * K4 stages the band rows (T / 2 + L / 2 of each band of each pair) its
//   output pairs (2s - off, 2s + 1 - off) read: both positions of a pair
//   read the same rows with taps 2j and 2j + 1.
// * A thread computes four outputs (K3) or output pairs (K4), of both
//   pairs for a two-pair K4, in one tap loop, so each tap read from the
//   kernel-parameter bank feeds 4 (K3) or 4 G (K4) outputs per band.  A
//   warp's lanes run along the fastest axis, so stores are coalesced.
//
// Tiles: T is balanced over the axis (the fewest tiles of at most
// 16384 / item / C (K3, middle), 1024 / item (K3, last), 32768 / item /
// (C G) (K4, middle) or 2048 / item / G (K4, last) positions), so a block
// holds 32-37 KB of a db4 window (KB = 1,000 bytes): shared memory leaves
// room for six blocks an SM, registers (63-79 a thread) for four, three
// for the two-pair K4.  The longest bank (128 taps) needs at most 128.5 KB
// (K3's VJP on a middle axis, its strips included); above 48 KB the
// launch raises the block's limit.  Blocks
// compute offsets in 64 bits and walk a grid of at most 2^31 - 1 blocks,
// so no launch is limited by its number of outputs.
#include "common.cuh"

#define AXIS_SMEM_MAX 232448
#define AXIS_SLOTS 4
#define AXIS_ROWS 16
#define AXIS_PLANE_PAD_BYTES 64

// mode codes: how a position outside [0, n) reads (the Python glue's
// _MODE_CODE)
#define AXIS_ZERO 0
#define AXIS_CONSTANT 1
#define AXIS_SYMMETRIC 2
#define AXIS_REFLECT 3
#define AXIS_WRAP 4       // modulo period, positions past n repeat n - 1
#define AXIS_WRAP_ZERO 5  // modulo period, zero past n
#define AXIS_MODES 6

__device__ __forceinline__ int mod_pos(int p, int m) {
  const int q = p % m;
  return q < 0 ? q + m : q;
}

// The source of position p of the extended axis of n samples, or -1 for
// a zero.
__device__ __forceinline__ int source_of(int p, int n, int period, int mode) {
  if (p >= 0 && p < n) return p;
  switch (mode) {
    case AXIS_ZERO:
      return -1;
    case AXIS_CONSTANT:
      return p < 0 ? 0 : n - 1;
    case AXIS_SYMMETRIC: {
      const int q = mod_pos(p, 2 * n);
      return q < n ? q : 2 * n - 1 - q;
    }
    case AXIS_REFLECT: {
      if (n == 1) return 0;
      const int q = mod_pos(p, 2 * n - 2);
      return q < n ? q : 2 * n - 2 - q;
    }
    case AXIS_WRAP:
      return wrap_index(p, period, n);
    default: {  // AXIS_WRAP_ZERO
      const int q = mod_pos(p, period);
      return q < n ? q : -1;
    }
  }
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(addr), "l"(src),
               "n"(static_cast<int>(sizeof(T))));
}

__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

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

// The tile plan of a launch (host side: plan_analysis, plan_synthesis).
struct AxisTile {
  int last;       // 1: the last axis (a run of rows), 0: a middle axis
  int t;          // positions along the axis per tile
  int tiles;      // tiles along the axis
  int run;        // C columns of inner (middle) or R rows (last)
  int shift;      // log2 C (middle)
  int span;       // K3: window rows W (middle), positions per parity (last)
                  // K4: band rows per band
  int plane;      // K3, last axis: elements from the even plane to the odd
  int64_t runs;   // runs over inner (middle) or over the rows (last)
  int64_t blocks;
};

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

static int pow2_at_least(int64_t v, int cap) {
  int c = 1;
  while (c < cap && c < v) c <<= 1;
  return c;
}

static int log2_of(int c) {
  int s = 0;
  while ((1 << s) < c) ++s;
  return s;
}

// The fewest tiles of at most t_max positions over `len`, balanced;
// `even` rounds the tile up to an even length.
static void balance(AxisTile& tile, int len, int t_max, bool even) {
  tile.tiles = (len + t_max - 1) / t_max;
  tile.t = (len + tile.tiles - 1) / tile.tiles;
  if (even) tile.t += tile.t & 1;
  tile.tiles = (len + tile.t - 1) / tile.t;
}

static size_t plan_analysis(AxisTile& tile, int64_t outer, int m, int64_t inner,
                            int tp, size_t item) {
  tile.last = inner == 1;
  if (tile.last) {
    tile.run = AXIS_ROWS;
    tile.shift = 0;
    tile.runs = (outer + tile.run - 1) / tile.run;
    balance(tile, m, static_cast<int>(1024 / item), false);
    tile.blocks = tile.runs * tile.tiles;
    tile.span = (tile.t + tp - 1 + 1) & ~1;
    tile.plane = tile.run * tile.span + static_cast<int>(AXIS_PLANE_PAD_BYTES / item);
    return item * (tile.plane + static_cast<size_t>(tile.run) * tile.span) +
           sizeof(int) * 2 * tile.span;
  }
  tile.run = pow2_at_least(inner, static_cast<int>(256 / item));
  tile.shift = log2_of(tile.run);
  tile.runs = (inner + tile.run - 1) / tile.run;
  balance(tile, m, static_cast<int>(16384 / item) / tile.run, false);
  tile.blocks = outer * tile.tiles * tile.runs;
  tile.span = 2 * (tile.t + tp - 1);
  tile.plane = 0;
  return item * static_cast<size_t>(tile.span) * tile.run + sizeof(int) * tile.span;
}

static size_t plan_synthesis(AxisTile& tile, int64_t outer, int out_len, int64_t inner,
                             int tp, int groups, size_t item) {
  tile.last = inner == 1;
  tile.plane = 0;
  if (tile.last) {
    tile.run = AXIS_ROWS;
    tile.shift = 0;
    tile.runs = (outer + tile.run - 1) / tile.run;
    balance(tile, out_len, static_cast<int>(2048 / item) / groups, true);
    tile.blocks = tile.runs * tile.tiles;
  } else {
    tile.run = pow2_at_least(inner, static_cast<int>(256 / item));
    tile.shift = log2_of(tile.run);
    tile.runs = (inner + tile.run - 1) / tile.run;
    balance(tile, out_len, static_cast<int>(32768 / item) / (tile.run * groups), true);
    tile.blocks = outer * tile.tiles * tile.runs;
  }
  tile.span = tile.t / 2 + tp;
  return item * 2 * groups * static_cast<size_t>(tile.span) * tile.run +
         sizeof(int) * tile.span;
}

// ---------------------------------------------------------------------------
// K3: analysis (zero-bounded: K4's VJP)
// ---------------------------------------------------------------------------

struct AnaArgs {
  int64_t outer, inner;
  int n, m, period, pad, mode, tp;
};

template <typename T>
__global__ void __launch_bounds__(PTWT_THREADS)
    analysis_axis_kernel(const T* __restrict__ x, T* __restrict__ out,
                         const __grid_constant__ Taps<T> taps, const AxisTile tile,
                         const AnaArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  int* src = reinterpret_cast<int*>(
      xs + (tile.last ? tile.plane + tile.run * tile.span : tile.span * tile.run));
  const int tid = threadIdx.x;
  const int tp = a.tp, run = tile.run;
  const int64_t plane = a.outer * a.m * a.inner;  // lo -> hi in `out`
  for (int64_t blk = blockIdx.x; blk < tile.blocks; blk += gridDim.x) {
    int tile_i;
    int64_t o = 0, lead;  // o: the outer index (middle); lead: first column or row
    if (tile.last) {
      tile_i = static_cast<int>(blk % tile.tiles);
      lead = blk / tile.tiles * run;
    } else {
      const int64_t rest = blk / tile.runs;
      lead = (blk - rest * tile.runs) * run;
      tile_i = static_cast<int>(rest % tile.tiles);
      o = rest / tile.tiles;
    }
    const int i0 = tile_i * tile.t;
    const int n_out = min(tile.t, a.m - i0);
    const int nrun = static_cast<int>(min64(run, (tile.last ? a.outer : a.inner) - lead));
    const int wins = 2 * (n_out + tp - 1);  // staged window positions
    for (int w = tid; w < wins; w += PTWT_THREADS)
      src[w] = source_of(2 * i0 - a.pad + w, a.n, a.period, a.mode);
    __syncthreads();

    if (tile.last) {
      // rows of the run, even positions in plane 0 and odd ones in plane 1
      Walk st(tid, wins);
      for (int e = tid; e < nrun * wins; e += PTWT_THREADS, st.next()) {
        T* dst = xs + (st.col & 1) * tile.plane + st.row * tile.span + (st.col >> 1);
        const int s = src[st.col];
        if (s >= 0)
          copy_async(dst, x + (lead + st.row) * a.n + s);
        else
          *dst = T(0);
      }
    } else {
      // window rows of `run` columns, lanes along inner
      const T* xo = x + o * a.n * a.inner + lead;
      for (int e = tid; e < wins * run; e += PTWT_THREADS) {
        const int w = e >> tile.shift, c = e & (run - 1);
        const int s = src[w];
        if (s >= 0 && c < nrun)
          copy_async(xs + e, xo + static_cast<int64_t>(s) * a.inner + c);
        else
          xs[e] = T(0);
      }
    }
    wait_staged();

    // four outputs per thread; output i reads window positions 2i + k:
    // even position 2j at ev[j * step], odd at ev[j * step + odd]
    const int slots = (tile.last ? nrun : run) * n_out;
    const int step = tile.last ? 1 : 2 * run;
    const int odd = tile.last ? tile.plane : run;
    Walk sl(tid, tile.last ? n_out : run);  // (row, i) or (i, column)
    for (int base = tid; base < slots; base += AXIS_SLOTS * PTWT_THREADS) {
      int at[AXIS_SLOTS], row[AXIS_SLOTS], col[AXIS_SLOTS];
#pragma unroll
      for (int p = 0; p < AXIS_SLOTS; ++p) {
        // slots past the tile repeat the first one and write nothing
        const bool in = base + p * PTWT_THREADS < slots;
        row[p] = in ? sl.row : -1;
        col[p] = in ? sl.col : 0;
        const int r = in ? sl.row : 0, c = in ? sl.col : (tile.last ? 0 : tid & (run - 1));
        at[p] = tile.last ? r * tile.span + c : 2 * r * run + c;
        sl.next();
      }
      T lo[AXIS_SLOTS], hi[AXIS_SLOTS];
#pragma unroll
      for (int p = 0; p < AXIS_SLOTS; ++p) lo[p] = hi[p] = T(0);
      for (int j = 0; j < tp; ++j) {
        const T fl0 = taps.lo[2 * j], fl1 = taps.lo[2 * j + 1];
        const T fh0 = taps.hi[2 * j], fh1 = taps.hi[2 * j + 1];
        const int d = j * step;
#pragma unroll
        for (int p = 0; p < AXIS_SLOTS; ++p) {
          const T ve = xs[at[p] + d], vo = xs[at[p] + d + odd];
          lo[p] += fl0 * ve;
          lo[p] += fl1 * vo;
          hi[p] += fh0 * ve;
          hi[p] += fh1 * vo;
        }
      }
#pragma unroll
      for (int p = 0; p < AXIS_SLOTS; ++p) {
        if (row[p] < 0) continue;
        int64_t at_out;
        if (tile.last) {
          at_out = (lead + row[p]) * a.m + i0 + col[p];
        } else {
          if (col[p] >= nrun) continue;
          at_out = (o * a.m + i0 + row[p]) * a.inner + lead + col[p];
        }
        out[at_out] = lo[p];
        out[plane + at_out] = hi[p];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K4: synthesis (with the fold: K3's VJP)
// ---------------------------------------------------------------------------

template <typename T>
struct BandPairs {
  const T* lo[2];
  const T* hi[2];
};

struct SynArgs {
  int64_t outer, inner;
  int m, out_len, off, circular, tp, len;
  // the fold: mode, period, reach from either end, the band rows its
  // strips hold (the first `head` and the last strip - head, or all m),
  // and the positions outside the axis
  int fold, period, reach, head, strip, outside;
};

template <typename T, int G, bool FOLD>
__global__ void __launch_bounds__(PTWT_THREADS)
    synthesis_axis_kernel(const BandPairs<T> bands, T* __restrict__ out,
                          const __grid_constant__ Taps<T> taps, const AxisTile tile,
                          const SynArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bs = reinterpret_cast<T*>(smem_raw);  // [G][2 (lo, hi)][span][run] or [..][run][span]
  const int run = tile.run, span = tile.span, tp = a.tp;
  const int nb_all = span * run;           // elements of one staged band
  T* strips = bs + 2 * G * nb_all;         // [2 (lo, hi)][strip][run] or [2][run][strip]
  int* srcx = reinterpret_cast<int*>(strips + 2 * a.strip * run);  // [outside]
  int* src = srcx + a.outside;
  const int tid = threadIdx.x;
  const int64_t group = a.outer * a.out_len * a.inner;  // pair -> pair in `out`
  for (int64_t blk = blockIdx.x; blk < tile.blocks; blk += gridDim.x) {
    int tile_t;
    int64_t o = 0, lead;
    if (tile.last) {
      tile_t = static_cast<int>(blk % tile.tiles);
      lead = blk / tile.tiles * run;
    } else {
      const int64_t rest = blk / tile.runs;
      lead = (blk - rest * tile.runs) * run;
      tile_t = static_cast<int>(rest % tile.tiles);
      o = rest / tile.tiles;
    }
    const int t0 = tile_t * tile.t;
    const int n_out = min(tile.t, a.out_len - t0);
    const int nrun = static_cast<int>(min64(run, (tile.last ? a.outer : a.inner) - lead));
    // pairs s0 .. s0 + np - 1 read band rows s0 - tp + 1 .. s0 + np - 1
    const int s0 = (t0 + a.off) >> 1;
    const int np = ((t0 + n_out - 1 + a.off) >> 1) - s0 + 1;
    const int nb = np + tp - 1;
    for (int w = tid; w < nb; w += PTWT_THREADS) {
      const int q = s0 - tp + 1 + w;
      src[w] = a.circular ? mod_pos(q, a.m) : (q >= 0 && q < a.m ? q : -1);
    }
    __syncthreads();

#pragma unroll
    for (int gb = 0; gb < 2 * G; ++gb) {
      const T* band = (gb & 1) ? bands.hi[gb >> 1] : bands.lo[gb >> 1];
      T* dst = bs + gb * nb_all;
      if (tile.last) {
        Walk st(tid, nb);
        for (int e = tid; e < nrun * nb; e += PTWT_THREADS, st.next()) {
          const int s = src[st.col];
          T* d = dst + st.row * span + st.col;
          if (s >= 0)
            copy_async(d, band + (lead + st.row) * a.m + s);
          else
            *d = T(0);
        }
      } else {
        const T* bo = band + o * a.m * a.inner + lead;
        for (int e = tid; e < nb * run; e += PTWT_THREADS) {
          const int w = e >> tile.shift, c = e & (run - 1);
          const int s = src[w];
          if (s >= 0 && c < nrun)
            copy_async(dst + e, bo + static_cast<int64_t>(s) * a.inner + c);
          else
            dst[e] = T(0);
        }
      }
    }
    // the fold (K3's VJP) in tiles with outputs within `reach` of either
    // end (zone A from t0, zone B from b0): the sources of the positions
    // outside [0, out_len) and strips of the band rows their y[p] read are
    // staged with the window; after the tap loop, one thread per output
    // and lane of the run adds y[p] over the positions whose source is
    // that output
    int za = 0, zb = 0, b0 = 0;
    if constexpr (FOLD) {
      const int t_end = t0 + n_out;
      za = max(0, min(t_end, a.reach) - t0);
      b0 = max(t0 + za, a.out_len - a.reach);
      zb = max(0, t_end - b0);
      if (za + zb) {
        for (int x = tid; x < a.outside; x += PTWT_THREADS)
          srcx[x] = source_of(x < a.off ? x - a.off : a.out_len + x - a.off, a.out_len,
                              a.period, a.fold);
        const int per_band = a.strip * run;
        for (int e = tid; e < 2 * per_band; e += PTWT_THREADS) {
          const int b = e >= per_band, rem = e - b * per_band;
          const T* band = b ? bands.hi[0] : bands.lo[0];
          int j, r;
          if (tile.last) {
            r = rem / a.strip;
            j = rem - r * a.strip;
          } else {
            j = rem >> tile.shift;
            r = rem & (run - 1);
          }
          const int q = j < a.head ? j : a.m - a.strip + j;
          if (r < nrun)
            copy_async(strips + e, band + (tile.last ? (lead + r) * a.m + q
                                                     : (o * a.m + q) * a.inner + lead + r));
          else
            strips[e] = T(0);
        }
      }
    }
    wait_staged();

    // four output pairs per thread: pair s reads staged band row
    // s - s0 + tp - 1 - j with taps 2j (even output) and 2j + 1 (odd)
    const int slots = (tile.last ? nrun : run) * np;
    const int step = tile.last ? 1 : run;
    Walk sl(tid, tile.last ? np : run);  // (row, pair) or (pair, column)
    for (int base = tid; base < slots; base += AXIS_SLOTS * PTWT_THREADS) {
      int at[AXIS_SLOTS], row[AXIS_SLOTS], col[AXIS_SLOTS];
#pragma unroll
      for (int p = 0; p < AXIS_SLOTS; ++p) {
        const bool in = base + p * PTWT_THREADS < slots;
        row[p] = in ? sl.row : -1;
        col[p] = in ? sl.col : 0;
        const int r = in ? sl.row : 0, c = in ? sl.col : (tile.last ? 0 : tid & (run - 1));
        at[p] = tile.last ? r * span + c + tp - 1 : (r + tp - 1) * run + c;
        sl.next();
      }
      T ev[G][AXIS_SLOTS], od[G][AXIS_SLOTS];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int p = 0; p < AXIS_SLOTS; ++p) ev[g][p] = od[g][p] = T(0);
      for (int j = 0; j < tp; ++j) {
        const T le = taps.lo[2 * j], lo_ = taps.lo[2 * j + 1];
        const T he = taps.hi[2 * j], ho = taps.hi[2 * j + 1];
        const int d = j * step;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const T* bl = bs + 2 * g * nb_all;
          const T* bh = bl + nb_all;
#pragma unroll
          for (int p = 0; p < AXIS_SLOTS; ++p) {
            const T vl = bl[at[p] - d], vh = bh[at[p] - d];
            ev[g][p] += le * vl;
            ev[g][p] += he * vh;
            od[g][p] += lo_ * vl;
            od[g][p] += ho * vh;
          }
        }
      }
      const int t_end = t0 + n_out;
#pragma unroll
      for (int p = 0; p < AXIS_SLOTS; ++p) {
        if (row[p] < 0) continue;
        const int pair = tile.last ? col[p] : row[p];
        const int c = tile.last ? 0 : col[p];
        if (!tile.last && c >= nrun) continue;
        const int t = 2 * (s0 + pair) - a.off;  // the even output; t + 1 the odd
        const bool e_ok = t >= t0 && t < t_end;
        const bool o_ok = t + 1 >= t0 && t + 1 < t_end;
        const int64_t lane = tile.last ? lead + row[p] : lead + c;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          T even = ev[g][p], oddv = od[g][p];
          if (tile.last) {
            T* dst = out + g * group + lane * a.out_len + t;
            if (e_ok) dst[0] = even;
            if (o_ok) dst[1] = oddv;
          } else {
            T* dst = out + g * group + (o * a.out_len + t) * a.inner + lane;
            if (e_ok) dst[0] = even;
            if (o_ok) dst[a.inner] = oddv;
          }
        }
      }
    }
    if constexpr (FOLD) {
      const int z = za + zb;
      if (z) {
        __syncthreads();  // the block's outputs are written and visible to it
        const int per_band = a.strip * run;
        for (int e = tid; e < (tile.last ? nrun : run) * z; e += PTWT_THREADS) {
          int r, zi;
          if (tile.last) {
            r = e / z;
            zi = e - r * z;
          } else {
            zi = e >> tile.shift;
            r = e & (run - 1);
            if (r >= nrun) continue;
          }
          const int u = zi < za ? t0 + zi : b0 + zi - za;
          // strip row j of lane r at sl[j * js]
          const T* sl = strips + (tile.last ? r * a.strip : r);
          const int js = tile.last ? 1 : run;
          T acc = T(0);
          for (int x = 0; x < a.outside; ++x) {
            if (srcx[x] != u) continue;
            // y[p]: taps k of f = p + off's parity, band row (f - k) / 2 in [0, m)
            const int f = x < a.off ? x : a.out_len + x;
            const int k_hi = min(a.len - 1, f);
            for (int k = max(f & 1, f - 2 * (a.m - 1)); k <= k_hi; k += 2) {
              const int q = (f - k) >> 1;
              const int at = (q < a.head ? q : q - a.m + a.strip) * js;
              acc += taps.lo[k] * sl[at] + taps.hi[k] * sl[per_band + at];
            }
          }
          T* dst = out + (tile.last ? (lead + r) * a.out_len + u
                                    : (o * a.out_len + u) * a.inner + lead + r);
          *dst += acc;
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// KT: the filter taps' gradient of a K3 or K4 launch
// ---------------------------------------------------------------------------

// KT replaces no Pallas kernel: the JAX package keeps a traced filter bank
// off its kernels and lets XLA differentiate its slices route, while the
// port keeps such a bank's data on K3/K4 and differentiates the taps here.
// One contract serves both directions:
//
//   g_f[k] = sum over (o, j, c) of band_f[o, j, c] * x[o, src(2j + k - pad), c]
//
// for the two filters f (lo, hi) and every tap k < len, src() being K3's
// source_of map.  For K3's (dec) taps, x is the level's input, pad, mode
// and period are K3's, and the bands are the cotangents of its (lo, hi)
// output.  For K4's (rec) taps, x is the output cotangent of a K4 launch
// (its G pairs folded into `outer`), pad = off, the mode zero (or, for
// periodization, modulo 2m with zeros past out_len: the crop is an offset
// into the uncropped frame), and the bands are the launch's (lo, hi)
// inputs, pair g's rows under x's rows of group g.
//
// Bound on the H100: bytes for short banks (x and the bands read once, 4
// bytes a float32 element against 2 len float64 multiply-adds per band
// element: db4 moves its 131.5 MB at the headline's level 1 in 0.039 ms,
// its 135 M multiply-adds take 0.008 ms at the float64 peak); operations
// past some 40 taps.  The products are exact in float64 (float32 x
// float32), so the sums are float64 whatever the input type.  The cost
// to avoid is everything around the multiply-adds: a float32 value
// converted to float64, and read from shared memory, once per tap that
// uses it.  So:
//
// * A lane walks consecutive band positions j of one column (middle axis)
//   or of one row (last axis), keeping the window of x that tap chunk
//   [cK, cK + K) reads (positions 2j + cK + [0, K)) in K float64
//   registers: each step reads and converts two new window values and the
//   two band values once and adds 2K products into 2K float64
//   accumulators (registers; the step loop is unrolled K / 2 times, so
//   the window is a ring of registers with no moves and no index
//   arithmetic).  K is 4, 8, 12 or 16 (the shortest that holds the bank,
//   16 past 16 taps); a bank of more than K taps runs ceil(len / K) warps,
//   one chunk each, over the same staged tile.
// * Middle axis: a warp's lanes are 32 neighbouring columns; a tile is t
//   band positions (a multiple of K / 2) of them, the window rows
//   [position][32] (conflict-free, coalesced), staged 16 bytes a lane
//   where the rows allow it.  Within a run of columns the window
//   registers carry over from tile to tile, so a tile stages only its 2t
//   new window rows.
// * Last axis: a warp takes one row a tile, each lane an odd run of
//   `lane` band positions (32 runs side by side), so the window, 2t + K - 2
//   positions, and the band runs are each one contiguous stretch of the
//   row: staged 16 bytes a lane (the run shifted to the alignment) where
//   it lies inside the row, else element by element through the mode's
//   map.  Lanes read the window 2 lane apart and the bands `lane` apart:
//   an odd run puts the bands on 32 banks, the window on 16 (two-way).
//   The runs start afresh each tile (K - 2 window reads).
// * A block (one warp per chunk) owns an equal, contiguous range of the
//   flattened (column run or row, j) positions and walks it in tiles,
//   staged by cp.async into a two-stage ring: the next tile loads while
//   the current one sums.  Tiles are as long as two stages fit
//   TAP_WARP_SMEM a warp, so some 20 one-warp blocks share an SM.
// * The grid is the blocks that fit on the card at once (the occupancy
//   of this build times the SM count), capped by `cap` and by one tile a
//   block.  Each block writes its 2 len sums (each warp's lanes added in
//   a fixed butterfly) to its row of `partial`, and a second launch adds
//   the rows in a fixed tree: no atomics.  The order of the sums depends
//   on the shapes and on the device (its SM count and this build's
//   occupancy), never on the run, so two launches give the same bits.

#define TAP_WARP_SMEM 8192  // staged bytes a warp may hold (both stages)
#define TAP_LANES 32

struct TapArgs {
  int64_t outer, inner;  // outer: rows of one pair (K4's taps) or of x
  int groups, n, m, period, pad, mode, len;
};

// The tile plan of a KT launch.
struct TapPlan {
  int chunks;       // warps of a block, one tap chunk each
  int t;            // band positions per tile (middle axis: a multiple of K / 2)
  int lane;         // last axis: band positions a lane walks per tile (odd), t / 32
  int vec;          // x from an aligned array (middle axis: rows of 16-byte multiples
                    // and the bands too): staged 16 bytes a lane
  int bvec;         // last axis: the bands from aligned arrays
  int win, band;    // elements of a stage's window and of each band tile
  int64_t groups;   // lane groups: (row, 32 columns) on a middle axis, rows on the last
  int64_t total;    // groups * m band positions, split evenly over the blocks
};

static int tap_chunk(int len) { return len <= 4 ? 4 : len <= 8 ? 8 : len <= 12 ? 12 : 16; }

// Stage sizes for tiles of t band positions (on the last axis t = 32 lane,
// each run with 32 bytes of slack for an aligned copy's shift and rounded
// to 16 bytes).
static size_t tap_stage(TapPlan& p, bool last, int t, int kc, size_t item) {
  const int vw = static_cast<int>(16 / item);
  const auto round = [vw](int e) { return (e + vw - 1) / vw * vw; };
  p.t = t;
  p.win = last ? round(2 * t + kc - 2 + 2 * vw) : TAP_LANES * (2 * t + kc - 2);
  p.band = last ? round(t + 2 * vw) : TAP_LANES * t;
  return 2 * item * (p.win + 2 * static_cast<size_t>(p.band));
}

static size_t plan_taps(TapPlan& p, int64_t rows, int m, int64_t inner, int len, size_t item) {
  const bool last = inner == 1;
  const int k = tap_chunk(len), u = k / 2;
  p.chunks = (len + k - 1) / k;
  const int kc = p.chunks * k;
  p.groups = last ? rows : rows * ((inner + TAP_LANES - 1) / TAP_LANES);
  p.total = p.groups * m;
  const size_t budget = static_cast<size_t>(TAP_WARP_SMEM) * p.chunks;
  p.lane = 0;
  if (last) {
    // the longest odd run a lane that fits, then balanced over a row's tiles
    int lane = 1;
    while (tap_stage(p, true, TAP_LANES * (lane + 2), kc, item) <= budget) lane += 2;
    const int tiles = (m + TAP_LANES * lane - 1) / (TAP_LANES * lane);
    p.lane = ((m + TAP_LANES * tiles - 1) / (TAP_LANES * tiles)) | 1;
    return tap_stage(p, true, TAP_LANES * p.lane, kc, item);
  }
  const int t_cap = (m + u - 1) / u * u;
  int t = u;
  while (t + u <= t_cap && tap_stage(p, false, t + u, kc, item) <= budget) t += u;
  return tap_stage(p, false, t, kc, item);
}

// One tile of a block's range: lane group s, band positions [j0, j0 + n),
// window positions staged from h0 on (relative to 2 j0 - pad): 0 where a
// range starts, K - 2 where the registers carry the window over.
struct TapTile {
  int64_t s;
  int j0, n, h0;
  int sh, bsh;  // last axis: where the staged window and bands start in their tiles
};

__device__ __forceinline__ TapTile first_tap_tile(int64_t f0, int64_t f1, int m, int t) {
  TapTile tl;
  tl.s = f0 / m;
  tl.j0 = static_cast<int>(f0 - tl.s * m);
  tl.n = static_cast<int>(min64(min64(t, m - tl.j0), f1 - f0));
  tl.h0 = tl.sh = tl.bsh = 0;
  return tl;
}

// Advances to the next tile of [.., f1); false past the range's end.
// `carry`: the window positions the registers hold over (K - 2, or 0).
__device__ __forceinline__ bool next_tap_tile(TapTile& tl, int64_t f1, int m, int t, int carry) {
  const int64_t f = tl.s * m + tl.j0 + tl.n;
  if (f >= f1) return false;
  if (tl.j0 + tl.n == m) {  // a new lane group: its window starts afresh
    ++tl.s;
    tl.j0 = 0;
    tl.h0 = 0;
  } else {  // after a whole tile: the registers hold `carry` window positions
    tl.j0 += tl.n;
    tl.h0 = carry;
  }
  tl.n = static_cast<int>(min64(min64(t, m - tl.j0), f1 - f));
  tl.sh = tl.bsh = 0;
  return true;
}

// cp.async of 16 bytes, through L2 only.
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src));
}

// A lane's copy of VW neighbouring elements: 16 bytes, or one element.
template <int VW, typename T>
__device__ __forceinline__ void copy_run(T* dst, const T* src) {
  if constexpr (VW == 1)
    copy_async(dst, src);
  else
    copy_async16(dst, src);
}

// A middle axis's tile: each lane copies VW neighbouring columns of a
// position row (VW = 1, or 16 bytes where every row and pointer is
// aligned), so a warp stages VW rows of 32 columns a copy.
template <typename T, int VW>
__device__ __forceinline__ void stage_tap_rows(T* win, T* bl, T* bh, const TapTile& tl,
                                               const T* __restrict__ x,
                                               const BandPairs<T>& bands, const TapArgs& a,
                                               int span, int p0) {
  constexpr int PER_ROW = TAP_LANES / VW;  // lanes a position row takes
  const int tid = threadIdx.x, step = blockDim.x / PER_ROW;
  const int64_t runs = (a.inner + TAP_LANES - 1) / TAP_LANES;
  const int64_t o = tl.s / runs;
  const int c = (tid % PER_ROW) * VW;  // the first column within the run
  const int64_t col = (tl.s - o * runs) * TAP_LANES + c;
  const bool live = col < a.inner;  // VW divides inner: all VW columns or none
  const T* xo = x + o * a.n * a.inner + col;
#pragma unroll 4
  for (int r = tid / PER_ROW; r < span; r += step) {
    T* dst = win + r * TAP_LANES + c;
    const int q = source_of(p0 + r, a.n, a.period, a.mode);
    if (live && q >= 0) {
      copy_run<VW>(dst, xo + static_cast<int64_t>(q) * a.inner);
    } else {
#pragma unroll
      for (int v = 0; v < VW; ++v) dst[v] = T(0);
    }
  }
  const bool g = o >= a.outer;
  const int64_t at = ((o - g * a.outer) * a.m + tl.j0) * a.inner + col;
  const T* lo = (g ? bands.lo[1] : bands.lo[0]) + at;
  const T* hi = (g ? bands.hi[1] : bands.hi[0]) + at;
#pragma unroll 4
  for (int j = tid / PER_ROW; j < tl.n; j += step) {
    const int e = j * TAP_LANES + c;
    if (live) {
      copy_run<VW>(bl + e, lo + static_cast<int64_t>(j) * a.inner);
      copy_run<VW>(bh + e, hi + static_cast<int64_t>(j) * a.inner);
    } else {
#pragma unroll
      for (int v = 0; v < VW; ++v) bl[e + v] = bh[e + v] = T(0);
    }
  }
}

// The last axis: `len` elements of the row that starts `row` elements into
// `base` (of `total`), from position `p0` (its source map `src`), into
// `dst`.  16 bytes a lane where `vec` (an aligned base, a run inside the
// row) and the aligned chunks stay inside the array: the run then starts
// shift = (row + p0) % (16 / item) elements into `dst`, which is returned.
// Else one element a lane.
template <typename T, typename Src>
__device__ __forceinline__ int stage_tap_line(T* dst, const T* base, int64_t row, int p0, int len,
                                              bool vec, int64_t total, Src src) {
  constexpr int VW = 16 / sizeof(T);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int64_t at = row + p0;
  const int shift = static_cast<int>(at % VW), chunks = (shift + len + VW - 1) / VW;
  if (vec && at - shift + static_cast<int64_t>(chunks) * VW <= total) {
    for (int i = tid; i < chunks; i += nthreads)
      copy_async16(dst + i * VW, base + at - shift + i * VW);
    return shift;
  }
#pragma unroll 4
  for (int c = tid; c < len; c += nthreads) {
    const int q = src(p0 + c);
    if (q >= 0)
      copy_async(dst + c, base + row + q);
    else
      dst[c] = T(0);
  }
  return 0;
}

// Stages a tile's window (relative positions [h0, 2n + kc - 2), through the
// mode's map) and its band tiles into `st`, zeros where a lane has no
// column or row or a position reads zero.
template <typename T, bool LAST>
__device__ __forceinline__ void stage_tap_tile(T* st, TapTile& tl, const T* __restrict__ x,
                                               const BandPairs<T>& bands, const TapPlan& p,
                                               const TapArgs& a, int kc) {
  T* win = st;
  T* bl = st + p.win;
  T* bh = bl + p.band;
  const int span = 2 * tl.n + kc - 2 - tl.h0;
  const int p0 = 2 * tl.j0 - a.pad + tl.h0;  // the first staged position
  if constexpr (!LAST) {
    if (p.vec)
      stage_tap_rows<T, 16 / sizeof(T)>(win, bl, bh, tl, x, bands, a, span, p0);
    else
      stage_tap_rows<T, 1>(win, bl, bh, tl, x, bands, a, span, p0);
  } else {
    // one row: the window (16 bytes a lane where its run lies inside the
    // row), then the bands
    const int64_t rows = a.groups * a.outer;
    tl.sh = stage_tap_line(win, x, tl.s * a.n, p0, span, p.vec && p0 >= 0 && p0 + span <= a.n,
                           rows * a.n,
                           [&](int q) { return source_of(q, a.n, a.period, a.mode); });
    const bool g = tl.s >= a.outer;
    const int64_t at = (tl.s - g * a.outer) * a.m;
    const auto all = [](int q) { return q; };
    stage_tap_line(bl, g ? bands.lo[1] : bands.lo[0], at, tl.j0, tl.n, p.bvec, a.outer * a.m, all);
    tl.bsh = stage_tap_line(bh, g ? bands.hi[1] : bands.hi[0], at, tl.j0, tl.n, p.bvec,
                            a.outer * a.m, all);
  }
}

// Step u (0 <= u < K / 2, a constant once unrolled) of a group of K / 2
// steps: wp reads the window at the group's first step, b0/b1 its band
// values.  Slot (2u + k) % K holds window position 2j + k of this step.
template <typename T, int K, int RS>
__device__ __forceinline__ void tap_step(double (&w)[K], double (&lo)[K], double (&hi)[K],
                                         const T* wp, const T* bl, const T* bh, int u) {
  w[(2 * u + K - 2) % K] = static_cast<double>(wp[(2 * u + K - 2) * RS]);
  w[(2 * u + K - 1) % K] = static_cast<double>(wp[(2 * u + K - 1) * RS]);
  const double b0 = static_cast<double>(bl[u * RS]);
  const double b1 = static_cast<double>(bh[u * RS]);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lo[k] = fma(b0, w[(2 * u + k) % K], lo[k]);
    hi[k] = fma(b1, w[(2 * u + k) % K], hi[k]);
  }
}

template <typename T, int K, bool LAST>
__global__ void __launch_bounds__(PTWT_THREADS)
    tap_grad_kernel(const T* __restrict__ x, const BandPairs<T> bands,
                    double* __restrict__ partial, const TapPlan p, const TapArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int U = K / 2;
  constexpr int RS = LAST ? 1 : TAP_LANES;  // elements between neighbouring positions
  T* const stage0 = reinterpret_cast<T*>(smem_raw);
  const int stage = p.win + 2 * p.band;  // elements of one stage
  const int lane = threadIdx.x & (TAP_LANES - 1), chunk = threadIdx.x >> 5;
  const int kc = p.chunks * K;
  const int64_t f0 = blockIdx.x * p.total / gridDim.x;
  const int64_t f1 = (blockIdx.x + 1) * p.total / gridDim.x;
  double w[K], lo[K], hi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = lo[k] = hi[k] = 0.0;

  TapTile tl = first_tap_tile(f0, f1, a.m, p.t);
  if (f0 < f1) stage_tap_tile<T, LAST>(stage0, tl, x, bands, p, a, kc);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int buf = 0; f0 < f1; buf ^= 1) {
    TapTile nx = tl;
    const bool more = next_tap_tile(nx, f1, a.m, p.t, LAST ? 0 : K - 2);
    if (more) stage_tap_tile<T, LAST>(stage0 + (buf ^ 1) * stage, nx, x, bands, p, a, kc);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    // this lane's first band position in the tile and its steps: a middle
    // axis's lane walks its column through the whole tile, a last axis's
    // lane a run of p.lane positions of the row
    const int j_lane = LAST ? lane * p.lane : 0;
    const int steps = LAST ? max(0, min(p.lane, tl.n - j_lane)) : tl.n;
    const T* st = stage0 + buf * stage;
    const T* wp = st + (LAST ? tl.sh + 2 * j_lane : lane) + (chunk * K - tl.h0) * RS;
    const T* bl = st + p.win + (LAST ? tl.bsh + j_lane : lane);
    const T* bh = bl + p.band;
    if (tl.h0 == 0) {  // a run starts: the first K - 2 window positions
#pragma unroll
      for (int i = 0; i < K - 2; ++i) w[i] = static_cast<double>(wp[i * RS]);
    }
    int j = 0;
    for (; j + U <= steps; j += U) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        tap_step<T, K, RS>(w, lo, hi, wp + 2 * j * RS, bl + j * RS, bh + j * RS, u);
    }
    // a run's last tile only: the next tile (if any) starts afresh
#pragma unroll
    for (int u = 0; u < U - 1; ++u)
      if (j + u < steps) tap_step<T, K, RS>(w, lo, hi, wp + 2 * j * RS, bl + j * RS, bh + j * RS, u);
    __syncthreads();
    if (!more) break;
    tl = nx;
  }

  const int sums = 2 * a.len;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double vl = lo[k], vh = hi[k];
#pragma unroll
    for (int off = TAP_LANES / 2; off > 0; off >>= 1) {
      vl += __shfl_xor_sync(0xffffffffu, vl, off);
      vh += __shfl_xor_sync(0xffffffffu, vh, off);
    }
    const int tap = chunk * K + k;
    if (lane == 0 && tap < a.len) {
      partial[static_cast<int64_t>(blockIdx.x) * sums + tap] = vl;
      partial[static_cast<int64_t>(blockIdx.x) * sums + a.len + tap] = vh;
    }
  }
}

// out[s] = the sum over the `blocks` rows of partial[., s], in a fixed tree.
__global__ void __launch_bounds__(PTWT_THREADS)
    tap_reduce_kernel(const double* __restrict__ partial, int blocks, int sums,
                      double* __restrict__ out) {
  __shared__ double red[PTWT_THREADS];
  const int s = blockIdx.x, tid = threadIdx.x;
  double acc = 0.0;
  for (int b = tid; b < blocks; b += PTWT_THREADS)
    acc += partial[static_cast<int64_t>(b) * sums + s];
  red[tid] = acc;
  __syncthreads();
  for (int half = PTWT_THREADS / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  if (tid == 0) out[s] = red[0];
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

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
static int launch_analysis(const void* x, void* out, const double* lo, const double* hi,
                           int len, long long outer, int n, int period, int m,
                           long long inner, int pad, int mode, cudaStream_t stream) {
  AnaArgs a{outer, inner, n, m, period, pad, mode, (len + 1) / 2};
  AxisTile tile;
  const size_t smem = plan_analysis(tile, outer, m, inner, a.tp, sizeof(T));
  if (smem > AXIS_SMEM_MAX) return PTWT_BAD_ARGUMENT;
  auto kernel = analysis_axis_kernel<T>;
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<grid_of(tile.blocks), PTWT_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), make_taps<T>(lo, hi, len), tile, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, bool FOLD>
static int launch_synthesis_as(const BandPairs<T>& bands, T* out, const Taps<T>& taps,
                               const AxisTile& tile, const SynArgs& a, size_t smem,
                               cudaStream_t stream) {
  auto kernel = synthesis_axis_kernel<T, G, FOLD>;
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<grid_of(tile.blocks), PTWT_THREADS, smem, stream>>>(bands, out, taps, tile, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_synthesis(const void* lo0, const void* hi0, const void* lo1,
                            const void* hi1, int groups, void* out, const double* rlo,
                            const double* rhi, int len, long long outer, int m,
                            int out_len, long long inner, int off, int circular,
                            int fold, int period, cudaStream_t stream) {
  BandPairs<T> bands;
  bands.lo[0] = static_cast<const T*>(lo0);
  bands.hi[0] = static_cast<const T*>(hi0);
  bands.lo[1] = static_cast<const T*>(groups > 1 ? lo1 : lo0);
  bands.hi[1] = static_cast<const T*>(groups > 1 ? hi1 : hi0);
  const int p_end = 2 * (m - 1) + len - 1 - off;
  const int reach = (off > p_end - out_len + 1 ? off : p_end - out_len + 1) + 1;
  SynArgs a{outer, inner, m, out_len, off, circular, (len + 1) / 2, len,
            fold, period, reach, 0, 0, 0};
  AxisTile tile;
  size_t smem = plan_synthesis(tile, outer, out_len, inner, a.tp, groups, sizeof(T));
  if (fold != AXIS_ZERO) {
    // the positions outside [0, out_len), [-off, 0) and [out_len, p_end],
    // read band rows [0, head) and [m - tail, m)
    a.outside = off + (p_end >= out_len ? p_end - out_len + 1 : 0);
    a.head = off > 0 ? ((off - 1) >> 1) + 1 : 0;
    const int q_min = (out_len + off - len + 2) >> 1;  // ceil((out_len + off - len + 1) / 2)
    const int tail = p_end >= out_len ? m - (q_min > 0 ? q_min : 0) : 0;
    if (a.head > m) a.head = m;
    a.strip = a.head + tail < m ? a.head + tail : m;
    smem += sizeof(T) * static_cast<size_t>(tile.run) * 2 * a.strip + sizeof(int) * a.outside;
  }
  if (smem > AXIS_SMEM_MAX) return PTWT_BAD_ARGUMENT;
  const Taps<T> taps = make_taps<T>(rlo, rhi, len);
  T* dst = static_cast<T*>(out);
  if (fold != AXIS_ZERO)
    return launch_synthesis_as<T, 1, true>(bands, dst, taps, tile, a, smem, stream);
  if (groups == 2)
    return launch_synthesis_as<T, 2, false>(bands, dst, taps, tile, a, smem, stream);
  return launch_synthesis_as<T, 1, false>(bands, dst, taps, tile, a, smem, stream);
}

template <typename T, int K, bool LAST>
static int launch_tap_plan(const T* x, const BandPairs<T>& bands, double* out, double* partial,
                           int cap, const TapPlan& p, const TapArgs& a, size_t smem,
                           cudaStream_t stream) {
  auto kernel = tap_grad_kernel<T, K, LAST>;
  if (int err = set_smem(kernel, smem)) return err;
  const int threads = TAP_LANES * p.chunks;
  int dev = 0, sms = 0, per_sm = 0;
  if (int err = static_cast<int>(cudaGetDevice(&dev))) return err;
  if (int err = static_cast<int>(
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  if (int err = static_cast<int>(
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)))
    return err;
  // the blocks the card holds at once, at most `cap` and one tile each
  const int64_t resident = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = static_cast<int>(min64(min64(cap, resident), (p.total + p.t - 1) / p.t));
  kernel<<<blocks, threads, smem, stream>>>(x, bands, partial, p, a);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  tap_reduce_kernel<<<2 * a.len, PTWT_THREADS, 0, stream>>>(partial, blocks, 2 * a.len, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool LAST>
static int launch_tap_chunk(const T* x, const BandPairs<T>& bands, double* out, double* partial,
                            int cap, const TapPlan& p, const TapArgs& a, size_t smem,
                            cudaStream_t stream) {
  switch (tap_chunk(a.len)) {
    case 4:
      return launch_tap_plan<T, 4, LAST>(x, bands, out, partial, cap, p, a, smem, stream);
    case 8:
      return launch_tap_plan<T, 8, LAST>(x, bands, out, partial, cap, p, a, smem, stream);
    case 12:
      return launch_tap_plan<T, 12, LAST>(x, bands, out, partial, cap, p, a, smem, stream);
    default:
      return launch_tap_plan<T, 16, LAST>(x, bands, out, partial, cap, p, a, smem, stream);
  }
}

template <typename T>
static int launch_taps(const void* x, const void* lo0, const void* hi0, const void* lo1,
                       const void* hi1, int groups, double* out, double* partial, int cap,
                       int len, long long outer, int n, int period, int m, long long inner,
                       int pad, int mode, cudaStream_t stream) {
  BandPairs<T> bands;
  bands.lo[0] = static_cast<const T*>(lo0);
  bands.hi[0] = static_cast<const T*>(hi0);
  bands.lo[1] = static_cast<const T*>(groups > 1 ? lo1 : lo0);
  bands.hi[1] = static_cast<const T*>(groups > 1 ? hi1 : hi0);
  TapArgs a{outer, inner, groups, n, m, period, pad, mode, len};
  TapPlan p;
  const size_t smem = plan_taps(p, groups * static_cast<int64_t>(outer), m, inner, len,
                                sizeof(T));
  // 16-byte copies from aligned arrays (on a middle axis, rows of a
  // multiple of 16 bytes too)
  const auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const int vw = static_cast<int>(16 / sizeof(T));
  const bool bands_aligned = aligned(bands.lo[0]) && aligned(bands.hi[0]) &&
                             aligned(bands.lo[1]) && aligned(bands.hi[1]);
  p.vec = aligned(x) && (inner == 1 || (inner % vw == 0 && bands_aligned));
  p.bvec = inner == 1 && bands_aligned;
  if (smem > AXIS_SMEM_MAX) return PTWT_BAD_ARGUMENT;
  const T* xs = static_cast<const T*>(x);
  if (inner == 1)
    return launch_tap_chunk<T, true>(xs, bands, out, partial, cap, p, a, smem, stream);
  return launch_tap_chunk<T, false>(xs, bands, out, partial, cap, p, a, smem, stream);
}

// dtype: 0 = float32, 1 = float64.  Returns a cudaError_t after the launch,
// or PTWT_BAD_ARGUMENT.  x is the unpadded [outer, n, inner] input, out
// the [2, outer, m, inner] bands; `mode` is one of the AXIS_* codes, and
// `period` the circular modes' period (at least n).
extern "C" int ptwt_analysis_axis(int dtype, const void* x, void* out, const double* lo,
                                  const double* hi, int len, long long outer, int n,
                                  int period, int m, long long inner, int pad, int mode,
                                  void* stream) {
  const bool wraps = mode == AXIS_WRAP || mode == AXIS_WRAP_ZERO;
  if (len < 1 || len > PTWT_MAX_TAPS || outer < 1 || inner < 1 || n < 1 || m < 1 ||
      pad < 0 || mode < 0 || mode >= AXIS_MODES || (wraps && period < n))
    return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_analysis<float>(x, out, lo, hi, len, outer, n, period, m, inner, pad,
                                  mode, s);
  if (dtype == 1)
    return launch_analysis<double>(x, out, lo, hi, len, outer, n, period, m, inner, pad,
                                   mode, s);
  return PTWT_BAD_ARGUMENT;
}

// out is [groups, outer, out_len, inner].  circular = 1 reads the bands
// modulo m (periodization).  `fold` (an AXIS_* code; AXIS_ZERO: none) and
// `period` make the launch K3's VJP: the bands are the cotangent of a K3
// launch with pad = off on an axis of out_len samples, and every output
// also collects the extended positions that map onto it.
extern "C" int ptwt_synthesis_axis(int dtype, const void* lo0, const void* hi0,
                                   const void* lo1, const void* hi1, int groups, void* out,
                                   const double* rlo, const double* rhi, int len,
                                   long long outer, int m, int out_len, long long inner,
                                   int off, int circular, int fold, int period,
                                   void* stream) {
  const bool wraps = fold == AXIS_WRAP || fold == AXIS_WRAP_ZERO;
  if (groups < 1 || groups > 2 || len < 1 || len > PTWT_MAX_TAPS || outer < 1 ||
      inner < 1 || m < 1 || out_len < 1 || off < 0 || fold < 0 || fold >= AXIS_MODES ||
      (fold != AXIS_ZERO && (circular || groups != 1)) || (wraps && period < out_len))
    return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_synthesis<float>(lo0, hi0, lo1, hi1, groups, out, rlo, rhi, len, outer,
                                   m, out_len, inner, off, circular, fold, period, s);
  if (dtype == 1)
    return launch_synthesis<double>(lo0, hi0, lo1, hi1, groups, out, rlo, rhi, len, outer,
                                    m, out_len, inner, off, circular, fold, period, s);
  return PTWT_BAD_ARGUMENT;
}

// KT.  x is [groups, outer, n, inner] (groups 1 for K3's taps), band pair g
// [outer, m, inner]; out is the [2, len] float64 gradient (lo taps, then
// hi), partial [cap, 2 len] float64 scratch.  `mode` and `period` are
// K3's (the AXIS_* codes).
extern "C" int ptwt_tap_grad(int dtype, const void* x, const void* lo0, const void* hi0,
                             const void* lo1, const void* hi1, int groups, void* out,
                             void* partial, int cap, int len, long long outer, int n,
                             int period, int m, long long inner, int pad, int mode,
                             void* stream) {
  const bool wraps = mode == AXIS_WRAP || mode == AXIS_WRAP_ZERO;
  if (groups < 1 || groups > 2 || len < 1 || len > PTWT_MAX_TAPS || cap < 1 || outer < 1 ||
      inner < 1 || n < 1 || m < 1 || pad < 0 || mode < 0 || mode >= AXIS_MODES ||
      (wraps && period < n))
    return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* o = static_cast<double*>(out);
  double* p = static_cast<double*>(partial);
  if (dtype == 0)
    return launch_taps<float>(x, lo0, hi0, lo1, hi1, groups, o, p, cap, len, outer, n,
                              period, m, inner, pad, mode, s);
  if (dtype == 1)
    return launch_taps<double>(x, lo0, hi0, lo1, hi1, groups, o, p, cap, len, outer, n,
                               period, m, inner, pad, mode, s);
  return PTWT_BAD_ARGUMENT;
}
