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
// Bound on the H100: bytes (x and the bands read once; the 2 len sums are
// a few bytes).  A block owns tiles of t band positions times a run of the
// fastest index, as K3 does (64 columns of inner in float32, 32 in
// float64, on a middle axis; 16 rows on the last axis), stages the tile's
// window of x (2t + len - 2 positions, through the mode's map) and its
// band tiles into shared memory, and accumulates: thread (s, lane) sums
// the products of sum s = f len + k over the tile's elements lane, lane +
// lanes, ... in float64, for float32 inputs too (a tap sums ~10^7 products
// at the headline).  Blocks walk their tiles in a fixed order over a grid
// of at most `cap` blocks; each writes its 2 len sums to its row of
// `partial` (lanes added in order), and a second launch adds the rows in a
// fixed tree: no atomics, so the result is the same bit for bit from run
// to run.

struct TapArgs {
  int64_t outer, inner;  // outer: rows of one pair (K4's taps) or of x
  int groups, n, m, period, pad, mode, len;
};

static size_t plan_taps(AxisTile& tile, int64_t rows, int m, int64_t inner, int len,
                        size_t item) {
  tile.last = inner == 1;
  tile.plane = 0;
  if (tile.last) {
    tile.run = AXIS_ROWS;
    tile.shift = 0;
    tile.runs = (rows + tile.run - 1) / tile.run;
    balance(tile, m, static_cast<int>(1024 / item), false);
    tile.blocks = tile.runs * tile.tiles;
  } else {
    tile.run = pow2_at_least(inner, static_cast<int>(256 / item));
    tile.shift = log2_of(tile.run);
    tile.runs = (inner + tile.run - 1) / tile.run;
    balance(tile, m, static_cast<int>(16384 / item) / tile.run, false);
    tile.blocks = rows * tile.tiles * tile.runs;
  }
  tile.span = 2 * tile.t + len - 2;  // window positions of a whole tile
  return item * static_cast<size_t>(tile.run) * (tile.span + 2 * tile.t) +
         sizeof(int) * tile.span;
}

template <typename T>
__global__ void __launch_bounds__(PTWT_THREADS)
    tap_grad_kernel(const T* __restrict__ x, const BandPairs<T> bands,
                    double* __restrict__ partial, const AxisTile tile, const TapArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double red[PTWT_THREADS];
  const int run = tile.run, span = tile.span, t = tile.t;
  // [span][run] (middle) or [run][span] (last), then the two band tiles
  // [t][run] or [run][t], then the window's sources
  T* win = reinterpret_cast<T*>(smem_raw);
  T* bt = win + static_cast<size_t>(run) * span;
  int* src = reinterpret_cast<int*>(bt + 2 * static_cast<size_t>(run) * t);
  const int tid = threadIdx.x;
  const int sums = 2 * a.len, lanes = PTWT_THREADS / sums;
  const int s = tid / lanes, lane = tid - s * lanes;
  const int f = s < sums ? s / a.len : 0, k = s < sums ? s - f * a.len : 0;
  const int64_t rows = a.groups * a.outer;
  double acc = 0.0;
  for (int64_t blk = blockIdx.x; blk < tile.blocks; blk += gridDim.x) {
    int tile_i;
    int64_t o = 0, lead;  // o: the row of x (middle); lead: first column or row
    if (tile.last) {
      tile_i = static_cast<int>(blk % tile.tiles);
      lead = blk / tile.tiles * run;
    } else {
      const int64_t rest = blk / tile.runs;
      lead = (blk - rest * tile.runs) * run;
      tile_i = static_cast<int>(rest % tile.tiles);
      o = rest / tile.tiles;
    }
    const int j0 = tile_i * t;
    const int n_out = min(t, a.m - j0);
    const int nrun = static_cast<int>(min64(run, (tile.last ? rows : a.inner) - lead));
    const int wins = 2 * n_out + a.len - 2;
    for (int w = tid; w < wins; w += PTWT_THREADS)
      src[w] = source_of(2 * j0 - a.pad + w, a.n, a.period, a.mode);
    __syncthreads();

    T* bl = bt;
    T* bh = bt + static_cast<size_t>(run) * t;
    if (tile.last) {
      Walk st(tid, wins);
      for (int e = tid; e < nrun * wins; e += PTWT_THREADS, st.next()) {
        T* dst = win + st.row * span + st.col;
        const int q = src[st.col];
        if (q >= 0)
          copy_async(dst, x + (lead + st.row) * a.n + q);
        else
          *dst = T(0);
      }
      Walk sb(tid, n_out);
      for (int e = tid; e < nrun * n_out; e += PTWT_THREADS, sb.next()) {
        const int64_t r = lead + sb.row;
        const int g = static_cast<int>(r / a.outer);
        const int64_t at = (r - g * a.outer) * a.m + j0 + sb.col;
        copy_async(bl + sb.row * t + sb.col, bands.lo[g] + at);
        copy_async(bh + sb.row * t + sb.col, bands.hi[g] + at);
      }
    } else {
      const T* xo = x + o * a.n * a.inner + lead;
      for (int e = tid; e < wins * run; e += PTWT_THREADS) {
        const int w = e >> tile.shift, c = e & (run - 1);
        const int q = src[w];
        if (q >= 0 && c < nrun)
          copy_async(win + e, xo + static_cast<int64_t>(q) * a.inner + c);
        else
          win[e] = T(0);
      }
      const int g = static_cast<int>(o / a.outer);
      const int64_t base = ((o - g * a.outer) * a.m + j0) * a.inner + lead;
      for (int e = tid; e < n_out * run; e += PTWT_THREADS) {
        const int j = e >> tile.shift, c = e & (run - 1);
        if (c < nrun) {
          const int64_t at = base + static_cast<int64_t>(j) * a.inner + c;
          copy_async(bl + e, bands.lo[g] + at);
          copy_async(bh + e, bands.hi[g] + at);
        } else {
          bl[e] = bh[e] = T(0);
        }
      }
    }
    wait_staged();

    if (s < sums) {
      const T* bf = f ? bh : bl;
      if (tile.last) {
        for (int r = 0; r < nrun; ++r) {
          const T* wr = win + r * span + k;
          const T* br = bf + r * t;
          for (int j = lane; j < n_out; j += lanes)
            acc += static_cast<double>(br[j]) * static_cast<double>(wr[2 * j]);
        }
      } else {
        for (int e = lane; e < n_out * run; e += lanes) {
          const int j = e >> tile.shift, c = e & (run - 1);
          acc += static_cast<double>(bf[e]) *
                 static_cast<double>(win[((2 * j + k) << tile.shift) + c]);
        }
      }
    }
    __syncthreads();
  }
  red[tid] = acc;
  __syncthreads();
  if (s < sums && lane == 0) {
    double sum = 0.0;
    for (int l = 0; l < lanes; ++l) sum += red[s * lanes + l];
    partial[static_cast<int64_t>(blockIdx.x) * sums + s] = sum;
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
  AxisTile tile;
  const size_t smem = plan_taps(tile, groups * static_cast<int64_t>(outer), m, inner, len,
                                sizeof(T));
  if (smem > AXIS_SMEM_MAX - sizeof(double) * PTWT_THREADS) return PTWT_BAD_ARGUMENT;
  auto kernel = tap_grad_kernel<T>;
  // always set: the static `red` counts against the 48 KB default too
  if (int err = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem))))
    return err;
  const int blocks = static_cast<int>(min64(tile.blocks, cap));
  kernel<<<blocks, PTWT_THREADS, smem, stream>>>(static_cast<const T*>(x), bands, partial,
                                                 tile, a);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  tap_reduce_kernel<<<2 * len, PTWT_THREADS, 0, stream>>>(partial, blocks, 2 * len, out);
  return static_cast<int>(cudaGetLastError());
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
