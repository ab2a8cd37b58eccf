// K6a, K6b, K8a and K8b (K8 at depth 1 carrying K7a and K7b), and the VJPs
// of K7 and K8: the 1d filter-bank pyramids of wavedec/waverec along a long
// last axis.
//
// Replaces:
//   K8a  ptwt_tpu/ops/_pallas1d_multi.py:_multi_window_kernel (with the
//        XLA edge strips _edge_strips/_stitch), and at depth 1
//   K7a  ptwt_tpu/ops/_pallas1d.py:_window_kernel;
//   K8b  ptwt_tpu/ops/_pallas1d_multi.py:_syn_multi_window_kernel, and at
//        depth 1
//   K7b  ptwt_tpu/ops/_pallas1d.py:_syn_window_kernel;
//   K6a  ptwt_tpu/ops/_pallas.py:_make_wavedec_kernel_ph;
//   K6b  ptwt_tpu/ops/_pallas.py:_make_waverec_kernel;
//   and the custom VJPs of K7/K8 (_pallas1d.py:_analysis_with_vjp,
//   _synthesis_with_vjp; _pallas1d_multi.py:_multi_with_vjp, _syn_vjp_for).
//
// Bound on the H100: bytes.  A fused run of D levels reads the signal once
// and writes each band once (about 2x the signal's bytes in all); each
// output costs L multiply-adds per band, far below the card's ops/byte
// balance.  What held the first design at 4-7x that bound was latency:
// a staging loop with about one load in flight per thread, band loads that
// waited behind the previous level's compute, about 2L shared-memory reads
// per output, and per-level pointers and plan fields indexed at run time
// (copied to local memory, and shared reads turned into generic ones).
// So every level loop below is unrolled over the constant depth range, and:
//
// * Staging issues every element of a cone or band strip as its own
//   cp.async copy (coalesced across the warp, no registers held), so a
//   thread has all of its loads in flight at once; positions outside the
//   band are written as zeros (or read modulo the band for K6).
// * Analysis (K8a, K6a, and K8b's VJP): a block owns `tile` level-D
//   outputs.  Their cone at level l - 1 starts at s_{l-1} = 2 s_l - pad_l
//   and is 2 c_l + L - 2 samples long; it is staged split into even and odd
//   positions, so output j of level l is sum_h a[2h] ev[j + h] + a[2h+1]
//   od[j + h].  A thread computes four neighbouring outputs from 16-byte
//   shared reads of ev and od (about (L + 6) / 2 reads per four outputs
//   instead of 4L), and writes the next level's cone split again.  Every
//   hi_l position is written by the tile that owns it, 2^(D-l) tile
//   positions at level l, through shared memory so that neighbouring
//   lanes write neighbouring addresses.  pywt extends every level's band by the mode, so
//   in K8a the first wl_l and last wr_l positions of each level differ
//   from the plain correlation: one extra block per row (blockIdx ==
//   tiles) computes them exactly from a head and a tail strip of the
//   signal, running each level's mode extension as an index map into the
//   strips of the level below, and writes only those positions.  K6a reads
//   the signal modulo n instead (on an exactly halving chain every level
//   is periodic in its band length) and needs no edge block.  The VJP of
//   a fused synthesis run (K8b's, K7b's) is this kernel with the rec taps,
//   per-level offsets pad_l = the synthesis crops, the given band lengths,
//   and intermediate cone values outside [0, m_l) zeroed: the transpose of
//   "each step's output is exactly that long".  Its launch counts as K8a
//   (K7a at depth 1).
// * Synthesis (K8b, K6b, and K8a's VJP): a block owns `tile` outputs of the
//   finest step.  Step l reads its (lo, hi) bands over [c_l, e_l] with
//   c_l = floor((c_{l-1} + off_l - (L - 1)) / 2), e_l = floor((e_{l-1} +
//   off_l) / 2), the transposed convolution with the crop off_l folded into
//   the index.  A thread computes the output pair (2u - off, 2u + 1 - off):
//   both read the same band rows q = u - j, so each shared read feeds two
//   outputs.  Every band range of the tile is staged at once, one cp.async
//   group per band, coarse to fine, so a step waits only for its own bands
//   while the finer ones are still in flight.  Padded modes read zeros
//   outside a band and zero the intermediate bands outside their cropped
//   length; periodization (K6b) reads modulo the band length.
// * K8a's VJP (K7a's at depth 1) is the synthesis kernel with the dec taps
//   and off_l = padl: read as a gather, the transpose of one analysis level
//   is g[t] = sum over k with t + padl - k even of a[k] glo[(t + padl - k)
//   / 2] + ..., the synthesis form, plus, for the padded modes, the
//   transpose of pywt's extension: every extended position p outside
//   [0, m) adds its value onto extend_index(p).  Interior tiles run the
//   plain chain and write only outputs that no fold reaches (the fold
//   zone grows as Z_{l-1} = 2 Z_l + L + 1 down the chain); one edge block
//   per row runs the whole chain on [head | tail] strips of every level,
//   fold included, and writes the first and last `wz` outputs.  `periodic`
//   folds the left pads onto the tail and the right pads onto the head,
//   which is why the strips travel together.  The writes are disjoint: no
//   atomics.  Its launch counts as K8b (K7b at depth 1).
#include <cstring>

#include "common.cuh"

#define FWT1D_MAX_DEPTH 4
#define FWT1D_SMEM_LIMIT 232448
// zero taps kept before and after the bank, so the four-output windows need
// no bounds checks on the tap index
#define FWT1D_TAP_HEAD 8
#define FWT1D_TAP_TAIL 24
#define FWT1D_BANK (FWT1D_TAP_HEAD + PTWT_MAX_TAPS + FWT1D_TAP_TAIL)
// extra elements after each split half-cone, read by the last windows
#define FWT1D_HALF_SLACK 16

// mode codes of the padded modes (pywt names)
#define MODE_ZERO 0
#define MODE_REFLECT 1
#define MODE_PERIODIC 2
#define MODE_SYMMETRIC 3
#define MODE_CONSTANT 4

// The plans arrive as int arrays from the Python wrappers, in this order.
struct AnalysisPlan {
  int depth, n, padl, tile, tiles, mode, strip, edge;
  int m[FWT1D_MAX_DEPTH + 1];    // band lengths, m[0] = n
  int wl[FWT1D_MAX_DEPTH + 1];   // left edge positions per level (1..depth)
  int wr[FWT1D_MAX_DEPTH + 1];   // right edge positions per level
  int pad[FWT1D_MAX_DEPTH + 1];  // left offset of level l (1..depth)
};

struct SynthesisPlan {
  int depth, tile, tiles, buf;     // buf: elements of a tile's band buffers
  int len[FWT1D_MAX_DEPTH + 1];    // len[0]: output; len[l]: band l
  int off[FWT1D_MAX_DEPTH + 1];    // left crop of step l (1..depth)
  int mode, edge, wz, ebuf;        // the fold of K8a's VJP (edge == 1)
  int strip[FWT1D_MAX_DEPTH + 1];  // edge strips (head and tail) per level
};

static_assert(sizeof(AnalysisPlan) == (8 + 4 * (FWT1D_MAX_DEPTH + 1)) * sizeof(int),
              "AnalysisPlan is the wrappers' int array");
static_assert(sizeof(SynthesisPlan) == (8 + 3 * (FWT1D_MAX_DEPTH + 1)) * sizeof(int),
              "SynthesisPlan is the wrappers' int array");

// The taps with zeros around them: tap k of a bank is lo[FWT1D_TAP_HEAD + k].
template <typename T>
struct Bank {
  T lo[FWT1D_BANK];
  T hi[FWT1D_BANK];
};

template <typename T>
static Bank<T> make_bank(const double* lo, const double* hi, int len) {
  Bank<T> bank;
  for (int k = 0; k < FWT1D_BANK; ++k) {
    const int tap = k - FWT1D_TAP_HEAD;
    const bool in = tap >= 0 && tap < len;
    bank.lo[k] = in ? static_cast<T>(lo[tap]) : T(0);
    bank.hi[k] = in ? static_cast<T>(hi[tap]) : T(0);
  }
  return bank;
}

template <typename T>
struct AnalysisOut {
  T* lo;                      // lo_D, [rows, m[depth]]
  T* hi[FWT1D_MAX_DEPTH];     // hi[l - 1]: hi_l, [rows, m[l]]
};

template <typename T>
struct SynthesisIn {
  const T* lo;                   // lo_D, [rows, len[depth]]
  const T* hi[FWT1D_MAX_DEPTH];  // hi[l - 1]: hi_l, [rows, len[l]]
};

__host__ __device__ __forceinline__ int floor_half(int v) {
  return v >= 0 ? v >> 1 : -((1 - v) >> 1);
}

__device__ __forceinline__ int mod_pos(int p, int m) {
  int q = p % m;
  return q < 0 ? q + m : q;
}

// pywt's extension of a band of length m: the source of position p, or -1
// where the extension is zero.
__device__ __forceinline__ int extend_index(int p, int m, int mode) {
  if (p >= 0 && p < m) return p;
  switch (mode) {
    case MODE_ZERO:
      return -1;
    case MODE_REFLECT: {
      if (m == 1) return 0;
      const int q = mod_pos(p, 2 * m - 2);
      return q < m ? q : 2 * m - 2 - q;
    }
    case MODE_PERIODIC:
      return mod_pos(p, m);
    case MODE_SYMMETRIC: {
      const int q = mod_pos(p, 2 * m);
      return q < m ? q : 2 * m - 1 - q;
    }
    default:  // constant: edge replication
      return p < 0 ? 0 : m - 1;
  }
}

// ---------------------------------------------------------------------------
// staging: one cp.async copy per element, all in flight together
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(addr), "l"(src),
               "n"(static_cast<int>(sizeof(T))));
}

__device__ __forceinline__ void commit_async() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wait_async_le(int n) {
  switch (n) {
    case 0: wait_async<0>(); break;
    case 1: wait_async<1>(); break;
    case 2: wait_async<2>(); break;
    default: wait_async<3>(); break;
  }
}

// The source of band position p: itself inside [0, m), modulo m when
// Circular, else -1 (a zero).
template <bool Circular>
__device__ __forceinline__ int band_source(int p, int m) {
  if (p >= 0 && p < m) return p;
  return Circular ? mod_pos(p, m) : -1;
}

// Issue dst[j] = band[start + j] for j < count (a run of one band row).
template <typename T, bool Circular>
__device__ __forceinline__ void stage_run(T* dst, const T* __restrict__ row, int start,
                                          int count, int m) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int src = band_source<Circular>(start + j, m);
    if (src >= 0)
      copy_async(dst + j, row + src);
    else
      dst[j] = T(0);
  }
}

// Issue the [head | tail] strips of a band row: dst[0, e) = band[0, e),
// dst[e, 2e) = band[m - e, m).
template <typename T>
__device__ __forceinline__ void stage_strips(T* dst, const T* __restrict__ row, int e, int m) {
  for (int j = threadIdx.x; j < 2 * e; j += blockDim.x)
    copy_async(dst + j, row + (j < e ? j : m - 2 * e + j));
}

// Issue a cone split by parity: ev[j] = band[start + 2j], od[j] =
// band[start + 2j + 1], for the `count` positions of the cone; the rest of
// both halves (`half` elements each) is zeroed, since windows past the cone
// multiply it by zero taps.
template <typename T, bool Circular>
__device__ __forceinline__ void stage_split(T* ev, T* od, const T* __restrict__ row,
                                            int start, int count, int m, int half) {
  for (int j = threadIdx.x; j < 2 * half; j += blockDim.x) {
    T* dst = (j & 1) ? od + (j >> 1) : ev + (j >> 1);
    const int src = j < count ? band_source<Circular>(start + j, m) : -1;
    if (src >= 0)
      copy_async(dst, row + src);
    else
      *dst = T(0);
  }
}

// Four neighbouring elements from a 16-byte aligned shared address.
template <typename T>
struct Quad {
  T v[4];
};

__device__ __forceinline__ Quad<float> load_quad(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  return {{a.x, a.y, a.z, a.w}};
}

__device__ __forceinline__ Quad<double> load_quad(const double* p) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  return {{a.x, a.y, b.x, b.y}};
}

__device__ __forceinline__ void store_quad(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_quad(double* p, const double* v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

// ---------------------------------------------------------------------------
// the analysis pyramid (K6a, K7a, K8a; the VJP of K7b and K8b)
// ---------------------------------------------------------------------------

// Elements of one split half of a cone of `count` positions, with the slack
// the last windows read, rounded to 16 bytes of doubles.
__host__ __device__ __forceinline__ int round4(int count) { return (count + 3) & ~3; }

__host__ __device__ __forceinline__ int split_half(int count) {
  return round4((count + 1) / 2 + FWT1D_HALF_SLACK);
}

// Every level loop below runs over the constant range 1..FWT1D_MAX_DEPTH,
// unrolled, and skips the levels past the plan's depth: so each per-level
// index (the plan's arrays, the cone bounds, the band pointers) is a
// constant, and nothing is copied to local memory.

// Bounds of a synthesis tile's band ranges: span[l] >= e_l - c_l + 1 for a
// tile of `tile` outputs, and at[l] = span[1] + ... + span[l] (at[0] = 0).
__host__ __device__ __forceinline__ void synthesis_spans(int tile, int len, int* span, int* at) {
  span[0] = tile;
  at[0] = 0;
#pragma unroll
  for (int l = 1; l <= FWT1D_MAX_DEPTH; ++l) {
    span[l] = (span[l - 1] + len - 1) / 2 + 1;
    at[l] = at[l - 1] + span[l];
  }
}

// Elements of a synthesis tile's buffers: every hi band, lo_D, and the
// two intermediate lo buffers (lo_1 and lo_2 at most).
__host__ __device__ __forceinline__ int synthesis_tile_elems(int tile, int len, int depth) {
  int span[FWT1D_MAX_DEPTH + 1], at[FWT1D_MAX_DEPTH + 2];
  synthesis_spans(tile, len, span, at);
  int total = at[depth] + span[depth];
  if (depth > 1) total += span[1];
  if (depth > 2) total += span[2];
  return total;
}

// Tile cone of an analysis block: start s[l] and length c[l] at each level.
__device__ __forceinline__ void analysis_cone(const AnalysisPlan& plan, int tile,
                                              int len, int* s, int* c) {
#pragma unroll
  for (int l = FWT1D_MAX_DEPTH; l > 0; --l) {
    if (l > plan.depth) continue;
    if (l == plan.depth) {
      s[l] = tile * plan.tile;
      c[l] = plan.tile;
    }
    s[l - 1] = 2 * s[l] - plan.pad[l];
    c[l - 1] = 2 * c[l] + len - 2;
  }
}

// The exact edges of every level for one row, from head and tail strips.
// Level l keeps band_l[0, E_l) and band_l[m_l - E_l, m_l) with
// E_l = strip << (depth - l); the wrapper's plan makes every index a level
// reads land in one of the two strips of the level below.
template <typename T>
__device__ void analysis_edges(const T* __restrict__ xr, const AnalysisOut<T>& out,
                               const Bank<T>& taps, int len,
                               const AnalysisPlan& plan, int row, T* smem) {
  int e_prev = plan.strip << plan.depth;
  const int n = plan.m[0];
  const T* lo_taps = taps.lo + FWT1D_TAP_HEAD;
  const T* hi_taps = taps.hi + FWT1D_TAP_HEAD;
  stage_strips(smem, xr, e_prev, n);
  commit_async();
  wait_async<0>();
  __syncthreads();
#pragma unroll
  for (int l = 1; l <= FWT1D_MAX_DEPTH; ++l) {
    if (l > plan.depth) break;
    // [head | tail] of the level below, then of this level
    const T* cur = smem + ((l - 1) & 1) * 2 * (plan.strip << plan.depth);
    T* nxt = smem + (l & 1) * 2 * (plan.strip << plan.depth);
    const int mp = plan.m[l - 1];
    const int m = plan.m[l];
    const int e = e_prev >> 1;
    T* hi_out = out.hi[l - 1] + static_cast<int64_t>(row) * m;
    T* lo_out = out.lo + static_cast<int64_t>(row) * m;
    for (int idx = threadIdx.x; idx < 2 * e; idx += blockDim.x) {
      const bool tail = idx >= e;
      const int i = tail ? m - e + (idx - e) : idx;
      T lo = T(0), hi = T(0);
      for (int k = 0; k < len; ++k) {
        const int p = extend_index(2 * i + k - plan.padl, mp, plan.mode);
        if (p < 0) continue;
        const T v = p < e_prev ? cur[p] : cur[e_prev + p - (mp - e_prev)];
        lo += lo_taps[k] * v;
        hi += hi_taps[k] * v;
      }
      nxt[idx] = lo;
      if (tail ? i >= m - plan.wr[l] : i < plan.wl[l]) {
        hi_out[i] = hi;
        if (l == plan.depth) lo_out[i] = lo;
      }
    }
    __syncthreads();
    e_prev = e;
  }
}

template <typename T, bool Circular>
__global__ void __launch_bounds__(PTWT_THREADS)
    analysis_pyramid_kernel(const T* __restrict__ x, const AnalysisOut<T> out,
                            const __grid_constant__ Bank<T> taps, int len,
                            const AnalysisPlan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int per_row = plan.tiles + plan.edge;
  const int row = blockIdx.x / per_row;
  const int tile = blockIdx.x - row * per_row;
  const int n = plan.m[0];
  const T* xr = x + static_cast<int64_t>(row) * n;
  if (!Circular && tile == plan.tiles) {
    analysis_edges<T>(xr, out, taps, len, plan, row, smem);
    return;
  }
  const int d = plan.depth;
  int s[FWT1D_MAX_DEPTH + 1], c[FWT1D_MAX_DEPTH + 1];
  analysis_cone(plan, tile, len, s, c);
  // even levels split into buffer A, odd levels into buffer B (pointers
  // picked by arithmetic, not from an array, so the compiler keeps them in
  // the shared space and emits LDS)
  const int half_a = split_half(c[0]);
  const int half_b = d > 1 ? split_half(c[1]) : 0;
  T* const buf_a = smem;
  T* const buf_b = smem + 2 * half_a;
  // each level's outputs go through shared memory (hi, and lo at level D
  // after round4(tile)) so that the global writes are coalesced
  T* const outs = buf_b + 2 * half_b;
  const int lo_at = round4(plan.tile);
  stage_split<T, Circular>(buf_a, buf_a + half_a, xr, s[0], c[0], n, half_a);
  commit_async();
  // buffer B's windows also read past what level 1 writes: start it at zero
  for (int j = threadIdx.x; j < 2 * half_b; j += blockDim.x) buf_b[j] = T(0);
  wait_async<0>();
  __syncthreads();
  // window of four outputs: taps a[2h], a[2h+1] with h = 4 ch + q - r
  const int chunks = ((len + 1) / 2 + 3 + 3) / 4;
  const T* tl = taps.lo + FWT1D_TAP_HEAD;
  const T* th = taps.hi + FWT1D_TAP_HEAD;
#pragma unroll
  for (int l = 1; l <= FWT1D_MAX_DEPTH; ++l) {
    if (l > d) break;
    const bool odd = (l - 1) & 1;
    const T* ev = odd ? buf_b : buf_a;
    const T* od = ev + (odd ? half_b : half_a);
    T* nev = odd ? buf_a : buf_b;
    T* nod = nev + (odd ? half_a : half_b);
    const int m = plan.m[l];
    // the positions of level l this tile owns, minus the edges
    const int own = plan.tile << (d - l);
    const int first = max(tile * own, plan.wl[l]);
    const int last = min(tile * own + own, m - plan.wr[l]);
    T* hi_out = out.hi[l - 1] + static_cast<int64_t>(row) * m;
    T* lo_out = out.lo + static_cast<int64_t>(row) * m;
    const int cl = c[l], sl = s[l];
    const int groups = (cl + 3) >> 2;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      T lo[4] = {T(0), T(0), T(0), T(0)};
      T hi[4] = {T(0), T(0), T(0), T(0)};
      for (int ch = 0; ch < chunks; ++ch) {
        const Quad<T> e = load_quad(ev + 4 * g + 4 * ch);
        const Quad<T> o = load_quad(od + 4 * g + 4 * ch);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int h2 = 2 * (4 * ch + q - r);
            lo[r] += tl[h2] * e.v[q];
            lo[r] += tl[h2 + 1] * o.v[q];
            hi[r] += th[h2] * e.v[q];
            hi[r] += th[h2 + 1] * o.v[q];
          }
        }
      }
      store_quad(outs + 4 * g, hi);
      if (l == d) {
        store_quad(outs + lo_at + 4 * g, lo);
      } else {
        // the next level reads lo zero outside the band (the transposed
        // crop of K8b's VJP; in K8a only edge positions read it)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (!Circular && (sl + 4 * g + r < 0 || sl + 4 * g + r >= m)) lo[r] = T(0);
        store_pair(nev + 2 * g, lo[0], lo[2]);
        store_pair(nod + 2 * g, lo[1], lo[3]);
      }
    }
    __syncthreads();
    // the owned positions, one run per band, neighbouring lanes on
    // neighbouring addresses
    for (int i = first + threadIdx.x; i < last; i += blockDim.x) {
      hi_out[i] = outs[i - sl];
      if (l == d) lo_out[i] = outs[lo_at + i - sl];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the synthesis pyramid (K6b, K7b, K8b; the VJP of K7a and K8a)
// ---------------------------------------------------------------------------

// Band position q of a [head | tail] strip pair of e positions each of a
// band of length m (zero outside the band).
template <typename T>
__device__ __forceinline__ T strip_at(const T* strips, int q, int e, int m) {
  if (q < 0 || q >= m) return T(0);
  return q < e ? strips[q] : strips[e + q - (m - e)];
}

// sum over taps k with f - k even of lo[k] bl[(f - k) / 2] + hi[k] bh[...],
// on [head | tail] strips.
template <typename T>
__device__ __forceinline__ T strip_gather(const T* bl, const T* bh, const Bank<T>& taps,
                                          int len, int f, int e, int m) {
  T acc = T(0);
  for (int k = f & 1; k < len; k += 2) {
    const int q = (f - k) >> 1;
    acc += taps.lo[FWT1D_TAP_HEAD + k] * strip_at(bl, q, e, m);
    acc += taps.hi[FWT1D_TAP_HEAD + k] * strip_at(bh, q, e, m);
  }
  return acc;
}

// The edge block of K8a's VJP: the whole chain on the [head | tail] strips
// of every level, pywt's extension folded back at every step, and the
// first and last `wz` outputs written.  Step l turns band l's strips
// (E_l = strip[l] each) into those of level l - 1; the wrapper's plan makes
// every band position a step reads land in a strip.
template <typename T>
__device__ void synthesis_edges(const SynthesisIn<T>& in, T* __restrict__ out,
                                const Bank<T>& taps, int len, const SynthesisPlan& plan,
                                int row, T* smem) {
  const int d = plan.depth;
  const int pad = plan.off[1];
  const int eb = plan.ebuf;       // elements of one [head | tail] buffer
  T* hib = smem + 2 * eb;         // hi strips of band l
  T* ext = smem + 3 * eb;         // cotangent of the extended positions
  int* tgt = reinterpret_cast<int*>(ext + 2 * pad + 2);  // their sources
#pragma unroll
  for (int l = FWT1D_MAX_DEPTH; l >= 1; --l) {
    if (l > d) continue;
    const int m = plan.len[l];
    const int mp = plan.len[l - 1];
    const int e = plan.strip[l];
    const int eo = plan.strip[l - 1];
    // lo strips of band l, then the strips of level l - 1
    T* cur = smem + ((d - l) & 1) * eb;
    T* nxt = smem + ((d - l + 1) & 1) * eb;
    if (l == d) stage_strips(cur, in.lo + static_cast<int64_t>(row) * m, e, m);
    stage_strips(hib, in.hi[l - 1] + static_cast<int64_t>(row) * m, e, m);
    commit_async();
    wait_async<0>();
    __syncthreads();
    // pywt pads the level's input by pad on the left, pad + mp % 2 on the right
    const int nx = 2 * pad + (mp & 1);
    for (int x = threadIdx.x; x < nx; x += blockDim.x) {
      const int p = x < pad ? x - pad : mp + (x - pad);
      ext[x] = strip_gather(cur, hib, taps, len, p + pad, e, m);
      tgt[x] = extend_index(p, mp, plan.mode);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < 2 * eo; idx += blockDim.x) {
      const bool tail = idx >= eo;
      const int t = tail ? mp - eo + (idx - eo) : idx;
      T acc = strip_gather(cur, hib, taps, len, t + pad, e, m);
      for (int x = 0; x < nx; ++x)
        if (tgt[x] == t) acc += ext[x];
      if (l > 1) {
        nxt[idx] = acc;
      } else if (tail ? t >= mp - plan.wz && t >= plan.wz : t < plan.wz) {
        out[static_cast<int64_t>(row) * mp + t] = acc;
      }
    }
    __syncthreads();
  }
}

template <typename T, bool Circular>
__global__ void __launch_bounds__(PTWT_THREADS)
    synthesis_pyramid_kernel(const SynthesisIn<T> in, T* __restrict__ out,
                             const __grid_constant__ Bank<T> taps, int len,
                             const SynthesisPlan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int per_row = plan.tiles + plan.edge;
  const int row = blockIdx.x / per_row;
  const int tile = blockIdx.x - row * per_row;
  if (!Circular && tile == plan.tiles) {
    synthesis_edges<T>(in, out, taps, len, plan, row, smem);
    return;
  }
  const int d = plan.depth;
  int c[FWT1D_MAX_DEPTH + 1], e[FWT1D_MAX_DEPTH + 1];
  c[0] = tile * plan.tile;
  e[0] = c[0] + plan.tile - 1;
#pragma unroll
  for (int l = 1; l <= FWT1D_MAX_DEPTH; ++l) {
    c[l] = floor_half(c[l - 1] + plan.off[l] - (len - 1));
    e[l] = floor_half(e[l - 1] + plan.off[l]);
  }
  // Every band is staged at once: the hi bands packed by level (hi_l at
  // the sum of the bounds of the finer levels), then lo_D, then two
  // buffers for the intermediate lo bands (lo_{l-1} in P[l & 1]).  Each
  // band is its own cp.async group, coarse to fine, so step l waits only
  // for its own bands while the finer ones are still in flight.
  int span[FWT1D_MAX_DEPTH + 1], at[FWT1D_MAX_DEPTH + 2];
  synthesis_spans(plan.tile, len, span, at);
  T* const lo_d = smem + at[d];
  T* const p0 = lo_d + span[d];
  T* const p1 = p0 + span[1];
  const T* tl = taps.lo + FWT1D_TAP_HEAD;
  const T* th = taps.hi + FWT1D_TAP_HEAD;
  const int nh = (len + 1) >> 1;  // band rows per output pair
#pragma unroll
  for (int l = FWT1D_MAX_DEPTH; l >= 1; --l) {
    if (l > d) continue;
    if (l == d)
      stage_run<T, Circular>(lo_d, in.lo + static_cast<int64_t>(row) * plan.len[l], c[l],
                             e[l] - c[l] + 1, plan.len[l]);
    stage_run<T, Circular>(smem + at[l - 1], in.hi[l - 1] + static_cast<int64_t>(row) * plan.len[l],
                           c[l], e[l] - c[l] + 1, plan.len[l]);
    commit_async();
  }
#pragma unroll
  for (int l = FWT1D_MAX_DEPTH; l >= 1; --l) {
    if (l > d) continue;
    // bands l - 1 .. 1 may still be in flight
    wait_async_le(l - 1);
    __syncthreads();
    const T* lo = l == d ? lo_d : ((l + 1) & 1 ? p1 : p0);
    const T* hi = smem + at[l - 1];
    T* nxt = l & 1 ? p1 : p0;
    const int off = plan.off[l];
    const int cl = c[l], cp = c[l - 1], ep = e[l - 1];
    // output pairs f = 2u, 2u + 1 with f = t + off over [c_{l-1}, e_{l-1}]
    const int u0 = floor_half(cp + off);
    const int pairs = floor_half(ep + off) - u0 + 1;
    const int lo_t = max(c[0], plan.wz);
    const int hi_t = min(e[0] + 1, plan.len[0] - plan.wz);
    const int len_p = plan.len[l - 1];
    T* out_row = out + static_cast<int64_t>(row) * plan.len[0];
    for (int g = threadIdx.x; g < pairs; g += blockDim.x) {
      const int u = u0 + g;
      T acc0 = T(0), acc1 = T(0);
      const T* bl = lo + (u - cl);
      const T* bh = hi + (u - cl);
      // out[2u] takes taps 2j, out[2u + 1] taps 2j + 1, both from row u - j
      for (int j = 0; j < nh; ++j) {
        const T vl = bl[-j], vh = bh[-j];
        acc0 += tl[2 * j] * vl;
        acc0 += th[2 * j] * vh;
        acc1 += tl[2 * j + 1] * vl;
        acc1 += th[2 * j + 1] * vh;
      }
      const int t0 = 2 * u - off;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = t0 + r;
        T acc = r ? acc1 : acc0;
        if (t < cp || t > ep) continue;
        if (l > 1) {
          if (!Circular && (t < 0 || t >= len_p)) acc = T(0);
          nxt[t - cp] = acc;
        } else if (t >= lo_t && t < hi_t) {
          out_row[t] = acc;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side: plan checks and launches
// ---------------------------------------------------------------------------

// Shared memory (elements) an analysis launch needs: the split level-0 and
// level-1 cones (levels alternate between them) and the output buffer, or
// the edge block's strips of two levels.
static int64_t analysis_smem(const AnalysisPlan& p, int len) {
  const int64_t c0 = (int64_t(p.tile) << p.depth) + int64_t(len - 2) * ((1 << p.depth) - 1);
  const int64_t c1 = (int64_t(p.tile) << (p.depth - 1)) + int64_t(len - 2) * ((1 << (p.depth - 1)) - 1);
  if (c0 >= (int64_t(1) << 30)) return int64_t(1) << 40;
  const int64_t outs = round4(int(c1 > 2 * round4(p.tile) ? c1 : 2 * round4(p.tile)));
  const int64_t split = 2 * int64_t(split_half(int(c0))) + (p.depth > 1 ? 2 * int64_t(split_half(int(c1))) : 0) + outs;
  const int64_t edge = p.edge ? 3 * (int64_t(p.strip) << p.depth) : 0;
  return split > edge ? split : edge;
}

static bool analysis_plan_ok(const AnalysisPlan& p, int len, int64_t rows) {
  if (p.depth < 1 || p.depth > FWT1D_MAX_DEPTH || p.n < 1 || p.tile < 1 ||
      p.tiles < 1 || len < 2 || len > PTWT_MAX_TAPS || rows < 1 || p.m[0] != p.n)
    return false;
  if ((int64_t(p.tiles) + p.edge) * rows >= (int64_t(1) << 31)) return false;
  for (int l = 1; l <= p.depth; ++l) {
    if (p.m[l] < 1 || p.pad[l] < 0 || p.wl[l] < 0 || p.wr[l] < 0) return false;
    // the tiles cover every level
    if ((int64_t(p.tiles) * p.tile << (p.depth - l)) < p.m[l]) return false;
    if (p.edge && (p.strip << (p.depth - l)) > p.m[l]) return false;
  }
  return !p.edge || (p.strip << p.depth) <= p.n;
}

// Shared memory (bytes) a synthesis launch needs: a tile's band buffers
// (`buf` elements), or the edge block's three strip buffers, the extended
// positions' cotangents and their source indices.
static int64_t synthesis_smem(const SynthesisPlan& p, int itemsize) {
  const int64_t tiles = int64_t(p.buf) * itemsize;
  const int64_t ext = 2 * int64_t(p.off[1]) + 2;
  const int64_t edge = p.edge ? (3 * int64_t(p.ebuf) + ext) * itemsize + ext * 4 : 0;
  return tiles > edge ? tiles : edge;
}

static bool synthesis_plan_ok(const SynthesisPlan& p, int len, int64_t rows) {
  if (p.depth < 1 || p.depth > FWT1D_MAX_DEPTH || p.tile < 1 || p.tiles < 1 ||
      p.buf < 1 || len < 2 || len > PTWT_MAX_TAPS || rows < 1 ||
      (int64_t(p.tiles) + p.edge) * rows >= (int64_t(1) << 31))
    return false;
  for (int l = 0; l <= p.depth; ++l)
    if (p.len[l] < 1) return false;
  // every band range of a tile fits its buffers
  if (p.tile >= (1 << 24) || p.buf < synthesis_tile_elems(p.tile, len, p.depth)) return false;
  for (int l = 1; l <= p.depth; ++l)
    if (p.off[l] < 0) return false;
  if (!p.edge) return true;
  if (p.mode < MODE_ZERO || p.mode > MODE_CONSTANT || p.wz < 0 || p.wz > p.strip[0]) return false;
  for (int l = 0; l <= p.depth; ++l) {
    if (p.strip[l] < 1 || p.strip[l] > p.len[l] || 2 * p.strip[l] > p.ebuf) return false;
    if (l >= 1 && p.off[l] != p.off[1]) return false;
  }
  return true;
}

template <typename T, bool Circular>
static int launch_analysis(const void* x, void* lo_out, void* const* his,
                           const double* lo, const double* hi, int len,
                           long long rows, const AnalysisPlan& plan, int smem,
                           cudaStream_t stream) {
  AnalysisOut<T> out;
  out.lo = static_cast<T*>(lo_out);
  for (int l = 0; l < FWT1D_MAX_DEPTH; ++l) out.hi[l] = static_cast<T*>(his[l]);
  auto kernel = analysis_pyramid_kernel<T, Circular>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((plan.tiles + plan.edge) * rows);
  kernel<<<blocks, PTWT_THREADS, smem, stream>>>(
      static_cast<const T*>(x), out, make_bank<T>(lo, hi, len), len, plan);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool Circular>
static int launch_synthesis(const void* lo_in, const void* const* his, void* out,
                            const double* rlo, const double* rhi, int len,
                            long long rows, const SynthesisPlan& plan, int smem,
                            cudaStream_t stream) {
  SynthesisIn<T> in;
  in.lo = static_cast<const T*>(lo_in);
  for (int l = 0; l < FWT1D_MAX_DEPTH; ++l) in.hi[l] = static_cast<const T*>(his[l]);
  auto kernel = synthesis_pyramid_kernel<T, Circular>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((plan.tiles + plan.edge) * rows);
  kernel<<<blocks, PTWT_THREADS, smem, stream>>>(
      in, static_cast<T*>(out), make_bank<T>(rlo, rhi, len), len, plan);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = float64.  `plan` holds the AnalysisPlan fields
// in declaration order (8 + 4 * 5 ints).  circular = 1 runs K6a (no edge
// block), 0 runs K8a (edge = 1), K7a in `valid` or the VJP of K8b (edge =
// 0).  Returns a cudaError_t after the launch, or PTWT_BAD_ARGUMENT.
extern "C" int ptwt_fwt1d_analysis(int dtype, const void* x, void* lo_out,
                                   void* hi1, void* hi2, void* hi3, void* hi4,
                                   const double* lo, const double* hi, int len,
                                   long long rows, const int* plan_ints,
                                   int circular, int smem_bytes, void* stream) {
  AnalysisPlan plan;
  std::memcpy(&plan, plan_ints, sizeof(plan));
  if (!analysis_plan_ok(plan, len, rows) || (circular && plan.edge) ||
      dtype < 0 || dtype > 1)
    return PTWT_BAD_ARGUMENT;
  const int64_t need = analysis_smem(plan, len) * (dtype ? 8 : 4);
  if (smem_bytes < need || smem_bytes > FWT1D_SMEM_LIMIT) return PTWT_BAD_ARGUMENT;
  void* his[FWT1D_MAX_DEPTH] = {hi1, hi2, hi3, hi4};
  for (int l = 0; l < plan.depth; ++l)
    if (!his[l]) return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return circular ? launch_analysis<float, true>(x, lo_out, his, lo, hi, len, rows, plan, smem_bytes, s)
                    : launch_analysis<float, false>(x, lo_out, his, lo, hi, len, rows, plan, smem_bytes, s);
  return circular ? launch_analysis<double, true>(x, lo_out, his, lo, hi, len, rows, plan, smem_bytes, s)
                  : launch_analysis<double, false>(x, lo_out, his, lo, hi, len, rows, plan, smem_bytes, s);
}

// `plan` holds the SynthesisPlan fields in declaration order (8 + 3 * 5
// ints).  circular = 1 runs K6b, 0 runs K8b/K7b (edge = 0) or the VJP of
// K8a/K7a (edge = 1 folds the padded modes' extension).
extern "C" int ptwt_fwt1d_synthesis(int dtype, const void* lo_in,
                                    const void* hi1, const void* hi2,
                                    const void* hi3, const void* hi4, void* out,
                                    const double* rlo, const double* rhi,
                                    int len, long long rows,
                                    const int* plan_ints, int circular,
                                    int smem_bytes, void* stream) {
  SynthesisPlan plan;
  std::memcpy(&plan, plan_ints, sizeof(plan));
  if (!synthesis_plan_ok(plan, len, rows) || (circular && plan.edge) || dtype < 0 || dtype > 1)
    return PTWT_BAD_ARGUMENT;
  if (smem_bytes < synthesis_smem(plan, dtype ? 8 : 4) || smem_bytes > FWT1D_SMEM_LIMIT)
    return PTWT_BAD_ARGUMENT;
  const void* his[FWT1D_MAX_DEPTH] = {hi1, hi2, hi3, hi4};
  for (int l = 0; l < plan.depth; ++l)
    if (!his[l]) return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return circular ? launch_synthesis<float, true>(lo_in, his, out, rlo, rhi, len, rows, plan, smem_bytes, s)
                    : launch_synthesis<float, false>(lo_in, his, out, rlo, rhi, len, rows, plan, smem_bytes, s);
  return circular ? launch_synthesis<double, true>(lo_in, his, out, rlo, rhi, len, rows, plan, smem_bytes, s)
                  : launch_synthesis<double, false>(lo_in, his, out, rlo, rhi, len, rows, plan, smem_bytes, s);
}
