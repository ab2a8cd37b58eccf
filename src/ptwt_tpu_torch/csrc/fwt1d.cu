// K6a, K6b, K8a and K8b (K8 at depth 1 carrying K7a and K7b): the 1d
// filter-bank pyramids of wavedec/waverec along a long last axis.
//
// Replaces:
//   K8a  ptwt_tpu/ops/_pallas1d_multi.py:_multi_window_kernel (with the
//        XLA edge strips _edge_strips/_stitch), and at depth 1
//   K7a  ptwt_tpu/ops/_pallas1d.py:_window_kernel;
//   K8b  ptwt_tpu/ops/_pallas1d_multi.py:_syn_multi_window_kernel, and at
//        depth 1
//   K7b  ptwt_tpu/ops/_pallas1d.py:_syn_window_kernel;
//   K6a  ptwt_tpu/ops/_pallas.py:_make_wavedec_kernel_ph;
//   K6b  ptwt_tpu/ops/_pallas.py:_make_waverec_kernel.
//
// Bound on the H100: bytes.  A fused run of D levels reads the signal once
// and writes each band once (about 2x the signal's bytes in all); each
// output costs L multiply-adds per band, far below the card's ops/byte
// balance.
//
// Design.  The Pallas kernels stacked overlapping 2^15-sample windows in
// [8, 4096] flat tiles and ran the taps as flat rolls; here a block owns a
// tile of outputs and stages the input cone of that tile in shared memory:
//
// * Analysis (K8a, K6a): a block owns `tile` level-D outputs.  Their cone
//   at level l - 1 starts at s_{l-1} = 2 s_l - padl and is 2 c_l + L - 2
//   samples long, so the block loads 2^D tile + (L - 2)(2^D - 1) signal
//   samples once, computes the levels in turn in shared memory (lo kept,
//   level D and the owned hi written), and writes every hi_l position it
//   owns: the tile's 2^(D-l) tile positions at level l.  Ownership covers
//   each band exactly once.  Interior values are plain correlations of the
//   zero-extended signal.  pywt extends every level's band by the mode, so
//   the first wl_l and last wr_l positions of each level differ from the
//   plain correlation: one extra block per row (blockIdx == tiles) computes
//   them exactly from a head and a tail strip of the signal, running each
//   level's mode extension (zero, reflect, periodic, symmetric, constant)
//   as an index map into the strips of the level below, and writes only
//   those positions.  The writes of all blocks are disjoint.
// * K6a is the same tile with circular reads: in periodization on an
//   exactly halving chain, every level is periodic in its band length, so
//   reading the signal modulo n makes every cone value exact and no edge
//   block is needed.  A wavedec of more than 4 levels is several launches
//   of at most 4 levels each.
// * Synthesis (K8b, K6b): a block owns `tile` outputs of the finest step.
//   Step l reads its (lo, hi) bands over [c_l, e_l] with
//   c_l = floor((c_{l-1} + off_l - (L - 1)) / 2), e_l = floor((e_{l-1} +
//   off_l) / 2), the transposed convolution with the crop off_l folded
//   into the index.  Padded modes read zeros outside a band and zero the
//   intermediate bands outside their cropped length (each step's output is
//   exactly that long); periodization (K6b) reads modulo the band length
//   and keeps the periodic extension.  No edge pass is needed.
#include <cstring>

#include "common.cuh"

#define FWT1D_MAX_DEPTH 4
#define FWT1D_SMEM_LIMIT 232448

// mode codes of the padded modes (pywt names)
#define MODE_ZERO 0
#define MODE_REFLECT 1
#define MODE_PERIODIC 2
#define MODE_SYMMETRIC 3
#define MODE_CONSTANT 4

// The plans arrive as int arrays from the Python wrappers, in this order.
struct AnalysisPlan {
  int depth, n, padl, tile, tiles, mode, strip, edge;
  int m[FWT1D_MAX_DEPTH + 1];   // band lengths, m[0] = n
  int wl[FWT1D_MAX_DEPTH + 1];  // left edge positions per level (1..depth)
  int wr[FWT1D_MAX_DEPTH + 1];  // right edge positions per level
};

struct SynthesisPlan {
  int depth, tile, tiles, buf;
  int len[FWT1D_MAX_DEPTH + 1];  // len[0]: output; len[l]: band l
  int off[FWT1D_MAX_DEPTH + 1];  // left crop of step l (1..depth)
};

static_assert(sizeof(AnalysisPlan) == (8 + 3 * (FWT1D_MAX_DEPTH + 1)) * sizeof(int),
              "AnalysisPlan is the wrappers' int array");
static_assert(sizeof(SynthesisPlan) == (4 + 2 * (FWT1D_MAX_DEPTH + 1)) * sizeof(int),
              "SynthesisPlan is the wrappers' int array");

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

__device__ __forceinline__ int floor_half(int v) {
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

// Tile cone of an analysis block: start and length at each level.
__device__ __forceinline__ void analysis_cone(const AnalysisPlan& plan, int tile,
                                              int len, int* s, int* c) {
  const int d = plan.depth;
  s[d] = tile * plan.tile;
  c[d] = plan.tile;
  for (int l = d; l > 0; --l) {
    s[l - 1] = 2 * s[l] - plan.padl;
    c[l - 1] = 2 * c[l] + len - 2;
  }
}

// The exact edges of every level for one row, from head and tail strips.
// Level l keeps band_l[0, E_l) and band_l[m_l - E_l, m_l) with
// E_l = strip << (depth - l); the wrapper's plan makes every index a level
// reads land in one of the two strips of the level below.
template <typename T>
__device__ void analysis_edges(const T* __restrict__ xr, const AnalysisOut<T>& out,
                               const Taps<T>& taps, int len,
                               const AnalysisPlan& plan, int row, T* smem) {
  int e_prev = plan.strip << plan.depth;
  const int n = plan.m[0];
  T* cur = smem;                // [head | tail] of the level below
  T* nxt = smem + 2 * e_prev;   // [head | tail] of this level
  for (int j = threadIdx.x; j < e_prev; j += blockDim.x) {
    cur[j] = xr[j];
    cur[e_prev + j] = xr[n - e_prev + j];
  }
  __syncthreads();
  for (int l = 1; l <= plan.depth; ++l) {
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
        lo += taps.lo[k] * v;
        hi += taps.hi[k] * v;
      }
      nxt[idx] = lo;
      if (tail ? i >= m - plan.wr[l] : i < plan.wl[l]) {
        hi_out[i] = hi;
        if (l == plan.depth) lo_out[i] = lo;
      }
    }
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
    e_prev = e;
  }
}

template <typename T, bool Circular>
__global__ void __launch_bounds__(PTWT_THREADS)
    analysis_pyramid_kernel(const T* __restrict__ x, const AnalysisOut<T> out,
                            const __grid_constant__ Taps<T> taps, int len,
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
  T* buf[2] = {smem, smem + c[0]};
  for (int j = threadIdx.x; j < c[0]; j += blockDim.x) {
    const int p = s[0] + j;
    if (Circular)
      buf[0][j] = xr[mod_pos(p, n)];
    else
      buf[0][j] = (p >= 0 && p < n) ? xr[p] : T(0);
  }
  __syncthreads();
  for (int l = 1; l <= d; ++l) {
    const T* cur = buf[(l - 1) & 1];
    T* nxt = buf[l & 1];
    const int m = plan.m[l];
    // the positions of level l this tile owns, minus the edges
    const int own = plan.tile << (d - l);
    int first = tile * own, last = first + own;
    if (!Circular) {
      first = max(first, plan.wl[l]);
      last = min(last, m - plan.wr[l]);
    } else {
      last = min(last, m);
    }
    T* hi_out = out.hi[l - 1] + static_cast<int64_t>(row) * m;
    T* lo_out = out.lo + static_cast<int64_t>(row) * m;
    for (int j = threadIdx.x; j < c[l]; j += blockDim.x) {
      const int i = s[l] + j;
      const bool owned = i >= first && i < last;
      if (!owned && l == d) continue;
      const T* src = cur + 2 * j;
      T lo = T(0);
      if (owned) {
        T hi = T(0);
#pragma unroll 4
        for (int k = 0; k < len; ++k) {
          lo += taps.lo[k] * src[k];
          hi += taps.hi[k] * src[k];
        }
        hi_out[i] = hi;
        if (l == d) lo_out[i] = lo;
      } else {
#pragma unroll 4
        for (int k = 0; k < len; ++k) lo += taps.lo[k] * src[k];
      }
      if (l < d) nxt[j] = lo;
    }
    __syncthreads();
  }
}

template <typename T, bool Circular>
__device__ __forceinline__ void load_band(T* dst, const T* __restrict__ src,
                                          int start, int count, int m) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int q = start + j;
    if (Circular)
      dst[j] = src[mod_pos(q, m)];
    else
      dst[j] = (q >= 0 && q < m) ? src[q] : T(0);
  }
}

template <typename T, bool Circular>
__global__ void __launch_bounds__(PTWT_THREADS)
    synthesis_pyramid_kernel(const SynthesisIn<T> in, T* __restrict__ out,
                             const __grid_constant__ Taps<T> taps, int len,
                             const SynthesisPlan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int row = blockIdx.x / plan.tiles;
  const int tile = blockIdx.x - row * plan.tiles;
  const int d = plan.depth;
  int c[FWT1D_MAX_DEPTH + 1], e[FWT1D_MAX_DEPTH + 1];
  c[0] = tile * plan.tile;
  e[0] = c[0] + plan.tile - 1;
  for (int l = 1; l <= d; ++l) {
    c[l] = floor_half(c[l - 1] + plan.off[l] - (len - 1));
    e[l] = floor_half(e[l - 1] + plan.off[l]);
  }
  T* lo_buf[2] = {smem, smem + plan.buf};
  T* hi_buf = smem + 2 * plan.buf;
  load_band<T, Circular>(lo_buf[d & 1], in.lo + static_cast<int64_t>(row) * plan.len[d],
                         c[d], e[d] - c[d] + 1, plan.len[d]);
  for (int l = d; l >= 1; --l) {
    load_band<T, Circular>(hi_buf, in.hi[l - 1] + static_cast<int64_t>(row) * plan.len[l],
                           c[l], e[l] - c[l] + 1, plan.len[l]);
    __syncthreads();
    const T* lo = lo_buf[l & 1];
    T* nxt = lo_buf[(l - 1) & 1];
    const int off = plan.off[l];
    const int count = e[l - 1] - c[l - 1] + 1;
    for (int j = threadIdx.x; j < count; j += blockDim.x) {
      const int t = c[l - 1] + j;
      const int f = t + off;
      T acc = T(0);
      // out[t] = sum over taps k with f - k even of
      //          rec_lo[k] lo[(f - k) / 2] + rec_hi[k] hi[(f - k) / 2]
      for (int k = f & 1; k < len; k += 2) {
        const int q = ((f - k) >> 1) - c[l];  // f - k is even: exact
        acc += taps.lo[k] * lo[q] + taps.hi[k] * hi_buf[q];
      }
      if (l > 1) {
        if (!Circular && (t < 0 || t >= plan.len[l - 1])) acc = T(0);
        nxt[j] = acc;
      } else if (t < plan.len[0]) {
        out[static_cast<int64_t>(row) * plan.len[0] + t] = acc;
      }
    }
    __syncthreads();
  }
}

// Shared memory (elements) an analysis launch needs: the tile's level-0
// and level-1 cones (levels alternate between them), or the edge block's
// strips of two levels.
static int64_t analysis_smem(const AnalysisPlan& p, int len) {
  int64_t c0 = (int64_t(p.tile) << p.depth) + int64_t(len - 2) * ((1 << p.depth) - 1);
  int64_t c1 = p.depth > 1
                   ? (int64_t(p.tile) << (p.depth - 1)) +
                         int64_t(len - 2) * ((1 << (p.depth - 1)) - 1)
                   : 0;
  int64_t edge = p.edge ? 3 * (int64_t(p.strip) << p.depth) : 0;
  return c0 + c1 > edge ? c0 + c1 : edge;
}

static bool analysis_plan_ok(const AnalysisPlan& p, int len, int64_t rows) {
  if (p.depth < 1 || p.depth > FWT1D_MAX_DEPTH || p.n < 1 || p.tile < 1 ||
      p.tiles < 1 || len < 2 || len > PTWT_MAX_TAPS || rows < 1)
    return false;
  if ((int64_t(p.tiles) + p.edge) * rows >= (int64_t(1) << 31)) return false;
  for (int l = 1; l <= p.depth; ++l) {
    if (p.m[l] < 1) return false;
    if (p.edge && (p.strip << (p.depth - l)) > p.m[l]) return false;
  }
  return !p.edge || (p.strip << p.depth) <= p.n;
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
      static_cast<const T*>(x), out, make_taps<T>(lo, hi, len), len, plan);
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
  const unsigned blocks = static_cast<unsigned>(plan.tiles * rows);
  kernel<<<blocks, PTWT_THREADS, smem, stream>>>(
      in, static_cast<T*>(out), make_taps<T>(rlo, rhi, len), len, plan);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = float64.  `plan` holds the AnalysisPlan fields
// in declaration order (8 + 3 * 5 ints).  circular = 1 runs K6a (no edge
// block), 0 runs K8a.  Returns a cudaError_t after the launch, or
// PTWT_BAD_ARGUMENT.
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

// `plan` holds the SynthesisPlan fields in declaration order (4 + 2 * 5
// ints).  circular = 1 runs K6b, 0 runs K8b.
extern "C" int ptwt_fwt1d_synthesis(int dtype, const void* lo_in,
                                    const void* hi1, const void* hi2,
                                    const void* hi3, const void* hi4, void* out,
                                    const double* rlo, const double* rhi,
                                    int len, long long rows,
                                    const int* plan_ints, int circular,
                                    int smem_bytes, void* stream) {
  SynthesisPlan plan;
  std::memcpy(&plan, plan_ints, sizeof(plan));
  if (plan.depth < 1 || plan.depth > FWT1D_MAX_DEPTH || plan.tile < 1 ||
      plan.tiles < 1 || plan.buf < 1 || len < 2 || len > PTWT_MAX_TAPS ||
      rows < 1 || int64_t(plan.tiles) * rows >= (int64_t(1) << 31) ||
      dtype < 0 || dtype > 1)
    return PTWT_BAD_ARGUMENT;
  for (int l = 0; l <= plan.depth; ++l)
    if (plan.len[l] < 1) return PTWT_BAD_ARGUMENT;
  if (smem_bytes < int64_t(3) * plan.buf * (dtype ? 8 : 4) || smem_bytes > FWT1D_SMEM_LIMIT)
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
