// K5a and K5b: the 2d periodization pyramid of wavedec2/waverec2.
//
// Replaces:
//   K5a  ptwt_tpu/ops/_pallas.py:_make_wavedec2d_kernel (with the quadrant
//        layout _fused_wavedec2d_impl slices the bands out of);
//   K5b  ptwt_tpu/ops/_pallas.py:_make_waverec2d_kernel (with the concat
//        cascade _fused_waverec2d_impl packs the bands with).
//
// Bound on the H100: bytes.  A run of D levels reads the image once and
// writes each band once (about 2x the image's bytes in all); each output
// costs L multiply-adds per pass, far below the card's ops/byte balance.
//
// Design.  The Pallas kernels held a whole [h, w] image in VMEM, ran each
// level's taps as pltpu.roll shifts and unshuffled the phases, and packed
// the pyramid into one quadrant layout.  Here every band has a tensor of
// its own, and a block owns a tile:
//
// * Analysis (K5a): a block owns a th x tw tile of the run's deepest band.
//   Along each axis its cone at level l - 1 starts at s_{l-1} = 2 s_l - pad
//   and is 2 c_l + L - 2 long, so the block loads the level-0 cone (read
//   modulo h and w) into shared memory once and computes the levels in
//   turn: a row pass (W) into lo_w/hi_w, then a column pass (H) into ll
//   (kept as the next level's cone) and lh/hl/hh.  On an exactly halving
//   chain every level is periodic in its own size, so every cone value is
//   exact and no edge pass is needed.  Tiles are aligned at the deepest
//   level: the block owns (th << (D - l)) x (tw << (D - l)) positions of
//   level l and writes those of lh/hl/hh at every level, and ll only at
//   level D, so every band position has exactly one owner.
// * Synthesis (K5b): a block owns a th x tw tile of the run's finest
//   output.  Step l reads ll_l (from the step before, or loaded at l = D)
//   and lh_l/hl_l/hh_l over [c_l, e_l] per axis with c_l = floor((c_{l-1}
//   + pad - (L - 1)) / 2), e_l = floor((e_{l-1} + pad) / 2), modulo the
//   band's size; an H pass synthesises (ll, lh) -> lo_w and (hl, hh) ->
//   hi_w, then a W pass (lo_w, hi_w) -> ll_{l-1}.  Periodization needs no
//   crop.
// * Whole image: where the image and its working buffers fit in shared
//   memory, one block holds the whole image (no halo), reads it modulo
//   inside shared memory, and runs every level of the run in one launch:
//   the JAX package's K5 design, for small images.
//
// Band names follow SUBBAND_ORDERS: lh = hi along H (rows), hl = hi along W.
#include <cstring>

#include "common.cuh"

#define PYR2D_MAX_DEPTH 8
#define PYR2D_SMEM_LIMIT 232448
#define PYR2D_THREADS 512

// The plan arrives as an int array from the Python wrappers, in this order.
struct Pyramid2dPlan {
  int depth;             // levels of this run
  int h, w;              // the run's finest image: analysis input, synthesis output
  int th, tw;            // a block's tile: level-depth positions (analysis) or outputs (synthesis)
  int tiles_h, tiles_w;  // tiles per image along H and W
  int whole;             // 1: one block holds the whole image, reads modulo in shared memory
  int pad;               // L / 2 - 1
  int buf_a, buf_b;      // shared-memory regions in elements (see *_need below)
};

static_assert(sizeof(Pyramid2dPlan) == 11 * sizeof(int), "Pyramid2dPlan is the wrappers' int array");

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

__device__ __forceinline__ int wrap_pos(int p, int m) {
  int q = p % m;
  return q < 0 ? q + m : q;
}

// Length along one axis of an analysis tile's cone at level l, for a tile
// of t level-d positions.
__host__ __device__ __forceinline__ int cone_len(int t, int d, int l, int len) {
  return (t << (d - l)) + (len - 2) * ((1 << (d - l)) - 1);
}

// dst[r, c] = src[(r0 + r) mod mh, (c0 + c) mod mw] for an nr x nc block.
// Each thread keeps PYR2D_LOADS loads in flight before it stores them:
// with one or two blocks per SM, one load at a time leaves the block
// waiting on device-memory latency.
#define PYR2D_LOADS 8
template <typename T>
__device__ __forceinline__ void load_block(T* dst, const T* __restrict__ src, int r0, int nr,
                                           int c0, int nc, int mh, int mw) {
  const int total = nr * nc;
  for (int base = threadIdx.x; base < total; base += PYR2D_LOADS * blockDim.x) {
    T v[PYR2D_LOADS];
#pragma unroll
    for (int u = 0; u < PYR2D_LOADS; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) {
        const int r = idx / nc;
        const int c = idx - r * nc;
        v[u] = __ldg(src + static_cast<int64_t>(wrap_pos(r0 + r, mh)) * mw + wrap_pos(c0 + c, mw));
      }
    }
#pragma unroll
    for (int u = 0; u < PYR2D_LOADS; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) dst[idx] = v[u];
    }
  }
}

template <typename T, bool Whole>
__global__ void __launch_bounds__(PYR2D_THREADS)
    pyramid2d_analysis_kernel(const T* __restrict__ x, const Pyramid2dOut<T> out,
                              const __grid_constant__ Taps<T> taps, int len,
                              const Pyramid2dPlan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cone = reinterpret_cast<T*>(smem_raw);  // level l - 1, ch[l-1] x cw[l-1]
  T* lo_w = cone + plan.buf_a;                // row pass, ch[l-1] x cw[l]
  T* hi_w = lo_w + plan.buf_b;
  const int tiles = plan.tiles_h * plan.tiles_w;
  const int img = blockIdx.x / tiles;
  const int tile = blockIdx.x - img * tiles;
  const int ty = tile / plan.tiles_w;
  const int tx = tile - ty * plan.tiles_w;
  const int d = plan.depth;
  int sh[PYR2D_MAX_DEPTH + 1], ch[PYR2D_MAX_DEPTH + 1];
  int sw[PYR2D_MAX_DEPTH + 1], cw[PYR2D_MAX_DEPTH + 1];
  sh[d] = ty * plan.th;
  ch[d] = plan.th;
  sw[d] = tx * plan.tw;
  cw[d] = plan.tw;
  for (int l = d; l > 0; --l) {
    if (Whole) {
      sh[l - 1] = 0;
      ch[l - 1] = plan.h >> (l - 1);
      sw[l - 1] = 0;
      cw[l - 1] = plan.w >> (l - 1);
    } else {
      sh[l - 1] = 2 * sh[l] - plan.pad;
      ch[l - 1] = 2 * ch[l] + len - 2;
      sw[l - 1] = 2 * sw[l] - plan.pad;
      cw[l - 1] = 2 * cw[l] + len - 2;
    }
  }
  load_block<T>(cone, x + static_cast<int64_t>(img) * plan.h * plan.w, sh[0], ch[0], sw[0],
                cw[0], plan.h, plan.w);
  __syncthreads();
  for (int l = 1; l <= d; ++l) {
    const int in_w = cw[l - 1];
    const int out_h = ch[l], out_w = cw[l];
    const int bh = plan.h >> (l - 1), bw = plan.w >> (l - 1);  // level l - 1 size
    // row pass (W): lo_w / hi_w over the cone's rows and level-l columns
    for (int idx = threadIdx.x; idx < ch[l - 1] * out_w; idx += blockDim.x) {
      const int r = idx / out_w;
      const int j = idx - r * out_w;
      const T* src = cone + r * in_w;
      T lo = T(0), hi = T(0);
      int c = Whole ? wrap_pos(2 * j - plan.pad, bw) : 2 * j;
      for (int k = 0; k < len; ++k) {
        const T v = src[c];
        lo += taps.lo[k] * v;
        hi += taps.hi[k] * v;
        if (++c == bw && Whole) c = 0;
      }
      lo_w[idx] = lo;
      hi_w[idx] = hi;
    }
    __syncthreads();
    // column pass (H): ll into the cone for level l + 1, the owned details out
    const int mh = plan.h >> l, mw = plan.w >> l;
    const int own_h = plan.th << (d - l), own_w = plan.tw << (d - l);
    const int first_h = ty * own_h, last_h = min(first_h + own_h, mh);
    const int first_w = tx * own_w, last_w = min(first_w + own_w, mw);
    const int64_t band = static_cast<int64_t>(img) * mh * mw;
    T* lh_out = out.det[3 * (l - 1)] + band;
    T* hl_out = out.det[3 * (l - 1) + 1] + band;
    T* hh_out = out.det[3 * (l - 1) + 2] + band;
    for (int idx = threadIdx.x; idx < out_h * out_w; idx += blockDim.x) {
      const int i = idx / out_w;
      const int j = idx - i * out_w;
      const int gi = sh[l] + i, gj = sw[l] + j;
      const bool owned = gi >= first_h && gi < last_h && gj >= first_w && gj < last_w;
      if (!owned && l == d) continue;
      int r = Whole ? wrap_pos(2 * i - plan.pad, bh) : 2 * i;
      T ll = T(0);
      if (owned) {
        T lh = T(0), hl = T(0), hh = T(0);
        for (int k = 0; k < len; ++k) {
          const T a = lo_w[r * out_w + j];
          const T b = hi_w[r * out_w + j];
          ll += taps.lo[k] * a;
          lh += taps.hi[k] * a;
          hl += taps.lo[k] * b;
          hh += taps.hi[k] * b;
          if (++r == bh && Whole) r = 0;
        }
        const int64_t at = static_cast<int64_t>(gi) * mw + gj;
        lh_out[at] = lh;
        hl_out[at] = hl;
        hh_out[at] = hh;
        if (l == d) out.ll[band + at] = ll;
      } else {
        for (int k = 0; k < len; ++k) {
          ll += taps.lo[k] * lo_w[r * out_w + j];
          if (++r == bh && Whole) r = 0;
        }
      }
      if (l < d) cone[idx] = ll;
    }
    __syncthreads();
  }
}

template <typename T, bool Whole>
__global__ void __launch_bounds__(PYR2D_THREADS)
    pyramid2d_synthesis_kernel(const Pyramid2dIn<T> in, T* __restrict__ out,
                               const __grid_constant__ Taps<T> taps, int len,
                               const Pyramid2dPlan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* const ll = smem;  // ll, lh, hl, hh of step l: buf_a each
  T* const lh = smem + plan.buf_a;
  T* const hl = smem + 2 * plan.buf_a;
  T* const hh = smem + 3 * plan.buf_a;
  T* const lo_w = smem + 4 * plan.buf_a;  // H pass: buf_b each
  T* const hi_w = lo_w + plan.buf_b;
  const int tiles = plan.tiles_h * plan.tiles_w;
  const int img = blockIdx.x / tiles;
  const int tile = blockIdx.x - img * tiles;
  const int ty = tile / plan.tiles_w;
  const int tx = tile - ty * plan.tiles_w;
  const int d = plan.depth;
  // rows [ch[l], eh[l]] and columns [cw[l], ew[l]] of level l this tile reads
  int ch[PYR2D_MAX_DEPTH + 1], eh[PYR2D_MAX_DEPTH + 1];
  int cw[PYR2D_MAX_DEPTH + 1], ew[PYR2D_MAX_DEPTH + 1];
  ch[0] = ty * plan.th;
  eh[0] = ch[0] + plan.th - 1;
  cw[0] = tx * plan.tw;
  ew[0] = cw[0] + plan.tw - 1;
  for (int l = 1; l <= d; ++l) {
    if (Whole) {
      ch[l] = 0;
      eh[l] = (plan.h >> l) - 1;
      cw[l] = 0;
      ew[l] = (plan.w >> l) - 1;
    } else {
      ch[l] = floor_half2(ch[l - 1] + plan.pad - (len - 1));
      eh[l] = floor_half2(eh[l - 1] + plan.pad);
      cw[l] = floor_half2(cw[l - 1] + plan.pad - (len - 1));
      ew[l] = floor_half2(ew[l - 1] + plan.pad);
    }
  }
  {
    const int mh = plan.h >> d, mw = plan.w >> d;
    load_block<T>(ll, in.ll + static_cast<int64_t>(img) * mh * mw, ch[d], eh[d] - ch[d] + 1,
                  cw[d], ew[d] - cw[d] + 1, mh, mw);
  }
  for (int l = d; l >= 1; --l) {
    const int mh = plan.h >> l, mw = plan.w >> l;
    const int nh = eh[l] - ch[l] + 1, nw = ew[l] - cw[l] + 1;
    const int oh = eh[l - 1] - ch[l - 1] + 1, ow = ew[l - 1] - cw[l - 1] + 1;
    const int64_t band = static_cast<int64_t>(img) * mh * mw;
    load_block<T>(lh, in.det[3 * (l - 1)] + band, ch[l], nh, cw[l], nw, mh, mw);
    load_block<T>(hl, in.det[3 * (l - 1) + 1] + band, ch[l], nh, cw[l], nw, mh, mw);
    load_block<T>(hh, in.det[3 * (l - 1) + 2] + band, ch[l], nh, cw[l], nw, mh, mw);
    __syncthreads();
    // H pass: (ll, lh) -> lo_w and (hl, hh) -> hi_w, oh x nw
    for (int idx = threadIdx.x; idx < oh * nw; idx += blockDim.x) {
      const int t = idx / nw;
      const int j = idx - t * nw;
      // row t of level l - 1 sums taps k with f - k even of band[(f - k) / 2]
      const int f = ch[l - 1] + t + plan.pad;
      int k = f & 1;
      int q = Whole ? wrap_pos((f - k) >> 1, mh) : ((f - k) >> 1) - ch[l];
      T lo = T(0), hi = T(0);
      for (; k < len; k += 2) {
        const int at = q * nw + j;
        lo += taps.lo[k] * ll[at] + taps.hi[k] * lh[at];
        hi += taps.lo[k] * hl[at] + taps.hi[k] * hh[at];
        if (--q < 0 && Whole) q = mh - 1;
      }
      lo_w[idx] = lo;
      hi_w[idx] = hi;
    }
    __syncthreads();
    // W pass: (lo_w, hi_w) -> ll of level l - 1, oh x ow
    for (int idx = threadIdx.x; idx < oh * ow; idx += blockDim.x) {
      const int t = idx / ow;
      const int u = idx - t * ow;
      const int f = cw[l - 1] + u + plan.pad;
      int k = f & 1;
      int q = Whole ? wrap_pos((f - k) >> 1, mw) : ((f - k) >> 1) - cw[l];
      const T* lo_row = lo_w + t * nw;
      const T* hi_row = hi_w + t * nw;
      T acc = T(0);
      for (; k < len; k += 2) {
        acc += taps.lo[k] * lo_row[q] + taps.hi[k] * hi_row[q];
        if (--q < 0 && Whole) q = mw - 1;
      }
      if (l > 1) {
        ll[idx] = acc;
      } else {
        const int gr = ch[0] + t, gc = cw[0] + u;
        if (gr < plan.h && gc < plan.w)
          out[static_cast<int64_t>(img) * plan.h * plan.w + static_cast<int64_t>(gr) * plan.w + gc] = acc;
      }
    }
    __syncthreads();
  }
}

// Shared memory (elements) of an analysis launch: the level-0 cone, and
// the row pass's lo_w and hi_w at level 1 (both shrink with the level).
static void analysis_need(const Pyramid2dPlan& p, int len, int64_t* a, int64_t* b) {
  int64_t ch0, cw0, cw1;
  if (p.whole) {
    ch0 = p.h;
    cw0 = p.w;
    cw1 = p.w / 2;
  } else {
    ch0 = cone_len(p.th, p.depth, 0, len);
    cw0 = cone_len(p.tw, p.depth, 0, len);
    cw1 = cone_len(p.tw, p.depth, 1, len);
  }
  *a = ch0 * cw0;
  *b = ch0 * cw1;
}

// Shared memory (elements) of a synthesis launch: one band slot (the
// largest step's band block) and one H-pass buffer.  A tile's read range
// grows by at most (n + L - 1) / 2 + 1 per step.
static void synthesis_need(const Pyramid2dPlan& p, int len, int64_t* a, int64_t* b) {
  int64_t nh[PYR2D_MAX_DEPTH + 1], nw[PYR2D_MAX_DEPTH + 1];
  nh[0] = p.whole ? p.h : p.th;
  nw[0] = p.whole ? p.w : p.tw;
  *a = 0;
  *b = 0;
  for (int l = 1; l <= p.depth; ++l) {
    nh[l] = p.whole ? (p.h >> l) : (nh[l - 1] + len - 1) / 2 + 1;
    nw[l] = p.whole ? (p.w >> l) : (nw[l - 1] + len - 1) / 2 + 1;
    if (nh[l] * nw[l] > *a) *a = nh[l] * nw[l];
    if (nh[l - 1] * nw[l] > *b) *b = nh[l - 1] * nw[l];
  }
}

static bool plan_ok(const Pyramid2dPlan& p, int len, long long batch, bool synthesis) {
  if (p.depth < 1 || p.depth > PYR2D_MAX_DEPTH || p.h < 1 || p.w < 1 || p.th < 1 ||
      p.tw < 1 || p.tiles_h < 1 || p.tiles_w < 1 || len < 2 || len > PTWT_MAX_TAPS ||
      batch < 1 || p.pad != len / 2 - 1)
    return false;
  if (p.h % (1 << p.depth) || p.w % (1 << p.depth)) return false;
  // the extent the tiles cover: the deepest band (analysis), the output (synthesis)
  const int eh = synthesis ? p.h : p.h >> p.depth;
  const int ew = synthesis ? p.w : p.w >> p.depth;
  if (int64_t(p.tiles_h) * p.th < eh || int64_t(p.tiles_w) * p.tw < ew) return false;
  if (p.whole && (p.tiles_h != 1 || p.tiles_w != 1 || p.th != eh || p.tw != ew)) return false;
  return int64_t(p.tiles_h) * p.tiles_w * batch < (int64_t(1) << 31);
}

template <typename T, bool Whole>
static int launch_analysis(const void* x, void* ll, void* const* det, const double* lo,
                           const double* hi, int len, long long batch,
                           const Pyramid2dPlan& plan, int smem, cudaStream_t stream) {
  Pyramid2dOut<T> out;
  out.ll = static_cast<T*>(ll);
  for (int i = 0; i < 3 * PYR2D_MAX_DEPTH; ++i) out.det[i] = static_cast<T*>(det[i]);
  auto kernel = pyramid2d_analysis_kernel<T, Whole>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(int64_t(plan.tiles_h) * plan.tiles_w * batch);
  kernel<<<blocks, PYR2D_THREADS, smem, stream>>>(static_cast<const T*>(x), out,
                                                   make_taps<T>(lo, hi, len), len, plan);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool Whole>
static int launch_synthesis(const void* ll, const void* const* det, void* out,
                            const double* lo, const double* hi, int len, long long batch,
                            const Pyramid2dPlan& plan, int smem, cudaStream_t stream) {
  Pyramid2dIn<T> in;
  in.ll = static_cast<const T*>(ll);
  for (int i = 0; i < 3 * PYR2D_MAX_DEPTH; ++i) in.det[i] = static_cast<const T*>(det[i]);
  auto kernel = pyramid2d_synthesis_kernel<T, Whole>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(int64_t(plan.tiles_h) * plan.tiles_w * batch);
  kernel<<<blocks, PYR2D_THREADS, smem, stream>>>(in, static_cast<T*>(out),
                                                   make_taps<T>(lo, hi, len), len, plan);
  return static_cast<int>(cudaGetLastError());
}

static bool buffers_ok(const Pyramid2dPlan& plan, int64_t need_a, int64_t need_b, int slots,
                       int dtype, int smem_bytes) {
  if (plan.buf_a < need_a || plan.buf_b < need_b) return false;
  const int64_t bytes = (int64_t(slots) * plan.buf_a + 2 * int64_t(plan.buf_b)) * (dtype ? 8 : 4);
  return smem_bytes >= bytes && smem_bytes <= PYR2D_SMEM_LIMIT;
}

static bool details_ok(const void* const* det, int depth) {
  for (int i = 0; i < 3 * depth; ++i)
    if (!det[i]) return false;
  return true;
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
      !details_ok(det, plan.depth))
    return PTWT_BAD_ARGUMENT;
  int64_t need_a, need_b;
  analysis_need(plan, len, &need_a, &need_b);
  if (!buffers_ok(plan, need_a, need_b, 1, dtype, smem_bytes)) return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return plan.whole ? launch_analysis<float, true>(x, ll, det, lo, hi, len, batch, plan, smem_bytes, s)
                      : launch_analysis<float, false>(x, ll, det, lo, hi, len, batch, plan, smem_bytes, s);
  return plan.whole ? launch_analysis<double, true>(x, ll, det, lo, hi, len, batch, plan, smem_bytes, s)
                    : launch_analysis<double, false>(x, ll, det, lo, hi, len, batch, plan, smem_bytes, s);
}

// The inverse: ll_D and the details (the same order) -> [batch, h, w].
extern "C" int ptwt_pyramid2d_synthesis(int dtype, const void* ll, const void* const* det,
                                        void* out, const double* lo, const double* hi, int len,
                                        long long batch, const int* plan_ints, int smem_bytes,
                                        void* stream) {
  Pyramid2dPlan plan;
  std::memcpy(&plan, plan_ints, sizeof(plan));
  if (!plan_ok(plan, len, batch, true) || dtype < 0 || dtype > 1 || !ll || !out ||
      !details_ok(det, plan.depth))
    return PTWT_BAD_ARGUMENT;
  int64_t need_a, need_b;
  synthesis_need(plan, len, &need_a, &need_b);
  if (!buffers_ok(plan, need_a, need_b, 4, dtype, smem_bytes)) return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return plan.whole ? launch_synthesis<float, true>(ll, det, out, lo, hi, len, batch, plan, smem_bytes, s)
                      : launch_synthesis<float, false>(ll, det, out, lo, hi, len, batch, plan, smem_bytes, s);
  return plan.whole ? launch_synthesis<double, true>(ll, det, out, lo, hi, len, batch, plan, smem_bytes, s)
                    : launch_synthesis<double, false>(ll, det, out, lo, hi, len, batch, plan, smem_bytes, s);
}
