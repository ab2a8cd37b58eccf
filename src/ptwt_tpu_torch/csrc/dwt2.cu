// K1 and K2: one circular 2d filter-bank level over both spatial axes.
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
//   (half == m, per == out) K2 runs its forward code unchanged.
// * K2's VJP is K1's read with pad = off: circular for periodization, and
//   zero outside [0, n) for the cropped periodic synthesis (the transpose
//   of a crop folded into the index range is a zero-bounded correlation).
//
// Bound on the H100: bytes.  K1 reads the image once and writes four
// quarter-size bands; K2 the mirror image.  The len x len gather per
// output is served from L1/L2 (neighbouring threads share all but two
// columns of their window), and warps read along the contiguous W axis.
// A shared-memory tile of the W pass feeding the H pass is the next step.
#include "common.cuh"

template <typename T, bool ZERO_BOUNDED>
__global__ void dwt2_kernel(const T* __restrict__ x, T* __restrict__ out,
                            const __grid_constant__ Taps<T> taps, int len,
                            unsigned batch, int h, int w, int per_h,
                            int per_w, int m_h, int m_w, int pad) {
  const unsigned plane =
      batch * static_cast<unsigned>(m_h) * static_cast<unsigned>(m_w);
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const int j = static_cast<int>(idx % static_cast<unsigned>(m_w));
  const unsigned row = idx / static_cast<unsigned>(m_w);
  const int i = static_cast<int>(row % static_cast<unsigned>(m_h));
  const unsigned b = row / static_cast<unsigned>(m_h);
  const T* img = x + static_cast<int64_t>(b) * h * w;
  T ll = T(0), lh = T(0), hl = T(0), hh = T(0);
  for (int ka = 0; ka < len; ++ka) {
    int r = 2 * i - pad + ka;
    if constexpr (ZERO_BOUNDED) {
      if (r < 0 || r >= h) continue;
    } else {
      r = wrap_index(r, per_h, h);
    }
    const T* line = img + static_cast<int64_t>(r) * w;
    T row_lo = T(0), row_hi = T(0);
    for (int kb = 0; kb < len; ++kb) {
      int c = 2 * j - pad + kb;
      if constexpr (ZERO_BOUNDED) {
        if (c < 0 || c >= w) continue;
      } else {
        c = wrap_index(c, per_w, w);
      }
      const T v = line[c];
      row_lo += taps.lo[kb] * v;
      row_hi += taps.hi[kb] * v;
    }
    // lh is hi on H (the first spatial axis), lo on W
    ll += taps.lo[ka] * row_lo;
    lh += taps.hi[ka] * row_lo;
    hl += taps.lo[ka] * row_hi;
    hh += taps.hi[ka] * row_hi;
  }
  out[idx] = ll;
  out[static_cast<int64_t>(plane) + idx] = lh;
  out[2 * static_cast<int64_t>(plane) + idx] = hl;
  out[3 * static_cast<int64_t>(plane) + idx] = hh;
}

template <typename T>
struct Bands2d {
  const T* ll;
  const T* lh;
  const T* hl;
  const T* hh;
};

// Band rows and columns of a K2 launch: read modulo half_* when circular;
// with FOLD, each read also collects the rows + half, + 2 half, ... < m and
// the last output row and column collect the positions [out, per).
struct Fold2d {
  int half_h, half_w, per_h, per_w;
};

// Sum of one output position (fu, fv) = (u + off_h, v + off_w).
template <typename T, bool FOLD>
__device__ __forceinline__ T idwt2_at(const Bands2d<T> bands,
                                      const Taps<T>& taps, int len,
                                      int64_t band0, int m_h, int m_w,
                                      int fu, int fv, int circular,
                                      const Fold2d fold) {
  const int half_h = FOLD ? fold.half_h : m_h;
  const int half_w = FOLD ? fold.half_w : m_w;
  T acc = T(0);
  for (int ka = fu & 1; ka < len; ka += 2) {
    int qa = (fu - ka) >> 1;
    if (circular) {
      qa = wrap_index(qa, half_h, half_h);
    } else if (qa < 0 || qa >= m_h) {
      continue;
    }
    T h_lo = T(0), h_hi = T(0);  // lo / hi on H, summed over W
    for (int ra = qa; ra < m_h; ra += half_h) {
      const int64_t line = band0 + static_cast<int64_t>(ra) * m_w;
      for (int kb = fv & 1; kb < len; kb += 2) {
        int qb = (fv - kb) >> 1;
        if (circular) {
          qb = wrap_index(qb, half_w, half_w);
        } else if (qb < 0 || qb >= m_w) {
          continue;
        }
        for (int rb = qb; rb < m_w; rb += half_w) {
          const int64_t at = line + rb;
          h_lo += taps.lo[kb] * bands.ll[at] + taps.hi[kb] * bands.hl[at];
          h_hi += taps.lo[kb] * bands.lh[at] + taps.hi[kb] * bands.hh[at];
          if constexpr (!FOLD) break;
        }
      }
      if constexpr (!FOLD) break;
    }
    acc += taps.lo[ka] * h_lo + taps.hi[ka] * h_hi;
  }
  return acc;
}

template <typename T, bool FOLD>
__global__ void idwt2_kernel(const Bands2d<T> bands, T* __restrict__ out,
                             const __grid_constant__ Taps<T> taps, int len,
                             unsigned batch, int m_h, int m_w, int out_h,
                             int out_w, int off_h, int off_w, int circular,
                             Fold2d fold) {
  const unsigned total =
      batch * static_cast<unsigned>(out_h) * static_cast<unsigned>(out_w);
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int v = static_cast<int>(idx % static_cast<unsigned>(out_w));
  const unsigned row = idx / static_cast<unsigned>(out_w);
  const int u = static_cast<int>(row % static_cast<unsigned>(out_h));
  const unsigned b = row / static_cast<unsigned>(out_h);
  const int64_t band0 = static_cast<int64_t>(b) * m_h * m_w;
  if constexpr (!FOLD) {
    out[idx] = idwt2_at<T, false>(bands, taps, len, band0, m_h, m_w,
                                  u + off_h, v + off_w, circular, fold);
  } else {
    const int u_end = u == out_h - 1 ? fold.per_h : u + 1;
    const int v_end = v == out_w - 1 ? fold.per_w : v + 1;
    T acc = T(0);
    for (int pu = u; pu < u_end; ++pu)
      for (int pv = v; pv < v_end; ++pv)
        acc += idwt2_at<T, true>(bands, taps, len, band0, m_h, m_w,
                                 pu + off_h, pv + off_w, circular, fold);
    out[idx] = acc;
  }
}

template <typename T>
static int launch_dwt2(const void* x, void* out, const double* lo,
                       const double* hi, int len, long long batch, int h,
                       int w, int per_h, int per_w, int m_h, int m_w, int pad,
                       int circular, cudaStream_t stream) {
  const int64_t plane = batch * static_cast<int64_t>(m_h) * m_w;
  auto kernel = circular ? dwt2_kernel<T, false> : dwt2_kernel<T, true>;
  kernel<<<grid_size(plane), PTWT_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      make_taps<T>(lo, hi, len), len, static_cast<unsigned>(batch), h, w,
      per_h, per_w, m_h, m_w, pad);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_idwt2(const void* ll, const void* lh, const void* hl,
                        const void* hh, void* out, const double* lo,
                        const double* hi, int len, long long batch, int m_h,
                        int m_w, int out_h, int out_w, int off_h, int off_w,
                        int circular, Fold2d fold, cudaStream_t stream) {
  Bands2d<T> bands;
  bands.ll = static_cast<const T*>(ll);
  bands.lh = static_cast<const T*>(lh);
  bands.hl = static_cast<const T*>(hl);
  bands.hh = static_cast<const T*>(hh);
  const bool folds = fold.half_h != m_h || fold.half_w != m_w ||
                     fold.per_h != out_h || fold.per_w != out_w;
  auto kernel = folds ? idwt2_kernel<T, true> : idwt2_kernel<T, false>;
  const int64_t total = batch * static_cast<int64_t>(out_h) * out_w;
  kernel<<<grid_size(total), PTWT_THREADS, 0, stream>>>(
      bands, static_cast<T*>(out), make_taps<T>(lo, hi, len), len,
      static_cast<unsigned>(batch), m_h, m_w, out_h, out_w, off_h, off_w,
      circular, fold);
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
      h < 1 || w < 1 || (circular && (per_h < h || per_w < w)))
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
