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
// Bound on the H100: bytes.  K1 reads the image once and writes four
// quarter-size bands; K2 the mirror image.  The len x len gather per
// output is served from L1/L2 (neighbouring threads share all but two
// columns of their window), and warps read along the contiguous W axis.
// A shared-memory tile of the W pass feeding the H pass is the next step.
#include "common.cuh"

template <typename T>
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
    const int r = wrap_index(2 * i - pad + ka, per_h, h);
    const T* line = img + static_cast<int64_t>(r) * w;
    T row_lo = T(0), row_hi = T(0);
    for (int kb = 0; kb < len; ++kb) {
      const T v = line[wrap_index(2 * j - pad + kb, per_w, w)];
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

template <typename T>
__global__ void idwt2_kernel(const Bands2d<T> bands, T* __restrict__ out,
                             const __grid_constant__ Taps<T> taps, int len,
                             unsigned batch, int m_h, int m_w, int out_h,
                             int out_w, int off_h, int off_w, int circular) {
  const unsigned total =
      batch * static_cast<unsigned>(out_h) * static_cast<unsigned>(out_w);
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int v = static_cast<int>(idx % static_cast<unsigned>(out_w));
  const unsigned row = idx / static_cast<unsigned>(out_w);
  const int u = static_cast<int>(row % static_cast<unsigned>(out_h));
  const unsigned b = row / static_cast<unsigned>(out_h);
  const int64_t band0 = static_cast<int64_t>(b) * m_h * m_w;
  const int fu = u + off_h;
  const int fv = v + off_w;
  T acc = T(0);
  for (int ka = fu & 1; ka < len; ka += 2) {
    int qa = (fu - ka) >> 1;
    if (circular) {
      qa = wrap_index(qa, m_h, m_h);
    } else if (qa < 0 || qa >= m_h) {
      continue;
    }
    const int64_t line = band0 + static_cast<int64_t>(qa) * m_w;
    T h_lo = T(0), h_hi = T(0);  // lo / hi on H, summed over W
    for (int kb = fv & 1; kb < len; kb += 2) {
      int qb = (fv - kb) >> 1;
      if (circular) {
        qb = wrap_index(qb, m_w, m_w);
      } else if (qb < 0 || qb >= m_w) {
        continue;
      }
      const int64_t at = line + qb;
      h_lo += taps.lo[kb] * bands.ll[at] + taps.hi[kb] * bands.hl[at];
      h_hi += taps.lo[kb] * bands.lh[at] + taps.hi[kb] * bands.hh[at];
    }
    acc += taps.lo[ka] * h_lo + taps.hi[ka] * h_hi;
  }
  out[idx] = acc;
}

template <typename T>
static int launch_dwt2(const void* x, void* out, const double* lo,
                       const double* hi, int len, long long batch, int h,
                       int w, int per_h, int per_w, int m_h, int m_w, int pad,
                       cudaStream_t stream) {
  const int64_t plane = batch * static_cast<int64_t>(m_h) * m_w;
  dwt2_kernel<T><<<grid_size(plane), PTWT_THREADS, 0, stream>>>(
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
                        int circular, cudaStream_t stream) {
  Bands2d<T> bands;
  bands.ll = static_cast<const T*>(ll);
  bands.lh = static_cast<const T*>(lh);
  bands.hl = static_cast<const T*>(hl);
  bands.hh = static_cast<const T*>(hh);
  const int64_t total = batch * static_cast<int64_t>(out_h) * out_w;
  idwt2_kernel<T><<<grid_size(total), PTWT_THREADS, 0, stream>>>(
      bands, static_cast<T*>(out), make_taps<T>(lo, hi, len), len,
      static_cast<unsigned>(batch), m_h, m_w, out_h, out_w, off_h, off_w,
      circular);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = float64.  Returns a cudaError_t after the launch,
// or PTWT_BAD_ARGUMENT.
extern "C" int ptwt_dwt2(int dtype, const void* x, void* out,
                         const double* lo, const double* hi, int len,
                         long long batch, int h, int w, int per_h, int per_w,
                         int m_h, int m_w, int pad, void* stream) {
  if (!sizes_ok(len, 4 * batch * static_cast<int64_t>(m_h) * m_w) ||
      h < 1 || w < 1 || per_h < h || per_w < w)
    return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dwt2<float>(x, out, lo, hi, len, batch, h, w, per_h, per_w,
                              m_h, m_w, pad, s);
  if (dtype == 1)
    return launch_dwt2<double>(x, out, lo, hi, len, batch, h, w, per_h,
                               per_w, m_h, m_w, pad, s);
  return PTWT_BAD_ARGUMENT;
}

extern "C" int ptwt_idwt2(int dtype, const void* ll, const void* lh,
                          const void* hl, const void* hh, void* out,
                          const double* lo, const double* hi, int len,
                          long long batch, int m_h, int m_w, int out_h,
                          int out_w, int off_h, int off_w, int circular,
                          void* stream) {
  if (!sizes_ok(len, batch * static_cast<int64_t>(out_h) * out_w) ||
      m_h < 1 || m_w < 1 || off_h < 0 || off_w < 0)
    return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_idwt2<float>(ll, lh, hl, hh, out, lo, hi, len, batch, m_h,
                               m_w, out_h, out_w, off_h, off_w, circular, s);
  if (dtype == 1)
    return launch_idwt2<double>(ll, lh, hl, hh, out, lo, hi, len, batch, m_h,
                                m_w, out_h, out_w, off_h, off_w, circular, s);
  return PTWT_BAD_ARGUMENT;
}
