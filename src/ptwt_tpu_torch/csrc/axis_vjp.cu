// K3T and K4T: the VJPs of K3 and K4 (one filter-bank level along one axis).
//
// K3T replaces the Pallas kernel
// ptwt_tpu/ops/_pallas2.py:_analysis_transpose_kernel, K4T replaces
// ptwt_tpu/ops/_pallas2.py:_synthesis_transpose_kernel.
//
// The tensors are viewed as in axis.cu: [outer, n, inner] with the
// transformed axis in the middle.  The Pallas kernels roll phase buffers by
// the negated shifts; here both transposes are written in gather form, one
// thread per output of the VJP and no atomics, so every sum keeps one order
// from run to run:
//
// K3T: x_bar[u] = sum over the extended positions r that K3 read from u
//      (src(r) == u) and the taps k with i = (r + pad - k) / 2 in [0, m) of
//      lo[k] ct_lo[i] + hi[k] ct_hi[i].  On a circular axis the positions
//      are r = q + t * period for every t in range (a long filter on a
//      short axis wraps several periods), q = u, and for u == n - 1 also
//      every q in [n, period) (the adjoint of the clamp that repeats the
//      last sample of an odd periodization axis).  Off the circular modes
//      src is the identity over the padded signal.
// K4T: band_bar[q] = sum over the taps k and the outputs t that read band
//      row q, t = 2q + k - off: within [0, out_len) off the circular
//      modes, and every t congruent to it modulo 2m within [0, out_len)
//      on them (the crop makes out_len differ from 2m, so this is not a
//      plain modulo read).  lo and hi bands share each read of the
//      cotangent.
//
// Bound on the H100: bytes, like their forward twins.  Each output costs
// about len / 2 multiply-adds per band against one read of each cotangent
// sample and one write of each output.  The design keeps every input read
// once from device memory: neighbouring threads read overlapping windows of
// the cotangent, served by L1 and L2, and a warp's loads run along the
// fastest axis.  As in axis.cu, launches of 2^31 outputs or more run a
// 64-bit index instance.
#include "common.cuh"

template <typename T, typename I>
__global__ void analysis_axis_t_kernel(const T* __restrict__ ct,
                                       T* __restrict__ out,
                                       const __grid_constant__ Taps<T> taps,
                                       int len, I outer, int n,
                                       int period, int m, I inner,
                                       int pad, int circular) {
  const I total = outer * static_cast<I>(n) * inner;
  const I idx = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const I j = idx % inner;
  const I row = idx / inner;
  const int u = static_cast<int>(row % static_cast<I>(n));
  const I o = row / static_cast<I>(n);
  const int64_t band = static_cast<int64_t>(outer) * m * inner;
  const T* ct_lo = ct + (static_cast<int64_t>(o) * m) * inner + j;
  const T* ct_hi = ct_lo + band;
  // f = r + pad runs over [0, f_max] for the positions K3 read
  const int f_max = 2 * (m - 1) + len - 1;
  const int q_end = (circular && u == n - 1) ? period : u + 1;
  T acc = T(0);
  for (int q = u; q < q_end; ++q) {
    // the least f >= 0 of a position that maps to q, then every period
    int f = circular ? (q + pad) % period : q + pad;
    const int step = circular ? period : f_max + 1;
    for (; f <= f_max; f += step) {
      // taps of f's parity with i = (f - k) / 2 in [0, m)
      const int k0 = f - 2 * (m - 1) > 0 ? f - 2 * (m - 1) : (f & 1);
      const int k1 = f < len - 1 ? f : len - 1;
      for (int k = k0; k <= k1; k += 2) {
        const int64_t at = static_cast<int64_t>((f - k) >> 1) * inner;
        acc += taps.lo[k] * ct_lo[at] + taps.hi[k] * ct_hi[at];
      }
    }
  }
  out[idx] = acc;
}

template <typename T, typename I>
__global__ void synthesis_axis_t_kernel(const T* __restrict__ ct,
                                        T* __restrict__ out,
                                        const __grid_constant__ Taps<T> taps,
                                        int len, int groups, I outer,
                                        int m, int out_len, I inner,
                                        int off, int circular) {
  const I per_group = outer * static_cast<I>(m) * inner;
  const I idx = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= per_group * static_cast<I>(groups)) return;
  const I g = idx / per_group;
  const I rem = idx - g * per_group;
  const I j = rem % inner;
  const I row = rem / inner;
  const int q = static_cast<int>(row % static_cast<I>(m));
  const I o = row / static_cast<I>(m);
  const T* src = ct +
                 (static_cast<int64_t>(g) * outer + o) * out_len * inner + j;
  const int period = 2 * m;
  T lo = T(0), hi = T(0);
  for (int k = 0; k < len; ++k) {
    int t = 2 * q + k - off;
    if (circular) {
      t %= period;
      if (t < 0) t += period;
    } else if (t < 0) {
      continue;
    }
    for (; t < out_len; t += period) {
      const T v = src[static_cast<int64_t>(t) * inner];
      lo += taps.lo[k] * v;
      hi += taps.hi[k] * v;
      if (!circular) break;
    }
  }
  // [G, 2, outer, m, inner]: each group's lo_bar, then its hi_bar
  T* dst = out + static_cast<int64_t>(g) * 2 * per_group + rem;
  dst[0] = lo;
  dst[per_group] = hi;
}

template <typename T>
static int launch_analysis_t(const void* ct, void* out, const double* lo,
                             const double* hi, int len, long long outer,
                             int n, int period, int m, long long inner,
                             int pad, int circular, cudaStream_t stream) {
  const int64_t total = outer * static_cast<int64_t>(n) * inner;
  if (index32_ok(total))
    analysis_axis_t_kernel<T, unsigned><<<grid_size(total), PTWT_THREADS, 0, stream>>>(
        static_cast<const T*>(ct), static_cast<T*>(out),
        make_taps<T>(lo, hi, len), len, static_cast<unsigned>(outer), n,
        period, m, static_cast<unsigned>(inner), pad, circular);
  else
    analysis_axis_t_kernel<T, int64_t><<<grid_size(total), PTWT_THREADS, 0, stream>>>(
        static_cast<const T*>(ct), static_cast<T*>(out),
        make_taps<T>(lo, hi, len), len, outer, n, period, m, inner, pad,
        circular);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_synthesis_t(const void* ct, int groups, void* out,
                              const double* rlo, const double* rhi, int len,
                              long long outer, int m, int out_len,
                              long long inner, int off, int circular,
                              cudaStream_t stream) {
  const int64_t total = groups * outer * static_cast<int64_t>(m) * inner;
  if (index32_ok(total))
    synthesis_axis_t_kernel<T, unsigned><<<grid_size(total), PTWT_THREADS, 0, stream>>>(
        static_cast<const T*>(ct), static_cast<T*>(out),
        make_taps<T>(rlo, rhi, len), len, groups, static_cast<unsigned>(outer),
        m, out_len, static_cast<unsigned>(inner), off, circular);
  else
    synthesis_axis_t_kernel<T, int64_t><<<grid_size(total), PTWT_THREADS, 0, stream>>>(
        static_cast<const T*>(ct), static_cast<T*>(out),
        make_taps<T>(rlo, rhi, len), len, groups, outer, m, out_len, inner,
        off, circular);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = float64.  Returns a cudaError_t after the launch,
// or PTWT_BAD_ARGUMENT.  The arguments describe the forward launch whose
// VJP is taken: ct is its [2, outer, m, inner] output's cotangent, out the
// [outer, n, inner] input's.
extern "C" int ptwt_analysis_axis_t(int dtype, const void* ct, void* out,
                                    const double* lo, const double* hi,
                                    int len, long long outer, int n,
                                    int period, int m, long long inner,
                                    int pad, int circular, void* stream) {
  if (!sizes_ok(len, 2 * outer * static_cast<int64_t>(n) * inner) ||
      m < 1 || pad < 0 || (circular && period < n))
    return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_analysis_t<float>(ct, out, lo, hi, len, outer, n, period,
                                    m, inner, pad, circular, s);
  if (dtype == 1)
    return launch_analysis_t<double>(ct, out, lo, hi, len, outer, n, period,
                                     m, inner, pad, circular, s);
  return PTWT_BAD_ARGUMENT;
}

// ct is the [groups, outer, out_len, inner] output cotangent of a K4 launch,
// out the [groups, 2, outer, m, inner] cotangents of its (lo, hi) pairs.
extern "C" int ptwt_synthesis_axis_t(int dtype, const void* ct, int groups,
                                     void* out, const double* rlo,
                                     const double* rhi, int len,
                                     long long outer, int m, int out_len,
                                     long long inner, int off, int circular,
                                     void* stream) {
  if (groups < 1 || groups > 2 || out_len < 1 ||
      !sizes_ok(len, 2 * groups * outer * static_cast<int64_t>(m) * inner))
    return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_synthesis_t<float>(ct, groups, out, rlo, rhi, len, outer, m,
                                     out_len, inner, off, circular, s);
  if (dtype == 1)
    return launch_synthesis_t<double>(ct, groups, out, rlo, rhi, len, outer,
                                      m, out_len, inner, off, circular, s);
  return PTWT_BAD_ARGUMENT;
}
