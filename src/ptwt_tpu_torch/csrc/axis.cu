// K3 and K4: one filter-bank level along one axis.
//
// K3 replaces the Pallas kernel ptwt_tpu/ops/_pallas2.py:_analysis_kernel,
// K4 replaces ptwt_tpu/ops/_pallas2.py:_synthesis_kernel.
//
// The tensor is viewed as [outer, n, inner] with the transformed axis in
// the middle (inner == 1 for the last axis).  The Pallas kernels needed the
// signal split into even/odd phase buffers by XLA and a padded copy rolled
// in VMEM; here each thread computes one output sample straight from the
// strided source: K3 reads ext[2i + k - pad] (modulo the period for the
// circular modes, so no padded copy and no wrap copy of the periodic
// band), K4 computes out[t] of the stride-2 transposed convolution with
// the crop folded into its index range.
//
// Bound on the H100: bytes.  Each output costs len multiply-adds per band
// against one read of each input sample and one write of each output, far
// below the card's ops/byte balance.  The design keeps every input read
// once from device memory: the len taps a thread reads overlap those of
// its neighbours, so the reuse is served by L1 and L2, and a warp's loads
// are contiguous along the fastest axis (i for the last axis, the inner
// index otherwise).  Each kernel has a 32-bit index instance, which every
// launch of fewer than 2^31 outputs runs, and a 64-bit one for larger
// launches.
#include "common.cuh"

template <typename T, typename I>
__global__ void analysis_axis_kernel(const T* __restrict__ x,
                                     T* __restrict__ out,
                                     const __grid_constant__ Taps<T> taps,
                                     int len, I outer, int n,
                                     int period, int m, I inner,
                                     int pad, int circular) {
  const I total = outer * static_cast<I>(m) * inner;
  const I idx = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const I j = idx % inner;
  const I row = idx / inner;
  const int i = static_cast<int>(row % static_cast<I>(m));
  const I o = row / static_cast<I>(m);
  const T* src = x + (static_cast<int64_t>(o) * n) * inner + j;
  T lo = T(0), hi = T(0);
  const int base = 2 * i - pad;
  for (int k = 0; k < len; ++k) {
    int r = base + k;
    if (circular) r = wrap_index(r, period, n);
    const T v = src[static_cast<int64_t>(r) * inner];
    lo += taps.lo[k] * v;
    hi += taps.hi[k] * v;
  }
  out[idx] = lo;
  out[static_cast<int64_t>(total) + idx] = hi;
}

template <typename T>
struct BandPairs {
  const T* lo[2];
  const T* hi[2];
};

template <typename T, typename I>
__global__ void synthesis_axis_kernel(const BandPairs<T> bands,
                                      T* __restrict__ out,
                                      const __grid_constant__ Taps<T> taps,
                                      int len, int groups, I outer,
                                      int m, int out_len, I inner,
                                      int off, int circular) {
  const I per_group = outer * static_cast<I>(out_len) * inner;
  const I idx = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= per_group * static_cast<I>(groups)) return;
  const I g = idx / per_group;
  const I rem = idx - g * per_group;
  const I j = rem % inner;
  const I row = rem / inner;
  const int t = static_cast<int>(row % static_cast<I>(out_len));
  const I o = row / static_cast<I>(out_len);
  const int64_t base = (static_cast<int64_t>(o) * m) * inner + j;
  const T* lo = (g ? bands.lo[1] : bands.lo[0]) + base;
  const T* hi = (g ? bands.hi[1] : bands.hi[0]) + base;
  // out[t] = sum over taps k with (t + off - k) even of
  //          rec_lo[k] lo[(t + off - k) / 2] + rec_hi[k] hi[(t + off - k) / 2]
  const int f = t + off;
  T acc = T(0);
  for (int k = f & 1; k < len; k += 2) {
    int q = (f - k) >> 1;  // f - k is even, so the shift divides exactly
    if (circular) {
      q = wrap_index(q, m, m);
    } else if (q < 0 || q >= m) {
      continue;
    }
    const int64_t at = static_cast<int64_t>(q) * inner;
    acc += taps.lo[k] * lo[at] + taps.hi[k] * hi[at];
  }
  out[idx] = acc;
}

template <typename T>
static int launch_analysis(const void* x, void* out, const double* lo,
                           const double* hi, int len, long long outer, int n,
                           int period, int m, long long inner, int pad,
                           int circular, cudaStream_t stream) {
  const int64_t total = outer * static_cast<int64_t>(m) * inner;
  if (index32_ok(total))
    analysis_axis_kernel<T, unsigned><<<grid_size(total), PTWT_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        make_taps<T>(lo, hi, len), len, static_cast<unsigned>(outer), n,
        period, m, static_cast<unsigned>(inner), pad, circular);
  else
    analysis_axis_kernel<T, int64_t><<<grid_size(total), PTWT_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        make_taps<T>(lo, hi, len), len, outer, n, period, m, inner, pad,
        circular);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_synthesis(const void* lo0, const void* hi0,
                            const void* lo1, const void* hi1, int groups,
                            void* out, const double* rlo, const double* rhi,
                            int len, long long outer, int m, int out_len,
                            long long inner, int off, int circular,
                            cudaStream_t stream) {
  BandPairs<T> bands;
  bands.lo[0] = static_cast<const T*>(lo0);
  bands.hi[0] = static_cast<const T*>(hi0);
  bands.lo[1] = static_cast<const T*>(groups > 1 ? lo1 : lo0);
  bands.hi[1] = static_cast<const T*>(groups > 1 ? hi1 : hi0);
  const int64_t total = groups * outer * static_cast<int64_t>(out_len) * inner;
  if (index32_ok(total))
    synthesis_axis_kernel<T, unsigned><<<grid_size(total), PTWT_THREADS, 0, stream>>>(
        bands, static_cast<T*>(out), make_taps<T>(rlo, rhi, len), len, groups,
        static_cast<unsigned>(outer), m, out_len,
        static_cast<unsigned>(inner), off, circular);
  else
    synthesis_axis_kernel<T, int64_t><<<grid_size(total), PTWT_THREADS, 0, stream>>>(
        bands, static_cast<T*>(out), make_taps<T>(rlo, rhi, len), len, groups,
        outer, m, out_len, inner, off, circular);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = float64.  Returns a cudaError_t after the launch,
// or PTWT_BAD_ARGUMENT.
extern "C" int ptwt_analysis_axis(int dtype, const void* x, void* out,
                                  const double* lo, const double* hi, int len,
                                  long long outer, int n, int period, int m,
                                  long long inner, int pad, int circular,
                                  void* stream) {
  if (!sizes_ok(len, outer * static_cast<int64_t>(m) * inner) ||
      (circular && (period < 1 || n < 1)))
    return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_analysis<float>(x, out, lo, hi, len, outer, n, period, m,
                                  inner, pad, circular, s);
  if (dtype == 1)
    return launch_analysis<double>(x, out, lo, hi, len, outer, n, period, m,
                                   inner, pad, circular, s);
  return PTWT_BAD_ARGUMENT;
}

extern "C" int ptwt_synthesis_axis(int dtype, const void* lo0,
                                   const void* hi0, const void* lo1,
                                   const void* hi1, int groups, void* out,
                                   const double* rlo, const double* rhi,
                                   int len, long long outer, int m,
                                   int out_len, long long inner, int off,
                                   int circular, void* stream) {
  if (groups < 1 || groups > 2 || m < 1 ||
      !sizes_ok(len, groups * outer * static_cast<int64_t>(out_len) * inner))
    return PTWT_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_synthesis<float>(lo0, hi0, lo1, hi1, groups, out, rlo, rhi,
                                   len, outer, m, out_len, inner, off,
                                   circular, s);
  if (dtype == 1)
    return launch_synthesis<double>(lo0, hi0, lo1, hi1, groups, out, rlo, rhi,
                                    len, outer, m, out_len, inner, off,
                                    circular, s);
  return PTWT_BAD_ARGUMENT;
}
