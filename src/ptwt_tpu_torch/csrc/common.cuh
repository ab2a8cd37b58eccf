// Shared pieces of the hand-written filter-bank kernels.
//
// Every kernel takes its taps by value (a __grid_constant__ struct in the
// kernel-parameter bank), so one build serves every wavelet of the
// registry: the longest discrete bank, coif17, has 102 taps.  All threads
// of a warp read the same tap at the same time, which the constant bank
// broadcasts.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PTWT_MAX_TAPS 128
#define PTWT_THREADS 256

// Error code the C entry points return for arguments the kernels do not
// take (the Python wrappers check first; this guards the C boundary).
#define PTWT_BAD_ARGUMENT (-1)

template <typename T>
struct Taps {
  T lo[PTWT_MAX_TAPS];
  T hi[PTWT_MAX_TAPS];
};

template <typename T>
static Taps<T> make_taps(const double* lo, const double* hi, int len) {
  Taps<T> taps;
  for (int k = 0; k < PTWT_MAX_TAPS; ++k) {
    taps.lo[k] = k < len ? static_cast<T>(lo[k]) : T(0);
    taps.hi[k] = k < len ? static_cast<T>(hi[k]) : T(0);
  }
  return taps;
}

// Source index of position r on a circular axis of period `period` whose
// positions >= n repeat sample n - 1.  That is pywt's periodization of an
// odd axis (edge-pad to even, then wrap); with period == n it is the plain
// circular (periodic) map.  The modulo runs only off the edges.
__device__ __forceinline__ int wrap_index(int r, int period, int n) {
  if (r < 0 || r >= period) {
    r %= period;
    if (r < 0) r += period;
  }
  return r < n ? r : n - 1;
}

// What a launch of `total` outputs must meet: 1 to PTWT_MAX_TAPS taps, at
// least one output, and no more blocks of PTWT_THREADS outputs than CUDA's
// 2^31 - 1.  The kernels index past 2^31 outputs in 64 bits.
static inline bool sizes_ok(int len, int64_t total) {
  return len >= 1 && len <= PTWT_MAX_TAPS && total > 0 &&
         (total + PTWT_THREADS - 1) / PTWT_THREADS < (int64_t(1) << 31);
}

// Readable text for a code returned by the C entry points.
extern "C" const char* ptwt_error_string(int code) {
  if (code == PTWT_BAD_ARGUMENT) return "argument not taken by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
