// Float64 FMA loop for Hopper (sm_90a): the operation-rate probe of the
// roofline (observability/costs.py::measure_card_peaks).
//
// Not a port of a TPU kernel and not on any query's path: it measures the
// card's float64 vector rate once, so that a launch's roofline fraction is
// held against what this card does, not against a spec sheet.  Each thread
// runs kChains independent FMA chains for `iters` steps (the chains hide
// the FMA latency) and writes their sum, so nothing is optimized away;
// operations = threads * iters * kChains * 2.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kChains = 8;

__global__ void fma_loop_kernel(double* __restrict__ out, int iters) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  double a[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) a[c] = 1e-3 * (threadIdx.x + c);
  const double m = 0.9999999, k = 1e-7;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) a[c] = fma(a[c], m, k);
  }
  double s = 0.0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += a[c];
  out[i] = s;
}

}  // namespace

extern "C" int peaks_fma_chains() { return kChains; }

extern "C" int peaks_fma_f64(double* out, int64_t blocks, int threads, int iters, void* stream) {
  fma_loop_kernel<<<static_cast<unsigned>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* peaks_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
