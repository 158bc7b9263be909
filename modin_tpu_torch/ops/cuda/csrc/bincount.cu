// Exact histogram of int64 group codes for Hopper (sm_90a).
//
// Replaces: modin_tpu/ops/pallas/groupby_kernels.py::_build_bincount, the
// TPU kernel behind ops/groupby.py::_count_ids (int-key range coding) and the
// `size` aggregation.  Same function: counts[c] for 0 <= c < width; every
// other code (the overflow/NaN bucket `num_groups`, negatives) is dropped.
//
// Bound: the kernel reads each code once, 8*n bytes, and writes 8*width bytes.
// At n = 1e8 that is 0.8 GB, about 0.24 ms at the H100 SXM's 3.35 TB/s; the
// work per code is one compare and one integer add.
//
// Design against that bound: one pass over the codes with a grid-stride loop
// (coalesced 8-byte loads, no cast pass, no padded copy, no intermediate in
// device memory).  Up to `bincount_smem_slots()` slots each block keeps a
// private uint32 histogram in dynamic shared memory (atomicAdd on shared
// memory), then adds its non-zero slots into the int64 output with one
// 64-bit global atomicAdd each.  Wider histograms (multi-key composite codes
// reach 4 * 2^22 slots) add straight into global memory.  Integer atomics
// make the counts exact and independent of launch order, so both modes give
// bit-identical results.  Many codes in one slot serialise on that slot's
// atomics; per-warp sub-histograms would spread them (not done here).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxDevices = 64;

// per-device launch facts, filled on first use
int g_sms[kMaxDevices];
int g_smem_optin[kMaxDevices];
bool g_smem_attr_set[kMaxDevices];

__global__ void __launch_bounds__(kThreads)
bincount_smem_kernel(const int64_t* __restrict__ codes, int64_t n,
                     int64_t width, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned int hist[];
  for (int64_t s = threadIdx.x; s < width; s += blockDim.x) hist[s] = 0u;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int64_t c = codes[i];
    if (c >= 0 && c < width) atomicAdd(&hist[c], 1u);
  }
  __syncthreads();
  for (int64_t s = threadIdx.x; s < width; s += blockDim.x) {
    const unsigned int h = hist[s];
    if (h != 0u) atomicAdd(&out[s], static_cast<unsigned long long>(h));
  }
}

__global__ void __launch_bounds__(kThreads)
bincount_global_kernel(const int64_t* __restrict__ codes, int64_t n,
                       int64_t width, unsigned long long* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int64_t c = codes[i];
    if (c >= 0 && c < width) atomicAdd(&out[c], 1ull);
  }
}

cudaError_t device_facts(int* device) {
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  if (*device < 0 || *device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sms[*device] == 0) {
    err = cudaDeviceGetAttribute(&g_smem_optin[*device],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, *device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&g_sms[*device], cudaDevAttrMultiProcessorCount,
                                 *device);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Widest histogram the shared-memory mode takes on the current device
// (uint32 slots in the opt-in dynamic shared memory of one block), or a
// negated cudaError_t.
int64_t bincount_smem_slots(void) {
  int device = 0;
  const cudaError_t err = device_facts(&device);
  if (err != cudaSuccess) return -static_cast<int64_t>(err);
  return g_smem_optin[device] / static_cast<int64_t>(sizeof(unsigned int));
}

// counts[c] += #{i : codes[i] == c} for 0 <= c < width.  `counts` is int64
// [width], zeroed by the caller; `stream` is a cudaStream_t.  Launches on
// `stream` without synchronising; returns the launch's cudaError_t.
int bincount_int64(const void* codes, int64_t n, int64_t width, void* counts,
                   void* stream) {
  if (n <= 0 || width <= 0) return cudaSuccess;
  int device = 0;
  cudaError_t err = device_facts(&device);
  if (err != cudaSuccess) return err;
  const auto* in = static_cast<const int64_t*>(codes);
  auto* out = static_cast<unsigned long long*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t blocks_for_n = (n + kThreads - 1) / kThreads;
  const int64_t smem_slots = g_smem_optin[device] / sizeof(unsigned int);
  int per_sm = 0;
  if (width <= smem_slots) {
    const size_t smem = static_cast<size_t>(width) * sizeof(unsigned int);
    if (!g_smem_attr_set[device]) {
      err = cudaFuncSetAttribute(bincount_smem_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 g_smem_optin[device]);
      if (err != cudaSuccess) return err;
      g_smem_attr_set[device] = true;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bincount_smem_kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
    int64_t grid = static_cast<int64_t>(per_sm) * g_sms[device];
    if (grid > blocks_for_n) grid = blocks_for_n;
    bincount_smem_kernel<<<static_cast<unsigned int>(grid), kThreads, smem, s>>>(
        in, n, width, out);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bincount_global_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
    int64_t grid = static_cast<int64_t>(per_sm) * g_sms[device];
    if (grid > blocks_for_n) grid = blocks_for_n;
    bincount_global_kernel<<<static_cast<unsigned int>(grid), kThreads, 0, s>>>(
        in, n, width, out);
  }
  return cudaGetLastError();
}

const char* bincount_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
