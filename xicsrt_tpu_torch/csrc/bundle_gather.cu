// Interval-indexed bundle gather (K4) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel xicsrt_tpu/ops/bundle_gather.py::interval_gather
// (kernel), which builds interval one-hot tiles against the cumulative
// counts in windows of 256 bundles and contracts the (8, B) attribute table
// on the MXU, because a TPU gather is slow. Here a gather is a load: one
// thread per ray finds its bundle by binary search over cum
// (bundle_lookup.cuh) and copies the bundle's 32-byte row. The result is
// bit-identical to the indexed gather, including zero rows for rays at or
// past cum[B-1] and bundles of zero count (their empty interval is never
// found).
//
// What bounds it: about log2(B) dependent loads per ray, served by L1/L2
// (cum is 16 KB at B = 4000 and 400 KB at B = 1e5), plus the 32 bytes
// stored per ray; at B = 4000 the store stream dominates.
#include <cuda_runtime.h>

#include "binning.cuh"
#include "bundle_lookup.cuh"

namespace {

__global__ void bundle_gather_kernel(const int* __restrict__ cum,
                                     const float* __restrict__ table,
                                     int n_bundles, long long n,
                                     float* __restrict__ out) {
    const int total = __ldg(cum + n_bundles - 1);
    float4* out4 = reinterpret_cast<float4*>(out);
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
         r += stride) {
        float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 hi = lo;
        if (r < total) {
            const int b = min(xrt_upper_bound(cum, n_bundles, (int)r), n_bundles - 1);
            xrt_bundle_row(table, b, &lo, &hi);
        }
        out4[2 * r] = lo;
        out4[2 * r + 1] = hi;
    }
}

}  // namespace

// cum: (n_bundles,) int32 inclusive cumulative counts; table: (n_bundles, 8)
// float32, 16-byte aligned; out: (n, 8) float32. Returns cudaGetLastError()
// of the launch.
extern "C" int xrt_bundle_gather(const int* cum, const float* table,
                                 int n_bundles, long long n, float* out,
                                 void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    if (n_bundles <= 0) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const int blocks = xrt_grid_size(bundle_gather_kernel, threads, 0, n);
    bundle_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        cum, table, n_bundles, n, out);
    return (int)cudaGetLastError();
}
