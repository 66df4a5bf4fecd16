// Interval-indexed bundle gather (K4) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel xicsrt_tpu/ops/bundle_gather.py::interval_gather
// (kernel), which builds interval one-hot tiles against the cumulative
// counts in windows of 256 bundles and contracts the (8, B) attribute table
// on the MXU, because a TPU gather is slow. Here a gather is a load: ray r
// takes the row of the first bundle b with cum[b] > r. The result is
// bit-identical to the indexed gather, including zero rows for rays at or
// past cum[B-1] and bundles of zero count (their empty interval is never
// found).
//
// What bounds it: the 32 bytes stored per ray (n * 32 bytes over the card's
// memory rate); cum (4 KB at B = 1000, 400 KB at 1e5) and the table (32 KB,
// 3.2 MB) stay in L2. The design works on that store stream:
//
// - A warp owns 32 consecutive rays and finds their bundles together
//   (xrt_warp_bundle, bundle_lookup.cuh: a 32-ary search of ceil(log2 B /
//   5) rounds, every round's 32 loads in flight, then one window of 32
//   entries). A warp's rays almost always share one or two bundles (about
//   5600 rays a bundle at 1000 bundles, 49 at 1e5), so the window ends the
//   search; a thread searching alone took ceil(log2 B) dependent loads.
// - The warp's 1 KB of rows is written lane-contiguous: float4 2 r0 + lane,
//   then 2 r0 + 32 + lane, so each store instruction covers 512 contiguous
//   bytes (a thread storing its own row wrote two float4 at a 32-byte
//   stride, half of every sector at a time). Lane l stores half (l & 1) of
//   rays r0 + l / 2 and r0 + 16 + l / 2, whose bundles it takes from their
//   lanes by shuffle. The stores stream (__stcs): the output is written once
//   and read by the next kernel, not by this one.
// - Table rows are read through the read-only path (__ldg); the lanes of
//   one bundle read the same 16 bytes.
// One warp a tile of 32 rays, no grid-stride loop: a block of 256 threads
// covers 256 rays.
#include <cuda_runtime.h>

#include "bundle_lookup.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bundle_gather_kernel(const int* __restrict__ cum, const float* __restrict__ table,
                     int n_bundles, long long n, float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    // The warp's first ray; every lane of a warp agrees, so a warp leaves
    // whole and the ballots and shuffles below see all 32 lanes.
    const long long r0 = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31);
    if (r0 >= n) return;
    const long long total = __ldg(cum + n_bundles - 1);
    const long long r = r0 + lane;
    const bool alive = r < n && r < total;
    const int b = xrt_warp_bundle(cum, n_bundles, alive ? (int)r : 0, alive, lane);
    const float4* table4 = reinterpret_cast<const float4*>(table);
    float4* out4 = reinterpret_cast<float4*>(out) + 2 * r0;
    const unsigned full = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int src = 16 * j + (lane >> 1);  // the lane of this float4's ray
        const int bj = __shfl_sync(full, b, src);
        const int live = __shfl_sync(full, (int)alive, src);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (live) v = __ldg(table4 + 2 * (long long)bj + (lane & 1));
        if (r0 + src < n) __stcs(out4 + 32 * j + lane, v);
    }
}

}  // namespace

// cum: (n_bundles,) int32 inclusive cumulative counts; table: (n_bundles, 8)
// float32, 16-byte aligned; out: (n, 8) float32, 16-byte aligned, n < 2^31.
// Returns cudaGetLastError() of the launch.
extern "C" int xrt_bundle_gather(const int* cum, const float* table,
                                 int n_bundles, long long n, float* out,
                                 void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    if (n_bundles <= 0 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const long long blocks = (n + kThreads - 1) / kThreads;
    bundle_gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        cum, table, n_bundles, n, out);
    return (int)cudaGetLastError();
}
