// Bundle lookup shared by the bundle-gather kernel (bundle_gather.cu, K4)
// and the fused trace kernel's plasma source (fused_trace.cu, K1f).
//
// A plasma source hands each iteration's rays to its bundles by inclusive
// cumulative photon counts: ray r belongs to bundle b iff
// cum[b-1] <= r < cum[b]. On this card that is a binary search over cum
// (about log2(B) dependent loads, through the read-only cache) followed by
// one 32-byte row load; the TPU kernels contracted an interval one-hot
// against the table on the MXU instead, because the TPU has no fast gather.
#pragma once

#include <cuda_runtime.h>

// The first bundle b in [0, n) with cum[b] > r, or n when there is none.
__device__ __forceinline__ int xrt_upper_bound(const int* __restrict__ cum,
                                               int n, int r) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (__ldg(cum + mid) <= r) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// Row b of a (B, 8) float32 table: origin xyz, cone half-angle,
// temperature, velocity xyz for a plasma. Two 16-byte loads; the table is
// 16-byte aligned and its rows are 32 bytes.
__device__ __forceinline__ void xrt_bundle_row(const float* __restrict__ table,
                                               int b, float4* lo, float4* hi) {
    const float4* row = reinterpret_cast<const float4*>(table) + 2 * (long long)b;
    *lo = __ldg(row);
    *hi = __ldg(row + 1);
}
