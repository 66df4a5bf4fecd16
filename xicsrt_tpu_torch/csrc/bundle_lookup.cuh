// Bundle lookup shared by the bundle-gather kernel (bundle_gather.cu, K4)
// and the fused trace kernel's plasma source (fused_run.cuh, K1f).
//
// A plasma source hands each iteration's rays to its bundles by inclusive
// cumulative photon counts: ray r belongs to bundle b iff
// cum[b-1] <= r < cum[b]. On this card that is a search over cum followed
// by one 32-byte row load; the TPU kernels contracted an interval one-hot
// against the table on the MXU instead, because the TPU has no fast gather.
// K1 and K4 search a warp's 32 consecutive rays together
// (xrt_warp_bundle: a 32-ary search, ceil(log2 B / 5) rounds of 32 loads
// issued at once, then one window of 32 entries), where a thread searching
// alone (xrt_upper_bound) takes ceil(log2 B) dependent loads.
#pragma once

#include <climits>
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

// The bundle of each live lane's ray, the warp's lanes together: the first
// b with cum[b] > local, as xrt_upper_bound gives it (a live ray has local
// < cum[n - 1], so b < n); 0 for a dead lane. Every lane of the warp calls
// it (the ballots and shuffles take all 32), dead lanes included; cum is
// the lane's iteration's row of n entries, local its ray's index there.
//
// 1. The first live lane (the leader) finds its bundle A by a 32-ary
//    search: each round, lane i loads the bracket's entry at (i + 1) s - 1
//    (s = ceil(size / 32)) and a ballot of cum <= local counts the entries
//    below, which narrows the bracket to s - 1 entries: ceil(log2 B / 5)
//    rounds, every round's 32 loads in flight together, where the serial
//    search issues ceil(log2 B) dependent loads.
// 2. The window: lane i loads cum[A + i]. A lane of the leader's iteration
//    (its locals follow the leader's, so its bundle is at least A) counts
//    the window's entries <= its local by a binary search over the lanes
//    (six shuffles): its bundle is A plus that count.
// 3. A lane whose ray lies past the window (bundles emptier than the warp,
//    or runs of zero-photon bundles), or in the next iteration (a warp can
//    span two: n_per_iter is rarely a multiple of 32), ends with
//    xrt_upper_bound over the rest of its row.
__device__ __forceinline__ int xrt_warp_bundle(const int* __restrict__ cum, int n,
                                               int local, bool alive, int lane) {
    const unsigned full = 0xffffffffu;
    const unsigned live = __ballot_sync(full, alive);
    if (live == 0u) return 0;
    const int leader = __ffs(live) - 1;
    const int* lcum = reinterpret_cast<const int*>(
        __shfl_sync(full, reinterpret_cast<unsigned long long>(cum), leader));
    const int x = __shfl_sync(full, local, leader);
    int lo = 0, hi = n;  // the leader's bundle lies in [lo, hi]
    while (lo < hi) {
        const int s = (hi - lo + 31) >> 5;
        const int p = lo + (lane + 1) * s - 1;
        const bool below = p < hi && __ldg(lcum + p) <= x;
        lo = lo + __popc(__ballot_sync(full, below)) * s;
        hi = min(lo + s - 1, hi);
    }
    const int w = lo + lane < n ? __ldg(lcum + lo + lane) : INT_MAX;
    int k = 0;  // window entries <= local, at most 31 here
    for (int step = 16; step >= 1; step >>= 1) {
        if (__shfl_sync(full, w, k + step - 1) <= local) k += step;
    }
    if (__shfl_sync(full, w, 31) <= local && k == 31) k = 32;
    if (!alive) return 0;
    const bool same = cum == lcum;
    if (same && k < 32) return lo + k;
    const int base = same ? lo + 32 : 0;
    return base + xrt_upper_bound(cum + base, n - base, local);
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
