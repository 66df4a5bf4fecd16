// Nearest-pixel histogram helpers shared by the binning kernel
// (bin_image.cu) and the fused trace kernel (fused_trace.cu).
//
// A block accumulates into a private image in shared memory and flushes it
// to the global image with one atomicAdd per non-zero pixel. CUDA blocks run
// concurrently and in no order, so the output image must be zeroed by the
// caller before the launch.
#pragma once

#include <cuda_runtime.h>

// Largest image (in float32 pixels, summed over all images of one launch)
// kept in a block's shared memory; larger images use global atomics.
#define XRT_SMEM_IMAGE_MAX_FLOATS (200 * 1024 / 4)

// Pixel of a hit at fractional pixel coordinates (fx, fy), or false when the
// hit is off the (nx, ny) grid. rintf rounds half to even, as jnp.round and
// torch.round do; the bounds are tested on the rounded floats so that NaN
// and out-of-range values never reach the integer conversion.
__device__ __forceinline__ bool xrt_nearest_pixel(float fx, float fy, int nx,
                                                  int ny, int* flat) {
    const float rx = rintf(fx);
    const float ry = rintf(fy);
    if (!(rx >= 0.0f && rx < (float)nx && ry >= 0.0f && ry < (float)ny)) {
        return false;
    }
    *flat = (int)rx * ny + (int)ry;
    return true;
}

__device__ __forceinline__ void xrt_smem_zero(float* s, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = 0.0f;
}

// Add the block's private image to the global one (after __syncthreads),
// of float32 pixels, or float64 (K1's staged weight and bilinear images).
template <class Pixel>
__device__ __forceinline__ void xrt_smem_flush(const float* s, Pixel* g, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float v = s[i];
        if (v != 0.0f) atomicAdd(g + i, (Pixel)v);
    }
}

// Blocks for a grid-stride launch: as many as are resident at once, but no
// more than the rays need.
template <typename Kernel>
inline int xrt_grid_size(Kernel kernel, int threads, size_t dyn_smem,
                         long long n) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  dyn_smem);
    long long want = (n + threads - 1) / threads;
    long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
    long long blocks = want < cap ? want : cap;
    return blocks > 0 ? (int)blocks : 1;
}

// Allow the dynamic shared memory a launch needs where, with the kernel's
// static shared memory, it passes the default 48 KB a block may use.
template <typename Kernel>
inline cudaError_t xrt_set_smem(Kernel kernel, size_t dyn_smem) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (attr.sharedSizeBytes + dyn_smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)dyn_smem);
}
