// Class-rate probes of the roofline tool (R1, R2) for NVIDIA Hopper (sm_90a).
//
// R1, elem_rate_kernel, replaces the TPU kernel
// tools/roofline.py::microbench_rates.elem_rate.kernel (:294, pallas_call
// :315): every element of an (n_chunks, 8, sub) grid runs `streams`
// independent chains of K steps of one body, from the start value
// y = (lane + 7919 i) 1e-6 + seed (1 + 0.1 s), and the row sums of the
// chains' totals accumulate into an (8, 128) output whose every column holds
// its row's sum. The bodies are the TPU kernel's (:330-334), written as the
// port's kernels write them: exp(-0.9 y); 1 / sqrtf(|y| + 1), the port's
// form of rsqrt, so the sqrtdiv body is two sqrtdiv operations a step (a
// square root and a division) where JAX's is one; and
// (y > 0.1 ? 0.9999 y + 1e-6 : y + 1e-3), five simple operations a step
// (compare, multiply, two adds, select), where JAX's tool counts four. Each
// rate's numerator is the census of its plain body (ops/roofline_probes.py),
// so a rate is per operation as the roofline census counts operations.
// R1 is CUDA and not Triton on purpose: built with the port's NVCC_FLAGS
// (-O3 -fmad=false, no fast math), expf, the square root and the division
// are the libdevice sequences the port's kernels run.
//
// What bounds R1: its operations. Each thread's chains depend on nothing but
// their own values, so the card's issue rate for the body's instructions is
// the limit; the K loop has a run-time trip count and each step feeds on the
// last, so the compiler can neither hoist nor collapse it. The streams are
// independent, so a warp has `streams` chains in flight against the math
// latencies. The sums are one block tree per 256 lanes into a per-block
// partial, then one block per row sums its partials in a fixed order:
// deterministic, and no atomics.
//
// R2, mma_rate_kernel, replaces tools/roofline.py::microbench_rates.mm_kernel
// (:344, pallas_call :366): per grid step i, A (128, sub) = bf16((c + i)
// 1e-6 + seed) and B (128, sub) = bf16(q 1e-4); K_mm times acc += A B^T in
// float32, each followed by the feedback A <- bf16(A (1 + acc[0,0] 1e-20)),
// and the step's acc added into the (128, 128) output. Tensor cores through
// mma.sync m16n8k16 (bf16 in, float32 accumulators), by inline PTX.
//
// What bounds R2: the tensor cores, 989 TFLOP/s dense bf16 (494.5 TMAC/s;
// mma.sync reaches only part of it, wgmma is later work). A and B are made
// in the kernel from the step and the seed, so no input buffer is read. A's
// rows are all equal and B's columns are all equal (JAX's iotas), so the
// block keeps one row of A (sub bf16) in shared memory and B's 16 fragments
// in registers; every fragment is loaded as the mma layout asks, and the
// tensor cores still do all 128 x 128 x sub MACs of every product. The
// feedback reads acc[0,0] after every product and rescales A before the
// next (an identity here, since B's row 0 is zero, but computed all the
// same), so no product can be hoisted. One block per SM walks the grid's
// steps; each block's partial tile is summed by a second launch in a fixed
// order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kElemThreads = 256;
constexpr int kElemRows = 8;
constexpr int kOutCols = 128;
constexpr int kMmaThreads = 256;  // 8 warps, 16 rows of the tile each
constexpr int kMmaRows = 128;
constexpr int kMmaFrags = kOutCols / 8;  // n8 fragments across a warp's row

// The sum of v over the block, returned to every thread in a fixed tree
// order (xor butterflies, then the warp sums the same way).
__device__ __forceinline__ float xrt_block_sum(float v) {
    __shared__ float warp_sums[32];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    float t = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    return t;
}

template <int kBody>
__device__ __forceinline__ float xrt_probe_body(float y) {
    if constexpr (kBody == 0) {
        return expf(y * -0.9f);
    } else if constexpr (kBody == 1) {
        return 1.0f / sqrtf(fabsf(y) + 1.0f);
    } else {
        return y > 0.1f ? y * 0.9999f + 1e-6f : y + 1e-3f;
    }
}

// Block b holds lanes [256 j, 256 j + 256) of row r of step i, with
// b = (i * 8 + r) * (sub / 256) + j; its total goes to partial[b].
template <int kBody, int kStreams>
__global__ void __launch_bounds__(kElemThreads)
elem_rate_kernel(const float* __restrict__ seed_p, int sub, int K,
                 float* __restrict__ partial) {
    const int per_row = sub / kElemThreads;
    const int b = blockIdx.x;
    const int i = b / (kElemRows * per_row);
    const int lane = (b % per_row) * kElemThreads + threadIdx.x;
    const float base = (float)(lane + 7919 * i) * 1e-6f;
    const float seed = __ldg(seed_p);
    float y[kStreams];
#pragma unroll
    for (int s = 0; s < kStreams; ++s) y[s] = base + seed * (float)(1.0 + 0.1 * s);
    for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int s = 0; s < kStreams; ++s) y[s] = xrt_probe_body<kBody>(y[s]);
    }
    float tot = y[0];
#pragma unroll
    for (int s = 1; s < kStreams; ++s) tot = tot + y[s];
    const float sum = xrt_block_sum(tot);
    if (threadIdx.x == 0) partial[b] = sum;
}

// One block per row: the row's partials in (step, lane block) order, a
// strided sum per thread and the block tree; every column gets the sum.
__global__ void __launch_bounds__(kElemThreads)
elem_rate_finish_kernel(const float* __restrict__ partial, int n_chunks,
                        int per_row, float* __restrict__ out) {
    const int r = blockIdx.x;
    const int items = n_chunks * per_row;
    float s = 0.0f;
    for (int p = threadIdx.x; p < items; p += kElemThreads) {
        s += partial[((p / per_row) * kElemRows + r) * per_row + p % per_row];
    }
    s = xrt_block_sum(s);
    if (threadIdx.x < kOutCols) out[r * kOutCols + threadIdx.x] = s;
}

template <int kBody, int kStreams>
cudaError_t launch_elem(const float* seed, int n_chunks, int sub, int K,
                        float* partial, cudaStream_t stream) {
    const long long blocks = (long long)n_chunks * kElemRows * (sub / kElemThreads);
    elem_rate_kernel<kBody, kStreams><<<(unsigned)blocks, kElemThreads, 0, stream>>>(
        seed, sub, K, partial);
    return cudaGetLastError();
}

template <int kBody>
cudaError_t launch_elem_streams(int streams, const float* seed, int n_chunks,
                                int sub, int K, float* partial,
                                cudaStream_t stream) {
    switch (streams) {
        case 1: return launch_elem<kBody, 1>(seed, n_chunks, sub, K, partial, stream);
        case 2: return launch_elem<kBody, 2>(seed, n_chunks, sub, K, partial, stream);
        case 4: return launch_elem<kBody, 4>(seed, n_chunks, sub, K, partial, stream);
        case 8: return launch_elem<kBody, 8>(seed, n_chunks, sub, K, partial, stream);
        default: return cudaErrorInvalidValue;
    }
}

__device__ __forceinline__ uint32_t xrt_pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d += a b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col),
// d 16 x 8 float32.
__device__ __forceinline__ void xrt_mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Warp w computes rows [16 w, 16 w + 16) of the 128 x 128 tile, all 16 n8
// fragments. In the m16n8k16 layouts (g = lane / 4, t = lane % 4) a thread's
// A registers hold columns 2t, 2t+1 (a0, a1: rows g, g + 8) and 2t+8, 2t+9
// (a2, a3) of the k slice, its B registers rows k = 2t, 2t+1 and 2t+8, 2t+9
// of column g, and its accumulators rows g, g + 8 of columns 2t, 2t+1.
__global__ void __launch_bounds__(kMmaThreads, 1)
mma_rate_kernel(const float* __restrict__ seed_p, int n_mm, int K_mm, int sub,
                float* __restrict__ partial) {
    extern __shared__ uint32_t a_words[];  // A's row, the same for all 128 rows
    __nv_bfloat16* a_row = reinterpret_cast<__nv_bfloat16*>(a_words);
    __shared__ float acc00;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const float seed = __ldg(seed_p);
    uint32_t bfrag[kMmaFrags];  // B[q][c] = bf16(q 1e-4) for every c
#pragma unroll
    for (int j = 0; j < kMmaFrags; ++j) {
        const __nv_bfloat16 v = __float2bfloat16_rn((float)(8 * j + g) * 1e-4f);
        bfrag[j] = xrt_pack_bf16(v, v);
    }
    float o[kMmaFrags][4];
#pragma unroll
    for (int j = 0; j < kMmaFrags; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;

    for (int i = blockIdx.x; i < n_mm; i += gridDim.x) {
        for (int c = threadIdx.x; c < sub; c += kMmaThreads) {
            a_row[c] = __float2bfloat16_rn((float)(c + i) * 1e-6f + seed);
        }
        __syncthreads();
        float acc[kMmaFrags][4];
#pragma unroll
        for (int j = 0; j < kMmaFrags; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
        for (int m = 0; m < K_mm; ++m) {
            for (int ks = 0; ks < sub; ks += 16) {
                const uint32_t lo = a_words[(ks >> 1) + t];
                const uint32_t hi = a_words[(ks >> 1) + t + 4];
#pragma unroll
                for (int j = 0; j < kMmaFrags; ++j) {
                    xrt_mma_bf16(acc[j], lo, lo, hi, hi, bfrag[j], bfrag[j]);
                }
            }
            if (threadIdx.x == 0) acc00 = acc[0][0];
            __syncthreads();
            const float f = 1.0f + acc00 * 1e-20f;
            for (int c = threadIdx.x; c < sub; c += kMmaThreads) {
                a_row[c] = __float2bfloat16_rn(__bfloat162float(a_row[c]) * f);
            }
            __syncthreads();
        }
#pragma unroll
        for (int j = 0; j < kMmaFrags; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) o[j][e] += acc[j][e];
        }
    }
    float* p = partial + (long long)blockIdx.x * kMmaRows * kOutCols;
    const int r0 = 16 * warp + g;
#pragma unroll
    for (int j = 0; j < kMmaFrags; ++j) {
        const int c0 = 8 * j + 2 * t;
        p[r0 * kOutCols + c0] = o[j][0];
        p[r0 * kOutCols + c0 + 1] = o[j][1];
        p[(r0 + 8) * kOutCols + c0] = o[j][2];
        p[(r0 + 8) * kOutCols + c0 + 1] = o[j][3];
    }
}

// out[e] = the blocks' partial tiles summed in block order.
__global__ void mma_rate_finish_kernel(const float* __restrict__ partial, int blocks,
                                       float* __restrict__ out) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= kMmaRows * kOutCols) return;
    float s = 0.0f;
    for (int b = 0; b < blocks; ++b) s += partial[(long long)b * kMmaRows * kOutCols + e];
    out[e] = s;
}

}  // namespace

// R1. body: 0 exp, 1 sqrt and division, 2 simple; streams 1, 2, 4 or 8;
// sub a multiple of 256; partial: n_chunks * 8 * sub / 256 float32 scratch;
// out: (8, 128) float32. Returns the first non-zero cudaGetLastError() of
// the two launches.
extern "C" int xrt_elem_rate(int body, int streams, const float* seed, int n_chunks,
                             int sub, int K, float* partial, float* out, void* stream) {
    if (n_chunks <= 0 || sub <= 0 || sub % kElemThreads || K < 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    switch (body) {
        case 0: err = launch_elem_streams<0>(streams, seed, n_chunks, sub, K, partial, s); break;
        case 1: err = launch_elem_streams<1>(streams, seed, n_chunks, sub, K, partial, s); break;
        case 2: err = launch_elem_streams<2>(streams, seed, n_chunks, sub, K, partial, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    elem_rate_finish_kernel<<<kElemRows, kElemThreads, 0, s>>>(
        partial, n_chunks, sub / kElemThreads, out);
    return (int)cudaGetLastError();
}

// R2's blocks: one per SM, no more than the grid's steps; the partial tiles
// the caller allocates for xrt_mma_rate.
extern "C" int xrt_mma_rate_blocks(int n_mm) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (sms <= 0) sms = 1;
    return n_mm < sms ? (n_mm > 0 ? n_mm : 1) : sms;
}

// R2. sub a multiple of 16, at most 16384; partial: blocks (from
// xrt_mma_rate_blocks) x 128 x 128 float32 scratch; out: (128, 128) float32.
extern "C" int xrt_mma_rate(const float* seed, int n_mm, int K_mm, int sub,
                            float* partial, int blocks, float* out, void* stream) {
    if (n_mm <= 0 || K_mm < 0 || sub <= 0 || sub % 16 || sub > 16384 || blocks <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    mma_rate_kernel<<<blocks, kMmaThreads, sub * sizeof(__nv_bfloat16), s>>>(
        seed, n_mm, K_mm, sub, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mma_rate_finish_kernel<<<kMmaRows * kOutCols / 256, 256, 0, s>>>(partial, blocks, out);
    return (int)cudaGetLastError();
}
