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
// Hopper's warpgroup product wgmma.mma_async m64n128k16 (bf16 in, float32
// accumulators, A from registers, B from shared memory), by inline PTX.
//
// What bounds R2: the tensor cores, 989 TFLOP/s dense bf16 (494.5 TMAC/s),
// which only wgmma reaches. A and B are made in the kernel from the step and
// the seed, so no input buffer is read and there is nothing for TMA to load.
// B[q][c] does not depend on c, so one 128 x 64 bf16 tile in shared memory
// (128-byte swizzle; each row holds one value, so the swizzle's permutation
// within a row changes nothing) serves every k slice through one descriptor.
// A's rows are all equal, so a thread's A fragment of a k slice is two
// words of the one row the block keeps in shared memory. Each of the two
// warpgroups of a block computes 64 rows of the 128 x 128 tile, so the
// tensor cores still do all 128 x 128 x sub MACs of every product. The
// feedback stays exact: after every product the block waits for its wgmmas
// (wait_group 0), reads acc[0,0] and rescales A's row before the next
// product (an identity here, since B's row 0 is zero, but computed all the
// same), so no product can be hoisted. That wait drains the block's
// products; two blocks a multiprocessor (64 accumulators a thread in
// registers, the step's sum in shared memory) keep the tensor cores busy
// through each other's feedback. Each block's partial tile is summed by a
// second launch in a fixed order, so R2 repeats bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kElemThreads = 256;
constexpr int kElemRows = 8;
constexpr int kOutCols = 128;
constexpr int kMmaThreads = 256;  // two warpgroups, 64 rows of the tile each
constexpr int kMmaRows = 128;
constexpr int kMmaAcc = 64;        // float32 accumulators a thread: 64 x 128 / 128
constexpr int kMmaBatch = 4;       // k slices of 16 per wgmma group
constexpr int kBTileBytes = 128 * 128;  // B's tile: 128 rows of 64 bf16

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

// The shared-memory descriptor of a K-major bf16 tile with the 128-byte
// swizzle, 1024-byte aligned: start address, leading byte offset (unused by
// this layout), stride byte offset 1024 (eight rows of 128 bytes), layout 1.
__device__ __forceinline__ uint64_t xrt_desc_sw128(uint32_t smem_addr) {
    return (uint64_t)((smem_addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void xrt_wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void xrt_wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void xrt_wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the wgmma fences and waits, which it does not see them take part in.
__device__ __forceinline__ void xrt_fence_acc(float (&d)[kMmaAcc]) {
#pragma unroll
    for (int e = 0; e < kMmaAcc; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// d += a b on the tensor cores for the warpgroup: a 64 x 16 bf16 from
// registers (a thread's four words in mma.sync m16n8k16's A layout for its
// warp's 16 rows), b 16 x 128 bf16 from the K-major tile desc_b names, d 64 x
// 128 float32 (a thread's 64 accumulators: rows g and g + 8 of its warp's 16,
// columns 8 j + 2 t and 8 j + 2 t + 1 in d[4 j .. 4 j + 3]).
__device__ __forceinline__ void xrt_wgmma_bf16(float (&d)[kMmaAcc], uint32_t a0,
                                               uint32_t a1, uint32_t a2, uint32_t a3,
                                               uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// The dynamic shared memory R2 asks for a block: room to align the B tile
// to 1024 bytes, the tile, the step sums, A's row.
inline size_t mma_smem_bytes(int sub) {
    return 1024 + kBTileBytes + sizeof(float) * kMmaAcc * kMmaThreads +
           sizeof(__nv_bfloat16) * (size_t)sub;
}

// Warpgroup w of the block computes rows [64 w, 64 w + 64) of the 128 x 128
// tile. A thread's A words of k slice s are words 8 s + t and 8 s + t + 4 of
// A's row (t = lane % 4): columns 2t, 2t+1 and 2t+8, 2t+9 of the slice, the
// same for rows g and g + 8. Slices go to the tensor cores kMmaBatch at a
// time; the words of two batches alternate between two register sets, and
// a set is loaded again only once its batch's group is done (wait_group 1).
// The step's acc is added into this thread's column of o_sum, then the
// block writes o_sum as its partial tile.
__global__ void __launch_bounds__(kMmaThreads, 2)
mma_rate_kernel(const float* __restrict__ seed_p, int n_mm, int K_mm, int sub,
                float* __restrict__ partial) {
    extern __shared__ uint8_t smem_raw[];
    __shared__ float acc00;
    const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
    const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
    uint32_t* b_tile = reinterpret_cast<uint32_t*>(smem_raw + pad);
    float* o_sum = reinterpret_cast<float*>(smem_raw + pad + kBTileBytes);
    uint32_t* a_words = reinterpret_cast<uint32_t*>(o_sum + kMmaAcc * kMmaThreads);
    __nv_bfloat16* a_row = reinterpret_cast<__nv_bfloat16*>(a_words);
    const int tid = threadIdx.x;
    const int t = tid & 3;
    const float seed = __ldg(seed_p);

    // B[q][c] = bf16(q 1e-4) for every c: row q of the tile, 32 words.
    for (int e = tid; e < kBTileBytes / 4; e += kMmaThreads) {
        const __nv_bfloat16 v = __float2bfloat16_rn((float)(e >> 5) * 1e-4f);
        b_tile[e] = xrt_pack_bf16(v, v);
    }
    for (int e = 0; e < kMmaAcc; ++e) o_sum[e * kMmaThreads + tid] = 0.0f;
    // The tile was written through the generic proxy; wgmma reads it
    // through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint64_t desc_b = xrt_desc_sw128(raw + pad);
    const int batches = sub / (16 * kMmaBatch);

    float acc[kMmaAcc];
    for (int i = blockIdx.x; i < n_mm; i += gridDim.x) {
        for (int c = tid; c < sub; c += kMmaThreads) {
            a_row[c] = __float2bfloat16_rn((float)(c + i) * 1e-6f + seed);
        }
#pragma unroll
        for (int e = 0; e < kMmaAcc; ++e) acc[e] = 0.0f;
        __syncthreads();
        for (int m = 0; m < K_mm; ++m) {
            xrt_fence_acc(acc);
            for (int b = 0; b < batches; b += 2) {
                uint32_t lo0[kMmaBatch], hi0[kMmaBatch];
                xrt_wgmma_wait<1>();
#pragma unroll
                for (int s = 0; s < kMmaBatch; ++s) {
                    const int w = 8 * (b * kMmaBatch + s) + t;
                    lo0[s] = a_words[w];
                    hi0[s] = a_words[w + 4];
                }
                xrt_wgmma_fence();
#pragma unroll
                for (int s = 0; s < kMmaBatch; ++s) {
                    xrt_wgmma_bf16(acc, lo0[s], lo0[s], hi0[s], hi0[s], desc_b);
                }
                xrt_wgmma_commit();
                if (b + 1 < batches) {
                    uint32_t lo1[kMmaBatch], hi1[kMmaBatch];
                    xrt_wgmma_wait<1>();
#pragma unroll
                    for (int s = 0; s < kMmaBatch; ++s) {
                        const int w = 8 * ((b + 1) * kMmaBatch + s) + t;
                        lo1[s] = a_words[w];
                        hi1[s] = a_words[w + 4];
                    }
                    xrt_wgmma_fence();
#pragma unroll
                    for (int s = 0; s < kMmaBatch; ++s) {
                        xrt_wgmma_bf16(acc, lo1[s], lo1[s], hi1[s], hi1[s], desc_b);
                    }
                    xrt_wgmma_commit();
                }
            }
            xrt_wgmma_wait<0>();
            xrt_fence_acc(acc);
            if (tid == 0) acc00 = acc[0];  // row 0, column 0 of warpgroup 0
            __syncthreads();
            const float f = 1.0f + acc00 * 1e-20f;
            for (int c = tid; c < sub; c += kMmaThreads) {
                a_row[c] = __float2bfloat16_rn(__bfloat162float(a_row[c]) * f);
            }
            __syncthreads();
        }
#pragma unroll
        for (int e = 0; e < kMmaAcc; ++e) o_sum[e * kMmaThreads + tid] += acc[e];
    }
    float* p = partial + (long long)blockIdx.x * kMmaRows * kOutCols;
    const int r0 = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2);
#pragma unroll
    for (int j = 0; j < kOutCols / 8; ++j) {
        const int c0 = 8 * j + 2 * t;
        p[r0 * kOutCols + c0] = o_sum[(4 * j) * kMmaThreads + tid];
        p[r0 * kOutCols + c0 + 1] = o_sum[(4 * j + 1) * kMmaThreads + tid];
        p[(r0 + 8) * kOutCols + c0] = o_sum[(4 * j + 2) * kMmaThreads + tid];
        p[(r0 + 8) * kOutCols + c0 + 1] = o_sum[(4 * j + 3) * kMmaThreads + tid];
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

// R2's blocks: two per SM, no more than the grid's steps; the partial tiles
// the caller allocates for xrt_mma_rate.
extern "C" int xrt_mma_rate_blocks(int n_mm) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int cap = 2 * (sms > 0 ? sms : 1);
    return n_mm < cap ? (n_mm > 0 ? n_mm : 1) : cap;
}

// R2. sub a multiple of 64, at most 16384; partial: blocks (from
// xrt_mma_rate_blocks) x 128 x 128 float32 scratch; out: (128, 128) float32.
extern "C" int xrt_mma_rate(const float* seed, int n_mm, int K_mm, int sub,
                            float* partial, int blocks, float* out, void* stream) {
    if (n_mm <= 0 || K_mm < 0 || sub <= 0 || sub % (16 * kMmaBatch) || sub > 16384 ||
        blocks <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = mma_smem_bytes(sub);
    cudaError_t err = cudaFuncSetAttribute(
        mma_rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mma_rate_kernel<<<blocks, kMmaThreads, smem, s>>>(seed, n_mm, K_mm, sub, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mma_rate_finish_kernel<<<kMmaRows * kOutCols / 256, 256, 0, s>>>(partial, blocks, out);
    return (int)cudaGetLastError();
}
