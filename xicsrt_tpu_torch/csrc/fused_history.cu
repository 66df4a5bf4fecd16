// The history reservoir of K1 (K1e) for NVIDIA Hopper (sm_90a):
// keep_history='found' and 'sampled' on the fused engine.
//
// Replaces the history stage of the TPU megakernel
// xicsrt_tpu/ops/fused_trace.py::build_fused_run (kernel: the record hook
// :1720-1745, the slot write :1750-1770, the HBM reservoir :1784-1795). The
// TPU kernel mirrors every element's post-element state into VMEM for each
// chunk of rays and copies the chunk into the next free HBM slot when it
// qualifies, relying on its sequential grid to fill the slots in chunk
// order. CUDA blocks run in no order, so a slot counter would fill the
// reservoir in an order that changes from run to run. Here a chunk's rays
// are traced again instead, which reproduces them bit for bit: a ray's
// draws depend only on (seed, ray, draw), Philox or column `ray` of the
// explicit uniforms. Three launches:
//
// (a) 'found' runs K1 in its kMark build (fused_run.cuh): the main run's
//     counts and images as always, and marks[c] = 1 for each chunk c whose
//     final element keeps a ray, one store per warp with a hit.
//     'sampled' runs K1 as it is and needs no marks.
// (b) history_select_kernel, one block: the first S marked chunk indices
//     in order ('found'), or 0..S-1 ('sampled'), and the count used.
//     These are the chunks the TPU kernel keeps for the same uniforms.
// (c) history_record_kernel traces the rays of the selected chunks again,
//     through the same source and chain (xrt_k1_source, xrt_trace_chain
//     with a record hook), and writes each element's fields into
//     hist (S, n_fields (1 + n_optics), chunk) float32, one coalesced row
//     a field: origin (3), direction (3), wavelength, alive, and in weight
//     mode the weight. It adds nothing to the counts or images.
//
// Chunk c holds rays [c chunk, (c + 1) chunk); rays past n_total, or past a
// Poisson count, are dead there. A plasma's rays keep K1's layout
// (iteration j is rays [j n, (j + 1) n), without the TPU kernel's padding
// of each iteration to its chunk), so its chunks are not the TPU's.
//
// What bounds it: the record launch retraces S chunk rays, about 1/4096 of
// a 2^28-ray run at the defaults (8 slots of 8192 rays), and writes S
// n_fields (1 + n_optics) chunk floats; the marks cost the main run one
// ballot per warp. The record kernel is one build (the plasma's sampler and
// the generic source's whole one, the Chebyshev, weight, bilinear and
// mosaic stages), which
// gives every chain the same values as its own build of K1; its speed
// hardly matters at S chunk rays.
#include "fused_run.cuh"

namespace {

// K1e's record hook (trace_chain.cuh): element elem's fields into rows
// elem n_fields .. of one ray's column of a slot.
struct XrtHistRecord {
    static constexpr bool kOn = true;
    float* out;  // the ray's column of its slot: row k at out[k * chunk]
    int chunk;
    int n_fields;
    float wl;  // the ray's wavelength, which no optic changes

    __device__ __forceinline__ void operator()(int elem, float px, float py, float pz,
                                               float dx, float dy, float dz, bool alive,
                                               float wt) const {
        float* o = out + (long long)elem * n_fields * chunk;
        o[0] = px;
        o[chunk] = py;
        o[2 * chunk] = pz;
        o[3 * chunk] = dx;
        o[4 * chunk] = dy;
        o[5 * chunk] = dz;
        o[6 * chunk] = wl;
        o[7 * chunk] = alive ? 1.0f : 0.0f;
        if (n_fields == 9) o[8 * chunk] = wt;
    }
};

// The first `slots` marked chunks, in chunk order, into sel, and their
// number into *used; with no marks ('sampled'), chunks 0 .. slots - 1. One
// block of 1024 threads walks the marks 1024 at a time: a ballot and a
// popcount give each marked chunk its place among the warp's, the warps'
// totals its place in the tile.
__global__ void __launch_bounds__(1024) history_select_kernel(
    const int* __restrict__ marks, int n_chunks, int slots, int* __restrict__ sel,
    int* __restrict__ used) {
    __shared__ int s_warp[32];
    __shared__ int s_base;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (marks == nullptr) {
        const int n = min(slots, n_chunks);
        for (int s = tid; s < n; s += blockDim.x) sel[s] = s;
        if (tid == 0) *used = n;
        return;
    }
    if (tid == 0) s_base = 0;
    __syncthreads();
    for (int c0 = 0; c0 < n_chunks; c0 += blockDim.x) {
        const int base = s_base;
        if (base >= slots) break;  // every thread read the same s_base
        const int c = c0 + tid;
        const bool flag = c < n_chunks && marks[c] != 0;
        const unsigned int b = __ballot_sync(0xffffffffu, flag);
        if (lane == 0) s_warp[warp] = __popc(b);
        __syncthreads();
        int pos = base + __popc(b & ((1u << lane) - 1u));
        for (int w = 0; w < warp; ++w) pos += s_warp[w];
        if (flag && pos < slots) sel[pos] = c;
        __syncthreads();
        if (tid == 0) {
            int total = 0;
            for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += s_warp[w];
            s_base = base + total;
        }
        __syncthreads();
    }
    if (tid == 0) *used = min(s_base, slots);
}

// Thread t traces ray sel[t / chunk] chunk + t % chunk of a used slot again
// and records it; a warp's threads share a slot, so whole warps leave
// together past the used count.
__global__ void __launch_bounds__(256) history_record_kernel(
    const float* __restrict__ g_fp, int n_fp, const int* __restrict__ g_ip, int n_ip,
    const float* __restrict__ aux, long long n_total, long long count,
    const float* __restrict__ uniforms, uint32_t seed0, uint32_t seed1,
    const int* __restrict__ cum, const float* __restrict__ table, int n_bundles,
    int n_per_iter, const int* __restrict__ sel, const int* __restrict__ used,
    int chunk, int n_fields, float* __restrict__ hist) {
    __shared__ float fp[XRT_MAX_FP];
    __shared__ int ip[XRT_MAX_IP];
    for (int i = threadIdx.x; i < n_fp; i += blockDim.x) fp[i] = g_fp[i];
    for (int i = threadIdx.x; i < n_ip; i += blockDim.x) ip[i] = g_ip[i];
    __syncthreads();

    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int slot = (int)(t / chunk);
    const int local = (int)(t - (long long)slot * chunk);
    if (slot >= *used) return;
    const long long r = (long long)sel[slot] * chunk + local;
    const long long ray = r < n_total ? r : n_total - 1;
    Draws draw{uniforms, n_total, ray, seed0, seed1, 0, -1, {0u, 0u, 0u, 0u}};
    float px, py, pz, dx, dy, dz, wl;
    const bool alive = xrt_k1_source<XRT_K1_ANY>(
        fp, ip, ip[6] != 0, ip[7] != 0, draw, r, count, cum, table, n_bundles, n_per_iter,
        threadIdx.x & 31, px, py, pz, dx, dy, dz, wl);
    const int n_rows = n_fields * (ip[0] + 1);
    const XrtHistRecord rec{hist + (long long)slot * n_rows * chunk + local, chunk,
                            n_fields, wl};
    rec(0, px, py, pz, dx, dy, dz, alive, 1.0f);
    xrt_trace_chain<true, 2>(fp, ip, aux, draw, px, py, pz, dx, dy, dz, wl,
                             ip[XRT_H_PER_RAY_WL] != 0, alive, 1.0f, nullptr,
                             XrtImage<float>{nullptr}, threadIdx.x & 31, rec);
}

}  // namespace

// K1 as xrt_fused_trace launches it (fused_trace.cu, the same arguments),
// in the build that also sets marks[c] = 1 for each chunk c of `chunk`
// rays (a multiple of 32) whose final element keeps a ray; marks:
// ceil(n_total / chunk) int32, zeroed by the caller. images: float32 at
// stages 0, float64 at stages 1 and 2, as xrt_fused_trace takes them.
extern "C" int xrt_fused_trace_marked(const float* fp, int n_fp, const int* ip,
                                      int n_ip, const float* aux, int n_aux,
                                      long long n_total, long long count,
                                      const float* uniforms, unsigned int seed0,
                                      unsigned int seed1, const int* cum,
                                      const float* table, int n_bundles,
                                      long long n_per_iter, unsigned long long* counts,
                                      void* images, int img_total, int full_source,
                                      int cheb, int stages, int curved, int* marks,
                                      int chunk, void* stream) {
    return xrt_fused_launch<true>(fp, n_fp, ip, n_ip, aux, n_aux, n_total, count,
                                  uniforms, seed0, seed1, cum, table, n_bundles,
                                  n_per_iter, counts, images, img_total, full_source,
                                  cheb, stages, curved, marks, chunk, stream);
}

// Blocks of 256 a multiprocessor holds of the marked build of K1 that
// xrt_fused_trace_marked launches (src: 0 point, 1 generic, 2 plasma), and
// its dynamic shared bytes in *dyn_smem; -1 where the query fails.
extern "C" int xrt_fused_trace_marked_occupancy(int src, int cheb, int stages,
                                                int curved, int img_total,
                                                int* dyn_smem) {
    return xrt_fused_occupancy<true>(src, cheb, stages, curved, img_total, dyn_smem);
}

// K1e's selection and record launches for the run K1 traced with the same
// fp, ip, aux, n_total, count, uniforms or seeds and plasma tables. marks:
// the marked build's chunk marks ('found'), or null for chunks 0 .. slots -
// 1 ('sampled'); n_chunks = ceil(n_total / chunk), chunk a multiple of 256.
// sel: (slots,) int32, the kept chunks; used: one int32, their number;
// hist: (slots, n_fields (1 + n_optics), chunk) float32 (n_fields 8, or 9
// in weight mode), written at the used slots only. Returns
// cudaGetLastError() of the launches.
extern "C" int xrt_history_record(const float* fp, int n_fp, const int* ip, int n_ip,
                                  const float* aux, int n_aux, long long n_total,
                                  long long count, const float* uniforms,
                                  unsigned int seed0, unsigned int seed1, const int* cum,
                                  const float* table, int n_bundles, long long n_per_iter,
                                  const int* marks, int n_chunks, int slots, int chunk,
                                  int n_fields, int* sel, int* used, float* hist,
                                  void* stream) {
    if (n_fp > XRT_MAX_FP || n_ip > XRT_MAX_IP || aux == nullptr || n_aux <= 0 ||
        slots <= 0 || chunk <= 0 || chunk % 256 || (n_fields != 8 && n_fields != 9) ||
        n_total <= 0 || n_chunks != (n_total + chunk - 1) / chunk ||
        (long long)slots * chunk / 256 >= (1LL << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    if (cum != nullptr && (n_bundles <= 0 || n_per_iter <= 0 ||
                           n_per_iter >= (1LL << 31) || n_total % n_per_iter)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    history_select_kernel<<<1, 1024, 0, s>>>(marks, n_chunks, slots, sel, used);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int blocks = (int)((long long)slots * chunk / 256);
    history_record_kernel<<<blocks, 256, 0, s>>>(
        fp, n_fp, ip, n_ip, aux, n_total, count, uniforms, seed0, seed1, cum, table,
        n_bundles, (int)n_per_iter, sel, used, chunk, n_fields, hist);
    return (int)cudaGetLastError();
}
