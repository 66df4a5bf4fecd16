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
// explicit uniforms. The launches:
//
// (a) 'found', in a run of 2^28 rays or more (PROBE_MIN_RAYS in
//     ops/fused_trace.py), first probes the run's first chunks
//     (history_probe_kernel): windows of S, 2S, 4S, ... chunks in chunk
//     order, up to 1/1024 of the run's chunks (at least S), each traced
//     through the record kernel's source and chain, marks[c] = 1 for each
//     chunk c whose final element keeps a ray; after each window
//     history_select_kernel counts the marked chunks of the prefix, and
//     once S are marked it sets the flag marks[n_chunks], and the later
//     windows and selections leave at once. The host reads nothing: it
//     issues every window of the budget.
// (b) K1's main launch. Without the probe, its kMark build alone
//     (fused_run.cuh), whose warps mark every chunk with a found ray; with
//     it, both builds, each of which reads the flag before its loop: where
//     the probe set it (a run whose first chunks keep rays: the flagship's
//     8 of 8) the build without marks runs and the marked one leaves at
//     once; where it is clear (a sparse run: the fallback), the other way
//     round.
//     'sampled' runs K1 as it is and needs no marks.
// (c) history_select_kernel, one block: the first S marked chunk indices
//     in order ('found'), or 0..S-1 ('sampled'), and the count used.
//     These are the chunks the TPU kernel keeps for the same uniforms:
//     the probe's marks are those of the same rays in the main launch,
//     and its prefix holds the first S marked chunks wherever the flag is
//     set.
// (d) history_record_kernel traces the rays of the selected chunks again,
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
// What bounds it: the probe traces S chunks of a dense run, and at most
// 1/1024 of a sparse one's; the record launch retraces S chunk rays, about
// 1/4096 of a 2^28-ray run at the defaults (8 slots of 8192 rays), and
// writes S n_fields (1 + n_optics) chunk floats. A mark costs the main
// launch a global store per warp with a hit, and the flagship's 2.9e6
// stores to 32768 ints cost its 2^28 rays 1.8 % (the ballot alone 0.6 %,
// chip_ab.py `mark_ballot_only`, PERF.md); the flag spares them that. The
// probe's launches, selection and buffers cost a call 0.03-0.07 ms
// measured end to end, as much as the marks of a 2^26-ray run, so shorter
// runs mark. The probe and record kernels are one build each (the
// plasma's sampler and the generic source's whole one, the Chebyshev,
// weight, bilinear and mosaic stages), which gives every chain the same
// values as its own build of K1; their speed hardly matters at S chunk
// rays.
#include <algorithm>

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

// A record hook that records nothing (history_probe_kernel): with it the
// chain adds nothing to the counts or the images, which may be null, and
// runs every element.
struct XrtProbeRecord {
    static constexpr bool kOn = true;
    __device__ __forceinline__ void operator()(int, float, float, float, float, float,
                                               float, bool, float) const {}
};

// The first `slots` marked chunks of marks[0, n_chunks), in chunk order,
// into sel, and their number into *used; with no marks ('sampled'), chunks
// 0 .. slots - 1. *used holds 0, or the count of an earlier selection: at
// `slots` already it stays as it is (the probe's later windows). Where
// `full` is given, *full = 1 once `slots` chunks are selected. One block
// of 1024 threads walks the marks 1024 at a time: a ballot and a popcount
// give each marked chunk its place among the warp's, the warps' totals its
// place in the tile.
__global__ void __launch_bounds__(1024) history_select_kernel(
    const int* __restrict__ marks, int n_chunks, int slots, int* __restrict__ sel,
    int* __restrict__ used, int* __restrict__ full) {
    __shared__ int s_warp[32];
    __shared__ int s_base;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (*used >= slots) return;  // every thread read the same *used
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
    if (tid == 0) {
        *used = min(s_base, slots);
        if (full != nullptr && s_base >= slots) *full = 1;
    }
}

// K1e's probe: rays [c_lo chunk, c_hi chunk) traced through the record
// kernel's source and chain with the run's draws, marks[c] = 1 for each
// chunk c that keeps a ray at its final element, one store per warp with a
// hit (a warp's 32 rays lie in one chunk). Every block leaves at once
// where *used already holds `slots` (an earlier window found them), and a
// warp with no live lane at the source leaves before the chain. A grid of
// the blocks resident at once strides over the window.
__global__ void __launch_bounds__(256) history_probe_kernel(
    const float* __restrict__ g_fp, int n_fp, const int* __restrict__ g_ip, int n_ip,
    const float* __restrict__ aux, long long n_total, long long count,
    const float* __restrict__ uniforms, uint32_t seed0, uint32_t seed1,
    const int* __restrict__ cum, const float* __restrict__ table, int n_bundles,
    int n_per_iter, long long r_lo, long long r_hi, int chunk, int slots,
    const int* __restrict__ used, int* __restrict__ marks) {
    if (*used >= slots) return;  // uniform over the launch
    extern __shared__ __align__(16) float s_dyn[];  // the head: ip, fp
    int* const ip = reinterpret_cast<int*>(s_dyn + XRT_HEAD_COUNTS);
    float* const fp = s_dyn + XRT_HEAD_COUNTS + xrt_round4(n_ip);
    xrt_head_load(fp, g_fp, n_fp, ip, g_ip, n_ip, nullptr, 0);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long r0 = r_lo + (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
         r0 < r_hi; r0 += stride) {
        const long long r = r0 + lane;
        const long long ray = r < n_total ? r : n_total - 1;
        Draws draw{uniforms, n_total, ray, seed0, seed1, 0, -1, {0u, 0u, 0u, 0u}};
        float px, py, pz, dx, dy, dz, wl;
        const bool alive = xrt_k1_source<XRT_K1_ANY>(
            fp, ip, ip[6] != 0, ip[7] != 0, draw, r, count, cum, table, n_bundles,
            n_per_iter, lane, px, py, pz, dx, dy, dz, wl);
        if (!__any_sync(0xffffffffu, alive)) continue;
        const bool found = xrt_trace_chain<true, 2>(
            fp, ip, aux, draw, px, py, pz, dx, dy, dz, wl, ip[XRT_H_PER_RAY_WL] != 0,
            alive, 1.0f, nullptr, XrtImage<float>{nullptr}, lane, XrtProbeRecord{});
        if (__ballot_sync(0xffffffffu, found) && lane == 0) {
            marks[(unsigned int)r0 / (unsigned int)chunk] = 1;
        }
    }
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
    extern __shared__ __align__(16) float s_dyn[];  // the head: ip, fp
    int* const ip = reinterpret_cast<int*>(s_dyn + XRT_HEAD_COUNTS);
    float* const fp = s_dyn + XRT_HEAD_COUNTS + xrt_round4(n_ip);
    xrt_head_load(fp, g_fp, n_fp, ip, g_ip, n_ip, nullptr, 0);
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
// ceil(n_total / chunk) + 1 int32, zeroed by the caller, or as the probe
// left them (xrt_history_probe): where the last, the flag, is set, every
// block leaves at once (xrt_fused_trace_flagged runs instead). images: float32 at
// stages 0, float64 at stages 1 and 2, as xrt_fused_trace takes them.
extern "C" int xrt_fused_trace_marked(const float* fp, int n_fp, const int* ip,
                                      int n_ip, const float* aux, int n_aux,
                                      long long n_total, long long count,
                                      const float* uniforms, unsigned int seed0,
                                      unsigned int seed1, const int* cum,
                                      const float* table, int n_bundles,
                                      long long n_per_iter, unsigned long long* counts,
                                      void* images, int img_total, int full_source,
                                      int cheb, int stages, int shapes, int dense,
                                      int win_lo, int win_hi, int* marks, int chunk,
                                      void* stream) {
    return xrt_fused_launch<true>(fp, n_fp, ip, n_ip, aux, n_aux, n_total, count,
                                  uniforms, seed0, seed1, cum, table, n_bundles,
                                  n_per_iter, counts, images, img_total, full_source,
                                  cheb, stages, shapes, dense, win_lo, win_hi, marks,
                                  chunk, stream);
}

// K1 in its build without marks, as xrt_fused_trace launches it (the same
// arguments), run only where K1e's flag, marks[ceil(n_total / chunk)], is
// set, else every block leaves at once: a 'found' run issues it beside
// xrt_fused_trace_marked on the same marks, and the flag picks one of them.
extern "C" int xrt_fused_trace_flagged(const float* fp, int n_fp, const int* ip,
                                       int n_ip, const float* aux, int n_aux,
                                       long long n_total, long long count,
                                       const float* uniforms, unsigned int seed0,
                                       unsigned int seed1, const int* cum,
                                       const float* table, int n_bundles,
                                       long long n_per_iter, unsigned long long* counts,
                                       void* images, int img_total, int full_source,
                                       int cheb, int stages, int shapes, int dense,
                                       int win_lo, int win_hi, int* marks, int chunk,
                                       void* stream) {
    return xrt_fused_launch<false>(fp, n_fp, ip, n_ip, aux, n_aux, n_total, count,
                                   uniforms, seed0, seed1, cum, table, n_bundles,
                                   n_per_iter, counts, images, img_total, full_source,
                                   cheb, stages, shapes, dense, win_lo, win_hi, marks,
                                   chunk, stream);
}

// Blocks of 256 a multiprocessor holds of the marked build of K1 that
// xrt_fused_trace_marked launches (src: 0 point, 1 generic, 2 plasma), and
// its dynamic shared bytes in *dyn_smem; -1 where the query fails.
extern "C" int xrt_fused_trace_marked_occupancy(int src, int cheb, int stages,
                                                int shapes, int dense, int win_lo,
                                                int win_hi, int img_total, int n_fp,
                                                int n_ip, int* dyn_smem) {
    return xrt_fused_occupancy<true>(src, cheb, stages, shapes, dense, win_lo, win_hi,
                                     img_total, n_fp, n_ip, dyn_smem);
}

// K1e's probe for the run K1 traces with the same fp, ip, aux, n_total,
// count, uniforms or seeds and plasma tables: for each window w of
// n_windows, the chunks [bounds[w], bounds[w + 1]) (bounds: n_windows + 1
// host ints, from 0 up), history_probe_kernel, then the selection of the
// first `slots` marked chunks of marks[0, bounds[w + 1]) into sel and
// *used, which sets the flag marks[n_chunks] once `slots` are marked. Both
// launches of a window leave at once where *used already holds `slots`.
// marks: n_chunks + 1 int32, n_chunks = ceil(n_total / chunk), chunk a
// multiple of 256; sel: (slots,) int32; used: one int32; all zeroed by the
// caller. Returns cudaGetLastError() of the launches.
extern "C" int xrt_history_probe(const float* fp, int n_fp, const int* ip, int n_ip,
                                 const float* aux, int n_aux, long long n_total,
                                 long long count, const float* uniforms,
                                 unsigned int seed0, unsigned int seed1, const int* cum,
                                 const float* table, int n_bundles, long long n_per_iter,
                                 int* marks, int n_chunks, const int* bounds,
                                 int n_windows, int slots, int chunk, int* sel, int* used,
                                 void* stream) {
    if (n_fp < XRT_SRC_F || n_ip < XRT_HDR_I || aux == nullptr || n_aux <= 0 ||
        slots <= 0 || chunk <= 0 || chunk % 256 || n_total <= 0 ||
        n_chunks != (n_total + chunk - 1) / chunk || n_windows <= 0 || bounds[0] != 0 ||
        bounds[n_windows] > n_chunks) {
        return (int)cudaErrorInvalidValue;
    }
    for (int w = 0; w < n_windows; ++w) {
        if (bounds[w] >= bounds[w + 1]) return (int)cudaErrorInvalidValue;
    }
    if (cum != nullptr && (n_bundles <= 0 || n_per_iter <= 0 ||
                           n_per_iter >= (1LL << 31) || n_total % n_per_iter)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    // A head too large for a block's shared memory fails xrt_set_smem.
    const size_t head = (size_t)xrt_head_floats(n_fp, n_ip) * sizeof(float);
    cudaError_t err = xrt_set_smem(history_probe_kernel, head);
    if (err != cudaSuccess) return (int)err;
    const int most = xrt_grid_size(history_probe_kernel, 256, head, 1LL << 40);
    for (int w = 0; w < n_windows; ++w) {
        const long long r_lo = (long long)bounds[w] * chunk;
        const long long r_hi = (long long)bounds[w + 1] * chunk;
        const int blocks = (int)std::min<long long>(most, (r_hi - r_lo + 255) / 256);
        history_probe_kernel<<<blocks, 256, head, s>>>(
            fp, n_fp, ip, n_ip, aux, n_total, count, uniforms, seed0, seed1, cum, table,
            n_bundles, (int)n_per_iter, r_lo, r_hi, chunk, slots, used, marks);
        history_select_kernel<<<1, 1024, 0, s>>>(marks, bounds[w + 1], slots, sel, used,
                                                 marks + n_chunks);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

// K1e's selection and record launches for the run K1 traced with the same
// fp, ip, aux, n_total, count, uniforms or seeds and plasma tables. marks:
// the marked build's chunk marks ('found'), or null for chunks 0 .. slots -
// 1 ('sampled'); n_chunks = ceil(n_total / chunk), chunk a multiple of 256.
// sel: (slots,) int32, the kept chunks; used: one int32, their number,
// zeroed by the caller;
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
    if (n_fp < XRT_SRC_F || n_ip < XRT_HDR_I || aux == nullptr || n_aux <= 0 ||
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
    const size_t head = (size_t)xrt_head_floats(n_fp, n_ip) * sizeof(float);
    cudaError_t err = xrt_set_smem(history_record_kernel, head);
    if (err != cudaSuccess) return (int)err;
    history_select_kernel<<<1, 1024, 0, s>>>(marks, n_chunks, slots, sel, used, nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int blocks = (int)((long long)slots * chunk / 256);
    history_record_kernel<<<blocks, 256, head, s>>>(
        fp, n_fp, ip, n_ip, aux, n_total, count, uniforms, seed0, seed1, cum, table,
        n_bundles, (int)n_per_iter, sel, used, chunk, n_fields, hist);
    return (int)cudaGetLastError();
}
