// The optic chain of the fused trace kernels K1 (fused_trace.cu) and K3
// (trace_only.cu): one ray, in registers, through every optic of the packed
// chain (ops/fused_trace.py: pack_params), with the per-element counts and
// the images. The counterpart of the TPU kernels' shared _trace_chain
// (xicsrt_tpu/ops/fused_trace.py:705) with plane, sphere, torus, cylinder
// and Chebyshev-surface shapes, mirrors, gaussian, step and file crystals
// and mosaic crystals, in mc or weight mode, with nearest or bilinear
// images; its plain twin is ops/fused_trace.py:_trace_chain_plain.
//
// Counts: each ray's reach (the elements it leaves alive) goes once into
// the block's shared histogram (xrt_count_reach), so every lane of the warp
// must call it; images go to the block-private histogram (binning.cuh) or
// to global memory, through the image the caller passes (XrtImage).
#pragma once

#include <cuda_runtime.h>

#include "binning.cuh"
#include "trace_common.cuh"

// The source's count: the rays of the warp alive at the source, added by
// lane 0 into the block's s_counts[0]. Every lane of the warp calls it.
__device__ __forceinline__ void xrt_count_source(unsigned int* s_counts, bool alive,
                                                 int lane) {
    const unsigned int b = __ballot_sync(0xffffffffu, alive);
    if (lane == 0 && b) atomicAdd(s_counts, (unsigned int)__popc(b));
}

// A ray's counts along the chain, added once after it: alive never returns
// along a chain (every shape's hit takes the incoming alive, and bounds,
// apertures and interactions only clear it), so the rays alive after
// element e are those that leave e + 1 elements or more alive. reach: the
// elements the ray leaves alive; a ray of reach 1 or more adds 1 to the
// block's s_counts[reach], a histogram that xrt_flush_counts turns into
// each element's count by suffix sums. The lanes of one reach add once
// together (__match_any_sync), so a warp issues one shared atomic a
// distinct reach where it issued a ballot and a shared atomic an element.
// Every lane of the warp calls it.
__device__ __forceinline__ void xrt_count_reach(unsigned int* s_counts, int reach,
                                                int lane) {
    const unsigned int peers = __match_any_sync(0xffffffffu, reach);
    if (reach > 0 && lane == __ffs(peers) - 1) {
        atomicAdd(s_counts + reach, (unsigned int)__popc(peers));
    }
}

// The block's counts: the source's s_counts[0] (xrt_count_source), and
// element e's, counts[1 + e], the rays that reach 1 + e or further, the sum
// of s_counts[1 + e .. n_opt] (xrt_count_reach); added to counts where not
// 0. Called by the whole block after a __syncthreads.
__device__ __forceinline__ void xrt_flush_counts(const unsigned int* s_counts, int n_opt,
                                                 unsigned long long* __restrict__ counts) {
    for (int i = threadIdx.x; i <= n_opt; i += blockDim.x) {
        unsigned int c = s_counts[i];
        for (int j = i + 1; i > 0 && j <= n_opt; ++j) c += s_counts[j];
        if (c) atomicAdd(counts + i, (unsigned long long)c);
    }
}

// The curved shapes a build of the chain compiles (kShapes of
// xrt_trace_chain, a set): the torus's code and the cylinder's.
#define XRT_SHAPES_TORUS 1
#define XRT_SHAPES_CYLINDER 2
#define XRT_SHAPES_ALL 3

// The chain's record hook (K1e, fused_history.cu): called after each
// element with its post-element state; a hook whose kOn is set takes the
// place of the counts and the images. XrtNoRecord, the default, compiles
// to nothing, so the builds without history keep their code.
struct XrtNoRecord {
    static constexpr bool kOn = false;
    __device__ __forceinline__ void operator()(int, float, float, float, float, float,
                                               float, bool, float) const {}
};

// The image a chain adds its terms to. Float32 pixels: a block's shared
// histogram or the global image (K1's nearest mc images, whose 1.0f adds
// are exact in any order; K3's images). Float64 pixels: K1's weighted and
// bilinear images (kStages >= 1) in global memory, where atomicAdd on a
// double is native (RED.E.ADD.F64, its float32 term converted exactly,
// subnormals too); the launcher rounds each pixel once to float32, so a
// pixel's terms are summed all but exactly in any order and no block
// holds the image in shared memory.
template <class Pixel>
struct XrtImage {
    Pixel* pix;
    __device__ __forceinline__ void add(int i, float v) const {
        atomicAdd(pix + i, (Pixel)v);
    }
};

// K1's nearest mc image (kStages 0: every term 1.0f) with a window of its
// pixels, [lo, lo + n), staged in the block's shared memory as integer
// counts, and the rest in float32 pixels in global memory: the builds whose
// chains focus their rays onto a few pixels of one image, where global
// atomics from every warp wait on the same addresses (fused_run.cuh,
// xrt_fused_pick). An integer add is one native shared atomic where a
// float add is a compare-and-swap loop; the counts are flushed once a block
// as floats, exact below 2^24 a pixel as every unit add is.
struct XrtWindowImage {
    float* pix;
    unsigned int* counts = nullptr;
    int lo = 0, n = 0;
    __device__ __forceinline__ void add(int i, float v) const {
        const unsigned int k = (unsigned int)(i - lo);
        if (k < (unsigned int)n) {
            atomicAdd(counts + k, 1u);
        } else {
            atomicAdd(pix + i, v);
        }
    }
};

// K1's float64 image staged in the block's float32 shared histogram where
// the launch gives one (staged), else its float64 pixels in global memory:
// the point source's build of the weight and bilinear stages with the
// torus and cylinder code (xrt_fused_pick), whose focusing chains put
// most terms on a few pixels.
struct XrtStagedImage {
    double* pix;
    float* staged = nullptr;
    __device__ __forceinline__ void add(int i, float v) const {
        if (staged != nullptr) {
            atomicAdd(staged + i, v);
        } else {
            atomicAdd(pix + i, (double)v);
        }
    }
};

// The Bragg deviation sd + sd^3 / 6, sd = |d.n| cos_b - sqrt(1 - (d.n)^2)
// sin_b (fused_trace.py:995-1002), of a direction on the normal whose dot
// product with it is dot.
__device__ __forceinline__ float xrt_bragg_delta(float dot, float sin_b,
                                                 float cos_b) {
    const float adot = fabsf(dot);
    const float cosi = sqrtf(fmaxf(1.0f - adot * adot, 0.0f));
    const float sd = adot * cos_b - cosi * sin_b;
    return sd + sd * sd * sd * (1.0f / 6.0f);
}

// The rocking curve of the crystal whose blocks are o, oi at the deviation
// delta, times its reflectivity o[19]: gaussian (o[20] sigma), step (o[20]
// half width) or the resampled file table in aux.
__device__ __forceinline__ float xrt_rock_prob(const float* o, const int* oi,
                                               const float* __restrict__ aux,
                                               float delta) {
    if (oi[3] == 0) {
        const float z = delta / o[20];
        return o[19] * expf(-0.5f * (z * z));
    }
    if (oi[3] != XRT_ROCK_FILE) return fabsf(delta) <= o[20] ? o[19] : 0.0f;
    bool inr;
    float f, kf, t0, t1;
    const float val = xrt_file_value(aux + oi[XRT_OI_TABLE], oi[XRT_OI_K],
                                     o[XRT_O_LO], o[XRT_O_INV_STEP], delta,
                                     &inr, &f, &kf, &t0, &t1);
    return inr ? val * o[19] : 0.0f;
}

// One layer's crystallite normal: two standard normals scaled by sigma_n,
// on the plane z = 1, in the basis (o2, o1, n) (JAX fused_trace.py:
// 1043-1049): nm = gx wn o2 + gy wn o1 + wn n, wn = 1 / sqrt(1 + gx^2 +
// gy^2).
__device__ __forceinline__ void xrt_mosaic_normal(
    Draws& draw, float sigma_n, const float* o1, const float* o2, float nx,
    float ny, float nz, float& nmx, float& nmy, float& nmz) {
    const float gx = sigma_n * xrt_normal(draw);
    const float gy = sigma_n * xrt_normal(draw);
    const float wn = inv_sqrt(1.0f + gx * gx + gy * gy);
    nmx = gx * wn * o2[0] + gy * wn * o1[0] + wn * nx;
    nmy = gx * wn * o2[1] + gy * wn * o1[1] + wn * ny;
    nmz = gx * wn * o2[2] + gy * wn * o1[2] + wn * nz;
}

// The consecutive layers one lane evaluates in a round of the mosaic stage
// (xrt_mosaic): a multiple of 4, so that every lane's chunk starts on the
// same word of a Philox block (three draws a layer) and the lanes of a warp
// call Philox at the same draws.
constexpr int kMosaicChunk = 4;
// The lanes, one chunk each, a searching ray takes in a round in mc mode: a
// power of two.
constexpr int kMosaicGroup = 4;
// The warps of a block the mosaic stage stages weight-mode values for: its
// callers launch blocks of 256 threads.
constexpr int kMosaicWarps = 8;

// Bit position of the (t + 1)-th set bit of m (t < popc(m)): five steps of
// a binary search on the set bits' count.
__device__ __forceinline__ int xrt_nth_bit(unsigned int m, int t) {
    int p = 0;
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) {
        const int c = __popc((m >> p) & ((1u << w) - 1u));
        if (t >= c) {
            t -= c;
            p += w;
        }
    }
    return p;
}

// What a lane needs of a mosaic ray to evaluate any of its layers: the
// ray's index (its draws' key), the incoming direction d0, the optic normal
// n, the crystallite basis o1, o2 (xrt_mosaic_basis) and the Bragg angle's
// sine and cosine. The first draw of the stage is the same for every ray
// of the chain.
struct MosaicRay {
    long long ray;
    float d0x, d0y, d0z, nx, ny, nz, o1[3], o2[3], sin_b, cos_b;

    // The same values of lane src's ray (every lane of the warp calls it).
    __device__ __forceinline__ MosaicRay from(int src) const {
        const unsigned int all = 0xffffffffu;
        MosaicRay m;
        m.ray = __shfl_sync(all, ray, src);
        m.d0x = __shfl_sync(all, d0x, src);
        m.d0y = __shfl_sync(all, d0y, src);
        m.d0z = __shfl_sync(all, d0z, src);
        m.nx = __shfl_sync(all, nx, src);
        m.ny = __shfl_sync(all, ny, src);
        m.nz = __shfl_sync(all, nz, src);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            m.o1[k] = __shfl_sync(all, o1[k], src);
            m.o2[k] = __shfl_sync(all, o2[k], src);
        }
        m.sin_b = __shfl_sync(all, sin_b, src);
        m.cos_b = __shfl_sync(all, cos_b, src);
        return m;
    }
};

// The crystallite basis of the optic normal n (JAX fused_trace.py:
// 1027-1036): o1 = normalize(ny, nz - nx, -ny), o2 = normalize(n x o1).
__device__ __forceinline__ void xrt_mosaic_basis(float nx, float ny, float nz, float* o1,
                                                 float* o2) {
    o1[0] = ny;
    o1[1] = nz - nx;
    o1[2] = -ny;
    float inv = inv_sqrt(fmaxf(o1[0] * o1[0] + o1[1] * o1[1] + o1[2] * o1[2], 1e-30f));
    o1[0] = o1[0] * inv;
    o1[1] = o1[1] * inv;
    o1[2] = o1[2] * inv;
    o2[0] = ny * o1[2] - nz * o1[1];
    o2[1] = nz * o1[0] - nx * o1[2];
    o2[2] = nx * o1[1] - ny * o1[0];
    inv = inv_sqrt(fmaxf(o2[0] * o2[0] + o2[1] * o2[1] + o2[2] * o2[2], 1e-30f));
    o2[0] = o2[0] * inv;
    o2[1] = o2[1] * inv;
    o2[2] = o2[2] * inv;
}

// The next layer of the mosaic ray m, whose draws come from draw (JAX
// fused_trace.py:1043-1057): its crystallite normal nm from two normals,
// d0.nm, and the rocking curve's probability; u gets the layer's uniform,
// its third draw. The draws are keyed by (ray, index), so any lane may
// evaluate any ray's layers and get the serial loop's bits.
__device__ __forceinline__ float xrt_mosaic_layer(const float* o, const int* oi,
                                                  const float* __restrict__ aux,
                                                  Draws& draw, const MosaicRay& m,
                                                  float& nmx, float& nmy, float& nmz,
                                                  float& dotm, float& u) {
    xrt_mosaic_normal(draw, o[XRT_O_MSIGMA], m.o1, m.o2, m.nx, m.ny, m.nz, nmx, nmy,
                      nmz);
    dotm = m.d0x * nmx + m.d0y * nmy + m.d0z * nmz;
    const float prob = xrt_rock_prob(o, oi, aux, xrt_bragg_delta(dotm, m.sin_b, m.cos_b));
    u = draw();
    return prob;
}

// The mosaic crystal (K1c-mosaic; JAX fused_trace.py:1014-1098): the
// cutoff prefilter, the crystallite basis (xrt_mosaic_basis), then
// oi[XRT_OI_DEPTH] layers of three draws each (two normals, a uniform). mc:
// the first layer whose crystallite accepts the ray (prob >= u) reflects
// it, and a ray without one is lost. Weight: every layer tests the incoming
// direction; the weight takes cum = 1 - prod(1 - p_i) and the direction the
// reflection off the last layer picked (u cum_l < q_l, q_l = p_l prod_{j<l}
// (1 - p_j)). The depth is a run-time int, so one build serves every depth;
// later optics find the draw index past the layers, first + 3 depth,
// whatever the stage evaluated.
//
// The layers of a warp's rays are spread over all 32 lanes in chunks of
// kMosaicChunk consecutive layers, so a warp no longer runs until its
// slowest ray has tried every layer, and each lane draws a chunk's layers
// in order. It must be called by whole warps of blocks of at most
// kMosaicWarps warps (every caller steps whole warps of blocks of 256: K1's
// grid-stride loop, in its builds that mark chunks for K1e too, and K3's),
// and all lanes must agree on the depth. mc:
// each round, the first 32 / kMosaicGroup rays still searching hand their
// next kMosaicGroup chunks to the lanes; a lane stops at its chunk's first
// acceptance, a ray takes its group's first (a ballot, __ffs) and stops, or
// moves to its next group. The first layer with prob >= u does not depend
// on the order the layers are evaluated in, and the reflection is a
// function of that layer alone, so every bit is the serial loop's. Weight:
// the (ray, chunk) pairs of the rays past the cutoff, chunk by chunk, 32 a
// round, each lane the probability, the pick's uniform and the reflected
// direction of a chunk's layers into the warp's rows of shared memory; the
// owning lane reads them and runs the recurrence (surv, cum, q, the pick)
// in layer order as the serial loop did, so the floats, and the images,
// stay the twin's.
//
// kSpread false keeps the serial loop, a ray a lane, for the builds with
// the Chebyshev stage: there the spread's registers on top of the
// surrogate's took 136 a thread, one block of 256 a multiprocessor, and a
// mesh mosaic ran 1.29x (mc) and 1.54x (weight) slower than serially
// (chip_ab.py, PERF.md).
template <bool kSpread>
__device__ __forceinline__ void xrt_mosaic(const float* o, const int* oi,
                                           const float* __restrict__ aux,
                                           Draws& draw, float nxv, float nyv,
                                           float nzv, float sin_b, float cos_b,
                                           bool weight, int lane, float& dx,
                                           float& dy, float& dz, bool& mask,
                                           float& wt) {
    constexpr int C = kMosaicChunk;
    const unsigned int all = 0xffffffffu;
    const unsigned int below = (1u << lane) - 1u;
    const int depth = oi[XRT_OI_DEPTH];
    const int first = draw.next;
    if (mask && o[XRT_O_MCUT] >= 0.0f) {
        const float d0 = xrt_bragg_delta(dx * nxv + dy * nyv + dz * nzv, sin_b, cos_b);
        mask = fabsf(d0) < o[XRT_O_MCUT];
    }
    MosaicRay own{draw.ray, dx, dy, dz, nxv, nyv, nzv, {}, {}, sin_b, cos_b};
    if (mask) xrt_mosaic_basis(nxv, nyv, nzv, own.o1, own.o2);
    // The layers' draws, keyed by the ray whose layers a lane evaluates.
    Draws dm{draw.uniforms, draw.n_total, draw.ray, draw.k0, draw.k1, first, -1,
             {0u, 0u, 0u, 0u}};
    if constexpr (!kSpread) {
        if (mask) {
            float surv = 1.0f, cum = 0.0f;
            bool refl = false;
            for (int l = 0; l < depth && !(refl && !weight); ++l) {
                float nmx, nmy, nmz, dotm, u;
                const float prob =
                    xrt_mosaic_layer(o, oi, aux, draw, own, nmx, nmy, nmz, dotm, u);
                const float qv = prob * surv;
                const float cum_new = cum + qv;
                if (weight ? u * cum_new < qv : prob >= u) {
                    const float kk = 2.0f * dotm;
                    dx = own.d0x - kk * nmx;
                    dy = own.d0y - kk * nmy;
                    dz = own.d0z - kk * nmz;
                    refl = true;
                }
                surv = surv * (1.0f - prob);
                cum = cum_new;
            }
            if (weight) {
                wt = wt * cum;
            } else {
                mask = refl;
            }
        }
    } else if (!weight) {
        constexpr int G = kMosaicGroup, T = 32 / G;
        int base = 0;  // this lane's ray: the first layer of its next group
        bool refl = false;
        unsigned int searching = __ballot_sync(all, mask && depth > 0);
        while (searching) {
            // Lane j: chunk j % G of the group of the (j / G)-th searching
            // ray.
            const int task = lane / G;
            const bool has = task < __popc(searching);
            const int src = has ? xrt_nth_bit(searching, task) : lane;
            const MosaicRay m = own.from(src);
            const int l0 = __shfl_sync(all, base, src) + (lane % G) * C;
            bool acc = false;
            float cx = 0.0f, cy = 0.0f, cz = 0.0f;
            if (has) {
                dm.ray = m.ray;
                dm.next = first + 3 * l0;
                dm.group = -1;
                const int l1 = min(l0 + C, depth);
                for (int l = l0; l < l1 && !acc; ++l) {
                    float nmx, nmy, nmz, dotm, u;
                    const float prob =
                        xrt_mosaic_layer(o, oi, aux, dm, m, nmx, nmy, nmz, dotm, u);
                    if (prob >= u) {
                        const float kk = 2.0f * dotm;
                        cx = m.d0x - kk * nmx;
                        cy = m.d0y - kk * nmy;
                        cz = m.d0z - kk * nmz;
                        acc = true;
                    }
                }
            }
            const unsigned int bits = __ballot_sync(all, acc);
            // This lane's ray, if it had lanes this round: its group's first
            // acceptance, or its next group.
            const int rank = __popc(searching & below);
            const bool mine = ((searching >> lane) & 1u) && rank < T;
            const unsigned int group =
                mine ? (bits >> (rank * G)) & (0xffffffffu >> (32 - G)) : 0u;
            const int from = group ? rank * G + __ffs(group) - 1 : lane;
            const float rx = __shfl_sync(all, cx, from);
            const float ry = __shfl_sync(all, cy, from);
            const float rz = __shfl_sync(all, cz, from);
            if (group) {
                dx = rx;
                dy = ry;
                dz = rz;
                refl = true;
            } else if (mine) {
                base += G * C;
            }
            searching = __ballot_sync(all, ((searching >> lane) & 1u) && !refl && base < depth);
        }
        mask = refl;
    } else {
        // The warp's rows, by lane: a chunk's probabilities, pick uniforms
        // and reflected directions.
        __shared__ float s_rows[kMosaicWarps][5][C][32];
        float(*rows)[C][32] = s_rows[threadIdx.x >> 5];
        const unsigned int entering = __ballot_sync(all, mask);
        const int n_in = __popc(entering);
        const int rank = __popc(entering & below);
        const int total = n_in * ((depth + C - 1) / C);
        float surv = 1.0f, cum = 0.0f;
        int next = 0;  // this lane's ray: its next chunk
        for (int s0 = 0; s0 < total; s0 += 32) {
            // Lane j: pair s0 + j, chunk (s0 + j) / n_in of the
            // ((s0 + j) % n_in)-th ray past the cutoff.
            const int s = s0 + lane;
            const bool has = s < total;
            const int q = has ? s / n_in : 0;
            const int src = has ? xrt_nth_bit(entering, s - q * n_in) : lane;
            const MosaicRay m = own.from(src);
            if (has) {
                dm.ray = m.ray;
                dm.next = first + 3 * q * C;
                dm.group = -1;
                const int l1 = min(C, depth - q * C);
                for (int i = 0; i < l1; ++i) {
                    float nmx, nmy, nmz, dotm;
                    rows[0][i][lane] = xrt_mosaic_layer(o, oi, aux, dm, m, nmx, nmy, nmz,
                                                        dotm, rows[1][i][lane]);
                    const float kk = 2.0f * dotm;
                    rows[2][i][lane] = m.d0x - kk * nmx;
                    rows[3][i][lane] = m.d0y - kk * nmy;
                    rows[4][i][lane] = m.d0z - kk * nmz;
                }
            }
            __syncwarp();
            // The owners take this round's chunks of their rays in layer
            // order, at most ceil(pairs / n_in) each; the last layer picked
            // gives the direction.
            if (mask) {
                const int end = min(s0 + 32, total);
                for (int so = next * n_in + rank; so < end; so += n_in, ++next) {
                    const int col = so - s0, l1 = min(C, depth - next * C);
                    for (int i = 0; i < l1; ++i) {
                        const float p = rows[0][i][col];
                        const float qv = p * surv;
                        const float cum_new = cum + qv;
                        if (rows[1][i][col] * cum_new < qv) {
                            dx = rows[2][i][col];
                            dy = rows[3][i][col];
                            dz = rows[4][i][col];
                        }
                        surv = surv * (1.0f - p);
                        cum = cum_new;
                    }
                }
            }
            __syncwarp();
        }
        if (mask) wt = wt * cum;
    }
    draw.next = first + 3 * depth;
    // The spread does not keep the chain's Philox words live across its
    // rounds: its next draw computes them again.
    if constexpr (kSpread) draw.group = -1;
}

// The bilinear splat of a hit at fractional pixel coordinates (fx, fy) on
// an (nx, ny) image (JAX fused_trace.py:1165-1194, the XLA path's
// per-corner bounds drop): the coordinates clipped to [-2, n + 1], the
// tents 1 - |f - i| at the two grid neighbours of each, the corner weight
// (tx w) ty, an atomic a corner, each corner off the grid dropped and each
// term of exactly zero skipped (a pixel starts at +0.0 and every term is
// at least +0.0, so the sum does not move by a bit). The image's pixels
// start at base.
template <class Img>
__device__ __forceinline__ void xrt_splat(const Img& img, int base, float fx, float fy,
                                          int nx, int ny, float w) {
    const float fxc = fminf(fmaxf(fx, -2.0f), (float)nx + 1.0f);
    const float fyc = fminf(fmaxf(fy, -2.0f), (float)ny + 1.0f);
    const float x0 = floorf(fxc), y0 = floorf(fyc);
    for (int a = 0; a < 2; ++a) {
        const float xi = x0 + (float)a;
        if (!(xi >= 0.0f && xi < (float)nx)) continue;
        const float wx = (1.0f - fabsf(fxc - xi)) * w;
        for (int b = 0; b < 2; ++b) {
            const float yi = y0 + (float)b;
            if (!(yi >= 0.0f && yi < (float)ny)) continue;
            const float v = wx * (1.0f - fabsf(fyc - yi));
            if (v != 0.0f) img.add(base + (int)xi * ny + (int)yi, v);
        }
    }
}

// xrt_apertures of a chain's optic, with a path of its own for a single
// aperture (a baffle plate's): no loop, and m_out, starting at m_in, is 1
// wherever the logic is applied, so the result is m_in and the logic's
// truth table at (1, test). With it K1 on baffle127 ran 12 % faster, and
// K1a, whose aperture optic holds two, 4 % slower (chip_ab.py
// `apertures_loop`, PERF.md); K5 keeps xrt_apertures. Folded into
// xrt_apertures, by peeling its first aperture or with both on shared
// helpers, it spilled builds held at their register caps (the marked K1
// builds, K5f's generic-source variant; `apertures_peel`, `apertures_shared`).
__device__ __forceinline__ bool xrt_chain_apertures(const float* apf, const int* api,
                                                    int first, int count, float lxv,
                                                    float lyv, bool m_in) {
    if (count != 1) return xrt_apertures(apf, api, first, count, lxv, lyv, m_in);
    const float ax = lxv - apf[first * XRT_AP_F];
    const float ay = lyv - apf[first * XRT_AP_F + 1];
    const float p0 = apf[first * XRT_AP_F + 2];
    const int shape = api[first * XRT_AP_I];
    bool test;
    if (shape == 1) {
        test = ax * ax + ay * ay < p0;
    } else if (shape == 2) {
        test = fabsf(ax) < p0 && fabsf(ay) < p0;
    } else if (shape == 3) {
        test = fabsf(ax) < p0 && fabsf(ay) < apf[first * XRT_AP_F + 3];
    } else if (shape == 0) {
        test = true;
    } else {
        const float ex = ax / p0, ey = ay / apf[first * XRT_AP_F + 3];
        test = ex * ex + ey * ey < 1.0f;
    }
    const unsigned int logic = min((unsigned int)api[first * XRT_AP_I + 1], 6u);
    return m_in && ((0x9617E48u >> (4u * logic + 2u + test)) & 1u);
}

// Traces a ray from (px, py, pz) along the unit (dx, dy, dz) of wavelength
// wl and weight wt through the chain, adding its reach to the histogram
// s_counts (xrt_count_reach; the caller counts the source,
// xrt_count_source) and its terms to the images. per_ray_wl: the crystals
// take their Bragg angle from wl (the plasma of fused_trace.py:997-1001,
// and generic sources whose wavelength varies), else the constant sin/cos
// packed in the optic.
//
// kCheb compiles the stage of mesh surrogates (Chebyshev surfaces, shape 4);
// the host takes this build only for chains that hold one
// (FusedParams.cheb): with it, K1a's build took 72 registers, not 71, and
// 3-5 % more time (chip_ab.py, PERF.md). kStages compiles, from 1, weight
// mode and bilinear images (header ints XRT_H_WEIGHT and XRT_H_BILINEAR)
// and, at 2, mosaic crystals (interact code 3); the host takes the least
// build a run needs (FusedParams.stages), so mc chains with nearest images
// keep a build without either, and weight or bilinear runs one without the
// mosaic's registers (chip_ab.py, PERF.md). File rocking curves (rocking
// code 2, the table read from aux) and mirrors (interact code 2: d' = d -
// 2 (d.n) n, no draw) are in every build.
//
// kShapes, a set of XRT_SHAPES_TORUS and XRT_SHAPES_CYLINDER, compiles
// those curved shapes beside the plane and the sphere (FusedParams.shapes):
// 0 for chains of planes and spheres, XRT_SHAPES_CYLINDER for those with
// cylinders and no torus, so neither compiles xrt_torus_hit or
// xrt_torus_normal; a build with the Chebyshev stage takes every shape.
//
// In the builds without the mosaic or the Chebyshev stage (kStages 0 and
// 1), in mc mode, a warp with no live lane leaves the chain before an
// element (a warp-uniform __any_sync): every later element would find its
// rays dead, add nothing to the counts or the images and draw for no live
// ray, and a ray's draws are keyed by (ray, draw index), so no live ray's
// draws move. The flagship's detector finds 66 % of its warps dead (1.3 %
// of the rays alive) with nearest or bilinear images, and the plasma's
// torus chain most of its own. Where weight mode keeps the rays alive
// (the header int, uniform over the launch), or the Chebyshev and mosaic
// loops dominate, the vote cost more than it saved (chip_ab.py
// `skip_all_builds`, PERF.md), so those run every element. The record hook
// (K1e) takes every element's state, so with it the warp runs the whole
// chain.
//
// Images: img.add(pixel, term) (XrtImage). A term of exactly
// zero issues no atomic (weight mode's rays whose rocking curve underflows
// to 0 stay alive, and on the flagship they are 82 % of the detector's
// adds; the sums do not move by a bit).
//
// Returns whether the ray is alive after the last element. rec, where its
// kOn is set, takes each element's state (1 + e, position, direction,
// alive, weight) in place of the counts and the images.
template <bool kCheb, int kStages, class Rec = XrtNoRecord, int kShapes = XRT_SHAPES_ALL,
          class Img>
__device__ __forceinline__ bool xrt_trace_chain(
    const float* fp, const int* ip, const float* __restrict__ aux, Draws& draw,
    float px, float py, float pz, float dx, float dy, float dz, float wl,
    bool per_ray_wl, bool alive, float wt, unsigned int* s_counts, const Img& img,
    int lane, Rec rec = Rec()) {
    static_assert(kShapes == XRT_SHAPES_ALL || !kCheb, "the Chebyshev builds take every shape");
    constexpr bool kSkip = !Rec::kOn && !kCheb && kStages <= 1;
    const int n_opt = ip[0];
    const float* apf = fp + XRT_SRC_F + n_opt * XRT_OPT_F;
    const int* api = ip + XRT_HDR_I + n_opt * XRT_OPT_I;
    const bool weight = kStages >= 1 && ip[XRT_H_WEIGHT] != 0;
    const bool bilinear = kStages >= 1 && ip[XRT_H_BILINEAR] != 0;
    const bool vote = kSkip && !weight;
    int reach = 0;  // the elements the ray leaves alive
    for (int e = 0; e < n_opt; ++e) {
        if (vote && !__any_sync(0xffffffffu, alive)) break;
        const float* o = fp + XRT_SRC_F + e * XRT_OPT_F;
        const int* oi = ip + XRT_HDR_I + e * XRT_OPT_I;
        float t, nxv, nyv, nzv;
        bool m_int;
        if (oi[0] == 0) {  // plane through o[0:3], normal bz
            float denom;
            bool nz;
            t = xrt_plane_hit(o[0], o[1], o[2], o[9], o[10], o[11], px, py,
                              pz, dx, dy, dz, &denom, &nz);
            m_int = alive && t >= 0.0f && nz;
            nxv = o[9];
            nyv = o[10];
            nzv = o[11];
        } else if (kShapes == 0 || oi[0] == 1) {  // sphere of center o[12:15], radius^2 o[15]
            const SphereHit h = xrt_sphere_hit(o[12], o[13], o[14], o[15],
                                               0.0f, oi[1] != 0, px, py,
                                               pz, dx, dy, dz);
            m_int = alive && h.d2 <= o[15];
            t = h.t;
            nxv = nyv = nzv = 0.0f;
        } else if ((kShapes & XRT_SHAPES_TORUS) && oi[0] == 2) {  // torus
            t = xrt_torus_hit(o, px, py, pz, dx, dy, dz, alive, &m_int);
            nxv = nyv = nzv = 0.0f;
        } else if (kCheb && oi[0] == XRT_SHAPE_CHEB) {  // unit normal given
            t = xrt_cheb_hit(o, reinterpret_cast<const float4*>(aux + oi[XRT_OI_DENSE]),
                             oi[XRT_OI_DEG], px, py, pz, dx, dy, dz, alive, &m_int,
                             nxv, nyv, nzv);
        } else {  // cylinder of axis bx through o[12:15], radius^2 o[15]
            const CylinderHit h = xrt_cylinder_hit(
                o[12], o[13], o[14], o[3], o[4], o[5], o[15],
                oi[1] != 0, px, py, pz, dx, dy, dz);
            m_int = alive && h.disc >= 0.0f;
            t = m_int ? h.t : 0.0f;
            nxv = nyv = nzv = 0.0f;
        }
        const float qx = m_int ? px + t * dx : px;
        const float qy = m_int ? py + t * dy : py;
        const float qz = m_int ? pz + t * dz : pz;
        if (oi[0] != 0 && !(kCheb && oi[0] == XRT_SHAPE_CHEB)) {
            // sphere, cylinder: towards the center or the axis; torus:
            // outward
            if (kShapes == 0 || oi[0] == 1) {
                nxv = o[12] - qx;
                nyv = o[13] - qy;
                nzv = o[14] - qz;
            } else if ((kShapes & XRT_SHAPES_TORUS) && oi[0] == 2) {
                xrt_torus_normal(o, qx, qy, qz, nxv, nyv, nzv);
            } else {
                const float tcx = o[12] - qx, tcy = o[13] - qy, tcz = o[14] - qz;
                const float along = tcx * o[3] + tcy * o[4] + tcz * o[5];
                nxv = tcx - along * o[3];
                nyv = tcy - along * o[4];
                nzv = tcz - along * o[5];
            }
            const float inv =
                inv_sqrt(fmaxf(nxv * nxv + nyv * nyv + nzv * nzv, 1e-30f));
            nxv = nxv * inv;
            nyv = nyv * inv;
            nzv = nzv * inv;
        }
        const float rx = qx - o[0], ry = qy - o[1], rz = qz - o[2];
        const float lxv = rx * o[3] + ry * o[4] + rz * o[5];
        const float lyv = rx * o[6] + ry * o[7] + rz * o[8];

        const bool m_in = xrt_bounds(m_int, oi[4], o + 16, lxv, lyv, rx,
                                     ry, rz, o[9], o[10], o[11]);
        bool mask = xrt_chain_apertures(apf, api, oi[6], oi[5], lxv, lyv, m_in);

        const bool mosaic = kStages >= 2 && oi[2] == XRT_INTERACT_MOSAIC;
        if (oi[2] == 1 || mosaic) {  // Bragg crystal or mosaic
            float sin_b = o[21], cos_b = o[22];
            if (per_ray_wl) {  // per-ray Bragg angle (fused_trace.py:997-1001)
                sin_b = fminf(fmaxf(wl * o[XRT_O_INV2D], 0.0f), 1.0f);
                cos_b = sqrtf(fmaxf(1.0f - sin_b * sin_b, 0.0f));
            }
            if (mosaic) {
                xrt_mosaic<!kCheb>(o, oi, aux, draw, nxv, nyv, nzv, sin_b, cos_b, weight,
                                   lane, dx, dy, dz, mask, wt);
            } else {
                const float dot = dx * nxv + dy * nyv + dz * nzv;
                const float prob =
                    xrt_rock_prob(o, oi, aux, xrt_bragg_delta(dot, sin_b, cos_b));
                if (weight) {  // no draw (fused_trace.py:1007-1008)
                    if (mask) wt = wt * prob;
                } else {  // Bernoulli acceptance
                    const float uacc = draw();
                    mask = mask && prob >= uacc;
                }
                if (mask) {
                    const float kk = 2.0f * dot;
                    dx = dx - kk * nxv;
                    dy = dy - kk * nyv;
                    dz = dz - kk * nzv;
                }
            }
        } else if (oi[2] == 2 && mask) {  // mirror
            const float kk = 2.0f * (dx * nxv + dy * nyv + dz * nzv);
            dx = dx - kk * nxv;
            dy = dy - kk * nyv;
            dz = dz - kk * nzv;
        }
        px = qx;
        py = qy;
        pz = qz;
        alive = mask;
        if constexpr (Rec::kOn) {
            rec(1 + e, px, py, pz, dx, dy, dz, alive, wt);
            continue;
        }
        reach += alive;

        // A ray of weight zero adds terms of zero alone.
        if (oi[7] >= 0 && alive && (kStages == 0 || wt != 0.0f)) {
            const float fx = fmaf(lxv, o[23], o[24]);
            const float fy = fmaf(lyv, o[23], o[25]);
            if (bilinear) {
                xrt_splat(img, oi[7], fx, fy, oi[8], oi[9], wt);
            } else {
                int flat;
                if (xrt_nearest_pixel(fx, fy, oi[8], oi[9], &flat)) {
                    img.add(oi[7] + flat, kStages >= 1 ? wt : 1.0f);
                }
            }
        }
    }
    if constexpr (!Rec::kOn) xrt_count_reach(s_counts, reach, lane);
    return alive;
}
