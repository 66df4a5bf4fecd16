// Fused generate -> trace -> count -> image kernel for NVIDIA Hopper
// (sm_90a): K1a (the main spectrometer chain), K1b (the generic source
// matrix), K1f (the plasma source), the torus, cylinder, Chebyshev-mesh
// (K1c-cheb), file rocking (K1c-file), mirror (K1c-mirror) and mosaic
// (K1c-mosaic) stages of K1c, and weight mode with bilinear images (K1d).
//
// Replaces those cuts of the TPU megakernel
// xicsrt_tpu/ops/fused_trace.py::build_fused_run (kernel, with the generic
// sampler at :1538-1713, the plasma sampler at :1428-1537, and the shared
// optic chain _trace_chain with torus_local_quadratic_t at :616 and the
// cylinder at :784 and :903). One thread carries one ray in registers from
// the source through every optic; no per-ray state touches device memory.
//
// The subset: a generic source (point, uniform or gaussian box; isotropic,
// isotropic_xy, flat, flat_xy or gaussian cone; a constant axis or a
// Focused one; one wavelength, a uniform band or an exact Voigt line; bulk
// Doppler; sightline filters tested on the origin, xrt_sample_source), or a
// plasma whose per-iteration bundle tables
// (cum, table) were drawn before the launch; plane, sphere, torus or
// cylinder optics, and Chebyshev surrogates of smooth meshes, with x/y/z
// bounds and aperture logic (none/circle/square/rectangle/ellipse; and,
// not, or, nand, nor, xor, xnor); no interaction, a mirror, a Bragg
// crystal with a gaussian, step or tabulated (file) rocking curve, or a
// mosaic crystal of run-time depth, at each ray's own wavelength where the
// source varies it; Bernoulli (mc) acceptance, or weight mode, where each
// ray carries a weight in a register from 1 (fused_trace.py:1719);
// per-element counts of the rays alive; nearest-pixel or bilinear images of
// the weights. The chain is trace_chain.cuh, shared with the trace-only
// kernel K3 (trace_only.cu); the kernel and its launcher are fused_run.cuh,
// shared with the history builds of fused_history.cu (K1e).
//
// Plasma: iteration j holds rays [j n, (j + 1) n) of the budget n; ray
// j n + l is alive iff l < cum_j[B-1], finds its bundle by its warp's
// 32-ary search over cum_j (xrt_warp_bundle, bundle_lookup.cuh) and loads
// its row. Each source kind has builds of its own (kSrc, fused_run.cuh):
// the point-source cut, the whole generic sampler, the plasma. The TPU kernel's
// interval one-hot on the MXU, its 256-bundle windows, its page windows
// beyond 4096 bundles, the compaction sort that bounds them and its 4096-ray
// chunk cap all served VMEM; they have no counterpart here.
//
// Geometry and structure arrive at run time in two small buffers (float32
// and int32) packed by xicsrt_tpu_torch/ops/fused_trace.py, so one build
// serves every configuration of the subset; their layout is defined there
// (pack_params) and mirrored by the offsets of trace_common.cuh, which also
// holds the sampler, intersections and aperture logic shared with the
// gradient kernels (fused_grad.cu).
//
// Random numbers: either an explicit (n_draws, n_total) float32 tensor, or
// counter-based Philox4x32-10 keyed by (seed, ray index, draw index), so a
// ray's draws do not depend on the launch configuration. Draw order per
// ray: the source's (generic: one per nonzero box size, the cone's two, 0-2
// for the wavelength; plasma: 3 voxel offsets, u, v, the normal's uniform,
// the Cauchy uniform), then one uniform per crystal in mc mode and three
// per layer of a mosaic crystal.
//
// Numerics follow the TPU kernel and the plain PyTorch twin operation by
// operation: the Bragg deviation is the sine-difference identity with a
// cubic asin correction (fused_trace.py:995-1002), pixels are
// fmaf(lxv, 1/ps, (nx-1)/2) rounded half to even (fused_trace.py:1115-1124
// as XLA evaluates it). The library is built with -fmad=false so that no
// other a*b+c is contracted into an FMA the twin does not make; 1/sqrtf
// replaces rsqrtf for the same reason.
//
// What bounds it: arithmetic and the per-ray sin/exp/sqrt (plasma: also
// cos, tan, erfinv and the torus's 4 Newton steps with a sqrt and two
// divisions each; a mesh: 4 Newton steps over its dense Chebyshev
// coefficients, unrolled to the degree so the T rows stay in registers,
// one 16-byte load of (C, Cx, Cy) a term through the read-only cache where
// the TPU kernel unrolled its nonzero terms as constants), plus the image
// atomics; a file curve
// is two cached loads where the TPU kernel ran a tent matvec on its MXU; a plasma's warp adds
// ceil(log2(B) / 5) rounds of 32 loads of cum, a window of 32 entries and
// one 32-byte row a ray, served by L1 and L2; a
// mosaic crystal two erfinvf, a sqrt and a rocking curve per layer. Counts
// are reduced per warp with __ballot_sync/__popc into
// shared counters. Nearest mc images are block-private shared-memory
// histograms (binning.cuh) where staging them costs no resident block,
// else global atomics; weighted and bilinear images are float64 sums in
// global memory, rounded to float32 by the launcher (xrt_fused_pick,
// fused_run.cuh); a bilinear hit takes an atomic a corner where the TPU
// kernel contracted tent matrices on its MXU, and a term of exactly zero
// none. In mc runs of the builds without the mosaic or Chebyshev stages a
// warp leaves the chain once its lanes are dead (trace_chain.cuh); the
// flagship's chain of planes and spheres takes a build without the torus
// and cylinder code, held to 5 blocks of 256 (4 with the weight and
// bilinear stages; fused_trace_flat_kernel), a chain with cylinders and no
// torus one without the torus code (fused_trace_cylinder_kernel), and the
// mirror chains, whose rays reach an image unthinned by a Bragg check, one
// of planes and spheres at 5 blocks (fused_trace_dense_kernel;
// xrt_fused_build). Where a chain focuses onto a few pixels, global
// atomics from every warp wait on the same addresses, so those builds
// stage one image (the window) as integer counts in shared memory where
// the whole does not fit beside 5 blocks (XrtWindowImage).
#include "fused_run.cuh"

// fp/ip: packed parameters (n_fp floats, n_ip ints) on the device. Rays
// [0, n_total) are traced. A point source's rays at index >= count are dead
// at the source (a Poisson budget's realised count). A plasma's
// per-iteration tables: cum (n_total / n_per_iter, n_bundles) int32 and
// table (n_total / n_per_iter, n_bundles, 8) float32, 16-byte aligned
// (null and 0 for a point source). uniforms: (n_draws, n_total) float32 or
// null for Philox keyed by (seed0, seed1). counts: (1 + n_optics) uint64
// and images: (img_total,) float32 at stages 0, float64 at stages 1 and 2
// (the launcher rounds them to float32), both zeroed by the caller.
// full_source:
// the generic source's whole sampler (a box, a Focused axis, the other cones,
// per-ray wavelengths or filters), else its point-source cut; a plasma
// (cum not null) takes the plasma's builds. aux: n_aux
// float32 of file tables and Chebyshev terms (never null); cheb: the
// chain's mesh stage; stages: 0, or 1 for its weight and bilinear stages,
// 2 with the mosaic's too; shapes: the chain's curved shapes
// (XRT_SHAPES_TORUS 1, XRT_SHAPES_CYLINDER 2: a point source at stages 0
// or 1 without the Chebyshev stage and with no torus takes a build without
// the torus code); dense: a chain of planes and spheres whose rays reach
// an image unthinned takes fused_trace_dense_kernel (stages 0;
// FusedParams.dense_images); win_lo, win_hi: the image pixels the window
// builds stage where staging every pixel costs a resident block
// (FusedParams.stage_window; xrt_fused_pick). Returns cudaGetLastError()
// of the launch.
extern "C" int xrt_fused_trace(const float* fp, int n_fp, const int* ip,
                               int n_ip, const float* aux, int n_aux,
                               long long n_total, long long count,
                               const float* uniforms, unsigned int seed0,
                               unsigned int seed1, const int* cum,
                               const float* table, int n_bundles,
                               long long n_per_iter, unsigned long long* counts,
                               void* images, int img_total, int full_source,
                               int cheb, int stages, int shapes, int dense,
                               int win_lo, int win_hi, void* stream) {
    return xrt_fused_launch<false>(fp, n_fp, ip, n_ip, aux, n_aux, n_total, count,
                                   uniforms, seed0, seed1, cum, table, n_bundles,
                                   n_per_iter, counts, images, img_total, full_source,
                                   cheb, stages, shapes, dense, win_lo, win_hi, nullptr, 0,
                                   stream);
}

// The build xrt_fused_trace takes (src: 0 point, 1 generic, 2 plasma; the
// other arguments its own), as its index in xrt_fused_pick's table: 6 src
// + 3 cheb + stages for fused_trace_kernel, 18 + stages for
// fused_trace_flat_kernel, 20 + stages for fused_trace_cylinder_kernel,
// 22 for fused_trace_dense_kernel.
extern "C" int xrt_fused_trace_build(int src, int cheb, int stages, int shapes, int dense) {
    return xrt_fused_build(src, cheb, stages, shapes, dense);
}

// The threads of a block of the build xrt_fused_trace launches (src: 0
// point, 1 generic, 2 plasma; cheb and stages its own): 256, or 128 for the
// point source's Chebyshev build of the weight and bilinear stages.
extern "C" int xrt_fused_trace_threads(int src, int cheb, int stages) {
    return xrt_fused_threads(src, cheb, stages);
}

// Blocks of 256 a multiprocessor holds of the build of K1 that
// xrt_fused_trace launches (src: 0 point, 1 generic, 2 plasma; the other
// arguments its own, n_fp and n_ip the packed buffers' lengths), by
// registers and the launch's shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor as the launcher calls it),
// and its dynamic shared bytes, the head's included, in *dyn_smem; -1
// where the query fails.
extern "C" int xrt_fused_trace_occupancy(int src, int cheb, int stages, int shapes,
                                         int dense, int win_lo, int win_hi, int img_total,
                                         int n_fp, int n_ip, int* dyn_smem) {
    return xrt_fused_occupancy<false>(src, cheb, stages, shapes, dense, win_lo, win_hi,
                                      img_total, n_fp, n_ip, dyn_smem);
}

// The floats of the head of the trace kernels' dynamic shared memory
// (xrt_head_floats, trace_common.cuh) for packed buffers of n_fp floats
// and n_ip ints.
extern "C" int xrt_head_floats_of(int n_fp, int n_ip) {
    return xrt_head_floats(n_fp, n_ip);
}
