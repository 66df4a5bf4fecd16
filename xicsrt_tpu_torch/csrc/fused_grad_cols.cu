// K5b (fused_grad.cu) in its builds whose per-thread rows live in device
// memory, one a variant (fused_grad_bwd_kernel<..., true>), for chains
// whose rows do not fit in shared memory beside a resident block
// (bwd_layout). A file of its own, so nvcc compiles these 24 kernels in a
// process of its own beside fused_grad.cu's 48, and the build takes no
// longer for them; fused_grad.cu's launchers take them from this table.
#define XRT_GRAD_COLS_TU
#include "fused_grad.cu"

const BwdKernel xrt_grad_bwd_global[XRT_GRAD_VARIANTS] = XRT_GRAD_KERNELS(kBwdGlobal);
