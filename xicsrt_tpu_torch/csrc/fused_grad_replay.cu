// K5b (fused_grad.cu) in its replay builds, one a variant
// (fused_grad_replay_kernel: each optic replayed from its saved entry
// state), for the chains the launcher gives them (bwd_layout). A file of
// its own, so nvcc compiles these 24 kernels in a process of its own beside
// fused_grad.cu's 48, and the build takes no longer for them;
// fused_grad.cu's launchers take them from this table.
#define XRT_GRAD_REPLAY_TU
#include "fused_grad.cu"

const BwdKernel xrt_grad_bwd_replay[XRT_GRAD_VARIANTS] = XRT_GRAD_KERNELS(kBwdReplay);
