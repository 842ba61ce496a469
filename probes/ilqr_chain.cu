// The iLQR kernels K7 and K8 as the package builds them, with the cycle
// stamps of probes/stamps.cuh filled in (the sources mark their parts;
// probes/ilqr_chain.py names them). Built by probes/ilqr_chain.py into its
// own library, beside the package's.

#include "stamps.cuh"

#include "../numpower_tpu_torch/csrc/ilqr_backward.cu"
#include "../numpower_tpu_torch/csrc/ilqr_backward_wide.cu"
#include "../numpower_tpu_torch/csrc/ilqr_forward.cu"
