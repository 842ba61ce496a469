// The fused batched EKF (K11) and the batched Kalman mean pass (K9) as the
// package builds them, with the cycle stamps of probes/stamps.cuh filled in
// (the sources mark their parts; probes/ekf_kalman.py names them). Built by
// probes/ekf_kalman.py into its own library, beside the package's.

#include "stamps.cuh"

#include "../numpower_tpu_torch/csrc/ekf.cu"
#include "../numpower_tpu_torch/csrc/kalman_mean.cu"
