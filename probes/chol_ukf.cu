// The batched Cholesky (K6a) and the fused batched UKF (K12) as the package
// builds them, with the cycle stamps of probes/stamps.cuh filled in (the
// sources mark their parts; probes/chol_ukf.py names them). Built by
// probes/chol_ukf.py into its own library, beside the package's.

#include "stamps.cuh"

#include "../numpower_tpu_torch/csrc/cholesky.cu"
#include "../numpower_tpu_torch/csrc/ukf.cu"
