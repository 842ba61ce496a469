// The batched SPD solve (K6b) and the systematic resample (K14) as the
// package builds them, with the cycle stamps of probes/stamps.cuh filled in
// (the sources mark their parts; probes/psd_resample.py names them). Built
// by probes/psd_resample.py into its own library, beside the package's.

#include "stamps.cuh"

#include "../numpower_tpu_torch/csrc/cholesky.cu"
#include "../numpower_tpu_torch/csrc/pf_resample.cu"
