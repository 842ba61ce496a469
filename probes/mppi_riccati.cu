// The fused MPPI (K13) and the fused per-scenario Riccati (K5) as the
// package builds them, with the cycle stamps of probes/stamps.cuh filled in
// (the sources mark their parts; probes/mppi_riccati.py names them). Built
// by probes/mppi_riccati.py into its own library, beside the package's.

#include "stamps.cuh"

#include "../numpower_tpu_torch/csrc/mppi.cu"
#include "../numpower_tpu_torch/csrc/riccati.cu"
