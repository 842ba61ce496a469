// The batched RTS mean pass (K10) as the package builds it, with the cycle
// stamps of probes/stamps.cuh filled in (the source marks its parts;
// probes/rts_mean.py names them). Built by probes/rts_mean.py into its own
// library, beside the package's.

#include "stamps.cuh"

#include "../numpower_tpu_torch/csrc/rts_mean.cu"
