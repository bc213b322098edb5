// The fused projections of fused_proj.cu, built at the tile sweep's
// configurations of every mode instead of the fixed table's; its C entries
// are those of fused_proj.cu.  Only gligen_tpu_torch/tools/bench_proj.py
// --sweep calls it; it is a library of its own so that the serving library
// builds without the sweep's instantiations.
#define FUSED_PROJ_SWEEP
#include "fused_proj.cu"
