// The fused conv of fused_conv.cu, built at the tile sweep's configurations
// instead of the fixed table's; its C entry is fused_conv.cu's.  Only
// gligen_tpu_torch/tools/perf_probe.py convs --sweep calls it; it is a
// library of its own so that the serving library builds without the sweep's
// instantiations.
#define FUSED_CONV_SWEEP
#include "fused_conv.cu"
