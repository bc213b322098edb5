// The flash forward of flash_fwd.cu, built with the d <= 40 class (UNet
// ds1) at every (BQ, BK, stages) of the tile sweep instead of the fixed
// table's configurations; its C entry is flash_fwd_bf16, as there.  Only
// gligen_tpu_torch/tools/bench_sweep_attn.py calls it; it is a library of
// its own so that the serving library builds without the sweep's eight
// instantiations.
#define FLASH_FWD_SWEEP
#include "flash_fwd.cu"
