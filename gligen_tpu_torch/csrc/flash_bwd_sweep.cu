// The flash backward of flash_bwd.cu, built at the tile sweep's
// configurations of every head-dim class instead of the fixed table's; its
// C entries are flash_bwd_dq_bf16 and flash_bwd_dkv_bf16, as there.  Only
// gligen_tpu_torch/tools/bench_sweep_attn.py --bwd calls it; it is a library
// of its own so that the serving library builds without the sweep's
// instantiations.
#define FLASH_BWD_SWEEP
#include "flash_bwd.cu"
