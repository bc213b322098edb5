// The flash backward of flash_bwd.cu, its fp32 route (the 3xTF32 kernels
// flash_bwd_dq_tf32_kernel and flash_bwd_dkv_tf32_kernel, every head-dim
// class) built at every (fixed rows, tile rows) of the fp32 tile sweep
// instead of the fixed table's; its C entries are flash_bwd_dq_f32 and
// flash_bwd_dkv_f32, as there.  Only
// gligen_tpu_torch/tools/bench_sweep_attn.py --bwd --fp32 calls it; it is a
// library of its own so that the serving library builds without the
// sweep's instantiations.
#define FLASH_BWD_F32_SWEEP
#include "flash_bwd.cu"
