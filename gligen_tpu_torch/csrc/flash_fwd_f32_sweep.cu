// The flash forward of flash_fwd.cu, its fp32 route's d <= 40 and d <= 80
// classes (flash_fwd_f32_qm_kernel, UNet ds1 and ds2) built at every
// (BQ, BK, buffers) of the fp32 tile sweep instead of the fixed table's
// configurations; its C entry is flash_fwd_f32, as there.  Only
// gligen_tpu_torch/tools/bench_sweep_attn.py --fp32 calls it; it is a
// library of its own so that the serving library builds without the
// sweep's ten instantiations.
#define FLASH_FWD_F32_SWEEP
#include "flash_fwd.cu"
