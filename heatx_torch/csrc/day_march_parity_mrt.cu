// The parity day march's kMrt kinds (interior MRT and the per-hour h/q and
// operative histories; day_march_parity.cu has the kernel), compiled as a
// unit of their own so that the other kinds keep their code: ptxas shares
// out-of-line device functions among the kernels of one unit.
// day_march_parity.cu launches them through heatx_day_march_parity_mrt_f32/_f64.
#define HEATX_DAY_MARCH_PARITY_KMRT_UNIT
#include "day_march_parity.cu"
